"""Arithmetic shared by the kernels' plain PyTorch versions, in the CUDA
kernels' op order, so that a plain version and its kernel (built with
``--fmad=false``, no FTZ) agree bit-for-bit."""

from __future__ import annotations

import torch

from atray_tpu_torch.core.intersect import T_MIN


def inv_dir(d: torch.Tensor) -> torch.Tensor:
    """1/d, 1e30 for a zero component (the kernels' ``inv_dir``)."""
    zero = d == 0.0
    return torch.where(zero, 1.0e30, 1.0 / torch.where(zero, 1.0, d))


def record_hit(rox, roy, roz, rdx, rdy, rdz, rec: torch.Tensor):
    """One-sided Möller–Trumbore (det > 1e-12) of rays against leaf records
    whose last axis holds p0 at 0:3, e1 at 3:6 and e2 at 6:9; the ray
    components broadcast against ``rec[..., 0]``. Returns (u, v, t, hit);
    ``hit`` leaves out the caller's t < best_t."""
    e1x, e1y, e1z = rec[..., 3], rec[..., 4], rec[..., 5]
    e2x, e2y, e2z = rec[..., 6], rec[..., 7], rec[..., 8]
    pvx = rdy * e2z - rdz * e2y
    pvy = rdz * e2x - rdx * e2z
    pvz = rdx * e2y - rdy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    valid = det > 1.0e-12
    inv_det = torch.where(valid, 1.0 / torch.where(valid, det, 1.0), 0.0)
    tvx = rox - rec[..., 0]
    tvy = roy - rec[..., 1]
    tvz = roz - rec[..., 2]
    uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    vv = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det
    tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = valid & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > T_MIN)
    return uu, vv, tt, hit
