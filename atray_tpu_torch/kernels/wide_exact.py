"""Nearest triangle hit over an unshaded ``WideBVH``
(``atray_tpu/kernels/wide_exact.py`` and ``wide_exact2.py``).

``wide_exact_first_hit(accel, orig, dirn)`` takes (R, 3) float32 origins
and directions and returns ``(t, u, v, fid)``: distance, barycentrics and
int32 face id of the nearest hit, ``(INF, 0, 0, -1)`` on a miss. The
reference has two kernels for it, ``wide_exact`` for primaries and the
two-block interleaved ``wide_exact2`` for bounces; they differ only in how
they hide TPU syncs, so ``wide_exact2_first_hit`` is the same function
here and ``WideBVH`` carries no variant field.

On a CUDA tensor the wrapper launches ``csrc/wide_exact.cu`` (one thread
per ray, its own stack); on a CPU tensor it runs ``wide_exact_ref``, the
plain PyTorch version of the same walk: same tables, same slab and
Möller–Trumbore op order, same per-ray visit order, so the two agree
bit-for-bit where the device's arithmetic is IEEE (the kernel is built
with ``--fmad=false``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from atray_tpu_torch.accel.pack import TRI_STRIDE, TRIS_PER_ROW
from atray_tpu_torch.accel.wide import WideBVH
from atray_tpu_torch.core.intersect import INF, T_MIN
from atray_tpu_torch.kernels import _build

STACK_CAP = 128     # per-thread stack entries; ATRAY_EXACT_STACK_CAP in the .cu
COUNTER = _build.COUNTERS["wide_exact"]
_EMPTY_GUARD = -2147483647   # links <= this are empty slots (INT32_MIN)

Hits = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _check(accel: WideBVH, orig: torch.Tensor, dirn: torch.Tensor) -> torch.device:
    dev = orig.device
    for name, x in (("orig", orig), ("dirn", dirn)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3 or x.device != dev:
            raise TypeError(f"{name} must be an (R, 3) float32 tensor on one device")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if orig.shape != dirn.shape:
        raise TypeError("orig and dirn must have one shape")
    if dev.type not in ("cpu", "cuda"):
        raise TypeError(f"no wide_exact kernel for device {dev}")
    tabs = {"cboxes": (accel.cboxes, torch.float32), "clinks": (accel.clinks, torch.int32),
            "tris": (accel.tris, torch.float32)}
    for name, (tab, dtype) in tabs.items():
        if not isinstance(tab, torch.Tensor) or tab.device != dev or tab.dtype != dtype:
            raise TypeError(f"accel.{name} must be a {dtype} tensor on {dev}: "
                            "call WideBVH.to(device)")
        if not tab.is_contiguous():
            raise ValueError(f"accel.{name} must be contiguous")
    w = accel.num_nodes
    if accel.cboxes.shape != (w, 128) or accel.clinks.shape != (8, w):
        raise ValueError("accel node tables do not match num_nodes")
    if accel.tris.dim() != 2 or accel.tris.shape[1] != 128:
        raise ValueError("accel.tris must be (rows, 128)")
    if accel.leaf_size > TRIS_PER_ROW and accel.leaf_size % TRIS_PER_ROW:
        raise ValueError("leaf_size must be <= 8 or a multiple of 8")
    if 8 * (accel.max_depth + 2) > STACK_CAP:
        raise ValueError(
            f"wide depth {accel.max_depth} needs a stack of "
            f"{8 * (accel.max_depth + 2)} > STACK_CAP {STACK_CAP}")
    return dev


def wide_exact_first_hit(accel: WideBVH, orig: torch.Tensor, dirn: torch.Tensor) -> Hits:
    """Nearest hit per ray; see the module docstring."""
    dev = _check(accel, orig, dirn)
    if dev.type == "cpu":
        return wide_exact_ref(accel, orig, dirn)
    lib = _build.load()
    if lib.atray_wide_exact_stack_cap() != STACK_CAP:
        raise RuntimeError("STACK_CAP disagrees with the compiled kernel")
    n = orig.shape[0]
    t, u, v = (torch.empty(n, dtype=torch.float32, device=dev) for _ in range(3))
    fid = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.atray_wide_exact(
            orig.data_ptr(), dirn.data_ptr(), n,
            accel.cboxes.data_ptr(), accel.clinks.data_ptr(), accel.num_nodes,
            accel.tris.data_ptr(), accel.leaf_size,
            t.data_ptr(), u.data_ptr(), v.data_ptr(), fid.data_ptr(), stream)
    COUNTER.launches += 1
    _build.check(rc, "wide_exact")
    return t, u, v, fid


# the reference's interleaved twin: the same function (see the module docstring)
wide_exact2_first_hit = wide_exact_first_hit


def _inv_dir(d):
    zero = d == 0.0
    return torch.where(zero, 1.0e30, 1.0 / torch.where(zero, 1.0, d))


def wide_exact_ref(accel: WideBVH, orig: torch.Tensor, dirn: torch.Tensor,
                   visits: Optional[dict] = None) -> Hits:
    """Plain PyTorch version of the kernel: a vectorized walk in which every
    ray keeps its own stack. Each iteration pops one node for every ray
    whose stack is not empty, tests its 8 child boxes against the ray's
    best_t, then for c = 0..7 pushes interior children and tests leaves
    (all records of a leaf at once per ray; the first minimal t wins, as in
    the kernel's sequential strict-< loop). With a ``visits`` dict it adds
    the node pops and leaf records tested ("nodes", "records"), the work
    this input needs."""
    COUNTER.plain_calls += 1
    dev = orig.device
    n = orig.shape[0]
    f32, i32 = torch.float32, torch.int32
    o, d = orig, dirn
    inv = _inv_dir(d)
    best_t = torch.full((n,), INF, dtype=f32, device=dev)
    best_u = torch.zeros((n,), dtype=f32, device=dev)
    best_v = torch.zeros((n,), dtype=f32, device=dev)
    best_id = torch.full((n,), -1, dtype=i32, device=dev)
    stack = torch.zeros((n, STACK_CAP), dtype=torch.int64, device=dev)
    sp = torch.ones((n,), dtype=torch.int64, device=dev)   # root 0 pushed

    w = accel.num_nodes
    lo = accel.cboxes[:, 0:24].reshape(w, 3, 8)
    hi = accel.cboxes[:, 24:48].reshape(w, 3, 8)
    links_t = accel.clinks.t().long()                # (W, 8)
    recs = accel.tris.reshape(-1, TRI_STRIDE)
    recs_i = recs.view(i32)
    ks = torch.arange(accel.leaf_size, device=dev)
    counts = {"nodes": 0, "records": 0}

    def leaf_test(rows, leaf_row):
        ridx = leaf_row[:, None] * TRIS_PER_ROW + ks[None, :]     # (j, L)
        rec = recs[ridx]                                           # (j, L, 16)
        counts["records"] += ridx.numel()
        oc = o[rows]
        dc = d[rows]
        rox, roy, roz = oc[:, 0:1], oc[:, 1:2], oc[:, 2:3]
        rdx, rdy, rdz = dc[:, 0:1], dc[:, 1:2], dc[:, 2:3]
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
        hit = (valid & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0)
               & (tt > T_MIN) & (tt < best_t[rows][:, None]))
        k = torch.argmin(torch.where(hit, tt, float("inf")), dim=1)   # first min
        won = hit.any(dim=1)
        rw = rows[won]
        sel = (won.nonzero().squeeze(1), k[won])
        best_t[rw] = tt[sel]
        best_u[rw] = uu[sel]
        best_v[rw] = vv[sel]
        best_id[rw] = recs_i[ridx[sel]][:, 9]

    while True:
        cur = torch.nonzero(sp > 0).squeeze(1)
        if cur.numel() == 0:
            break
        counts["nodes"] += cur.numel()
        sp[cur] -= 1
        node = stack[cur, sp[cur]]
        oc = o[cur][:, :, None]
        ic = inv[cur][:, :, None]
        t0 = (lo[node] - oc) * ic                                  # (k, 3, 8)
        t1 = (hi[node] - oc) * ic
        tmin = torch.minimum(t0, t1)
        tmax = torch.maximum(t0, t1)
        t_near = torch.maximum(torch.maximum(tmin[:, 0], tmin[:, 1]), tmin[:, 2])
        t_far = torch.minimum(torch.minimum(tmax[:, 0], tmax[:, 1]), tmax[:, 2])
        bhit = (t_near <= t_far) & (t_far > 0.0) & (t_near < best_t[cur][:, None])
        links = links_t[node]                                      # (k, 8)
        for c in range(8):
            hc = bhit[:, c]
            lk = links[:, c]
            push = hc & (lk >= 0)
            rows = cur[push]
            if rows.numel():
                stack[rows, sp[rows]] = lk[push]
                sp[rows] += 1
            leaf = hc & (lk < 0) & (lk > _EMPTY_GUARD)
            if leaf.any():
                leaf_test(cur[leaf], -(lk[leaf] + 1))
    if visits is not None:
        for k in counts:
            visits[k] = visits.get(k, 0) + counts[k]
    return best_t, best_u, best_v, best_id
