"""Per-ray lane take for wavefront compaction (``atray_tpu/kernels/lane_pack.py``).

``lane_take(cols, idx)``: ``out[:, i] = cols[:, idx[i]]``, and 0 where
``idx[i]`` is negative (or not below N). ``cols`` is (C, N) of 32-bit words
(float32 or int32): the kernel moves bits, so float state planes and int32
ray ids ride one call exactly. ``pack_indices(alive)`` packs live rays to a
dense prefix, stably; ``unpack_indices(alive)`` routes packed values back.

On a CUDA tensor ``lane_take`` launches ``csrc/lane_take.cu`` (a
grid-stride gather with no band limit); on a CPU tensor it runs
``lane_take_ref``. The reference's band contract and window (``wcap``) are
TPU routing constraints and have no counterpart here. The scatter
direction (``lane_scatter``, the take's VJP) is not ported yet.
"""

from __future__ import annotations

import torch

from atray_tpu_torch.kernels import _build

COUNTER = _build.COUNTERS["lane_take"]


def _check(cols: torch.Tensor, idx: torch.Tensor) -> None:
    if cols.dim() != 2 or cols.dtype not in (torch.float32, torch.int32):
        raise TypeError("cols must be a (C, N) float32 or int32 tensor")
    if idx.dtype != torch.int32 or idx.shape != (cols.shape[1],):
        raise TypeError("idx must be an (N,) int32 tensor")
    if idx.device != cols.device:
        raise TypeError("cols and idx must be on one device")
    if not (cols.is_contiguous() and idx.is_contiguous()):
        raise ValueError("cols and idx must be contiguous")


def lane_take(cols: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather lanes of every plane; see the module docstring."""
    _check(cols, idx)
    dev = cols.device
    if dev.type == "cpu":
        return lane_take_ref(cols, idx)
    if dev.type != "cuda":
        raise TypeError(f"no lane_take kernel for device {dev}")
    lib = _build.load()
    out = torch.empty_like(cols)
    c, n = cols.shape
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.atray_lane_take(cols.data_ptr(), idx.data_ptr(), out.data_ptr(), c, n, stream)
    COUNTER.launches += 1
    _build.check(rc, "lane_take")
    return out


def lane_take_ref(cols: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    COUNTER.plain_calls += 1
    n = cols.shape[1]
    ok = (idx >= 0) & (idx < n)
    src = torch.where(ok, idx, 0).long()
    return torch.where(ok[None, :], cols[:, src], torch.zeros((), dtype=cols.dtype, device=cols.device))


def pack_indices(alive: torch.Tensor) -> torch.Tensor:
    """idx for ``lane_take`` that packs live rays to the front, stably:
    idx[p] = index of the p-th live ray, -1 past the live count."""
    n = alive.shape[0]
    key = torch.where(alive, 0, 1).to(torch.int32)
    order = torch.argsort(key, stable=True).to(torch.int32)
    n_live = alive.sum()
    pos = torch.arange(n, device=alive.device)
    return torch.where(pos < n_live, order, -1).to(torch.int32)


def unpack_indices(alive: torch.Tensor) -> torch.Tensor:
    """idx for ``lane_take`` that routes packed results back to the
    original layout: idx[i] = packed position of ray i, -1 for dead rays."""
    pos = torch.cumsum(alive.to(torch.int32), dim=0) - 1
    return torch.where(alive, pos, -1).to(torch.int32)
