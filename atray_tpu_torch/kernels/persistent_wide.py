"""Nearest triangle hit over a ``WideBVH`` by the 8-wide frustum walk with
persistent work distribution (``atray_tpu/kernels/persistent_pallas.py``:
``_persistent_kernel`` through ``persistent_first_hit``, the fourth lineage
kernel).

``persistent_first_hit(wbvh, orig, dirn)`` takes (R, 3) float32 origins
and directions and returns ``(t, u, v, fid)``, ``(INF, 0, 0, -1)`` on a
miss.

The TPU kernel is one program that loops over all ray blocks, copying each
in and out by DMA, because a per-program copy of the tables dominated
there. On the GPU the tables stay in device memory and no per-block copy
happens, so what carries over is the persistent work distribution: the
grid holds as many blocks as fit on the card at once (the occupancy query
at the launch's registers and shared memory, times the SM count; one warp
a bundle where there are fewer bundles), and each warp takes 32-ray
bundles from a global atomic counter until none are left (the
persistent-threads loop of Aila and Laine, "Understanding the Efficiency
of Ray Traversal on GPUs", HPG 2009). The wrapper allocates the counter
at each call. Each bundle runs ``wide_frustum``'s walk. The reference's
queue holds every leaf; a queue that size does not fit in shared memory
(23,863 leaves of the 139,000-triangle slice mesh at leaf size 8, 95 KB a
warp), so the queue drains when full, as in ``wide_frustum``: the walk
carries no ``tmax``, so the results are the same.

On a CUDA tensor it launches ``csrc/persistent_wide.cu``; on a CPU tensor
it runs ``persistent_ref``, which is ``wide_frustum.wide_ref`` counted
under this kernel's counter. ``interpret`` and ``block_sub`` are not
carried.
"""

from __future__ import annotations

from typing import Optional

import torch

from atray_tpu_torch.accel.wide import WideBVH
from atray_tpu_torch.kernels import _build
from atray_tpu_torch.kernels._checks import check_wide
from atray_tpu_torch.kernels.packet_walk import Hits
from atray_tpu_torch.kernels.wide_frustum import QCAP, STACK_CAP, launch_wide, wide_ref

COUNTER = _build.COUNTERS["persistent_wide"]


def grid_warps(dev: torch.device, leaf_size: int) -> int:
    """Warps of the persistent grid on ``dev`` at ``leaf_size``: resident
    blocks per SM at the kernel's registers and shared memory (which
    grows with the leaf size), times the SM count, times the warps of a
    block. A launch on more bundles than this has warps that take a second
    one."""
    with torch.cuda.device(dev):
        warps = _build.load().atray_persistent_wide_grid(leaf_size)
    if warps <= 0:
        _build.check(-warps or 1, "persistent_wide occupancy query")
    return warps


def persistent_first_hit(wbvh: WideBVH, orig: torch.Tensor, dirn: torch.Tensor) -> Hits:
    """Nearest hit per ray; see the module docstring."""
    return _first_hit(wbvh, orig, dirn)


def _first_hit(wbvh: WideBVH, orig: torch.Tensor, dirn: torch.Tensor,
               visits: Optional[dict] = None) -> Hits:
    """``persistent_first_hit`` with ``wide_frustum._first_hit``'s
    ``visits``, for diagnostics."""
    dev = check_wide(wbvh, orig, dirn, "persistent_wide", STACK_CAP, derived=True)
    if dev.type == "cpu":
        return persistent_ref(wbvh, orig, dirn, visits)
    warps = grid_warps(dev, wbvh.leaf_size)
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    return launch_wide("atray_persistent_wide", COUNTER, "persistent_wide", wbvh, orig, dirn,
                       visits, extra=(counter.data_ptr(), warps))


def persistent_ref(wbvh: WideBVH, orig: torch.Tensor, dirn: torch.Tensor,
                   visits: Optional[dict] = None) -> Hits:
    """Plain PyTorch version: the 8-wide walk of ``wide_ref`` with the
    kernel's queue of ``QCAP``; the order in which warps take bundles does
    not change any bundle's result."""
    return wide_ref(wbvh, orig, dirn, QCAP, visits, counter=COUNTER)
