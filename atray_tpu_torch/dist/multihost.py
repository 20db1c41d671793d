"""Process-group set-up and film assembly (``atray_tpu/dist/multihost.py``).

The reference is one controller over every device of every host
(``jax.distributed.initialize``); the port runs one process per rank, joined
by a ``torch.distributed`` process group, as ``torchrun`` launches them:

- ``init_distributed``: one call, from the caller's arguments or from the
  environment ``torchrun`` sets (``env://``). A no-op when no argument is
  given and the process was not started as a rank, so single-process runs
  need no group.
- ``global_ray_mesh``: the 1-D ray mesh over every rank of the group.
- ``process_info``: (rank, world size); (0, 1) without a group.
- ``host_local_slice``: the rows of a row-sharded film a rank owns (the
  reference's even split).
- ``assemble_film``: every rank's rows, concatenated on every rank, by
  ``all_gather``.

The backend is the caller's choice, never swapped after a failure: by
default ``"nccl"`` when the rank's device is CUDA and ``"gloo"`` on the
CPU. NCCL refuses two ranks on one card; two ranks sharing one card ask for
``"gloo"``, whose ``all_gather`` takes CUDA tensors.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from atray_tpu_torch.device import resolve_device


def default_backend(device=None) -> str:
    """``"nccl"`` for a CUDA device (None: "cuda"), ``"gloo"`` otherwise."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def init_distributed(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None,
                     device=None) -> None:
    """Join the process group. ``init_method`` (``tcp://host:port``,
    ``file://...``; None: ``env://``, the variables ``torchrun`` sets),
    ``world_size`` and ``rank`` go to ``torch.distributed.init_process_group``
    as given. ``backend`` None takes ``default_backend(device)``. No-op when
    nothing is given and the environment holds no ``WORLD_SIZE``, or when
    the group is already initialized."""
    if dist.is_initialized():
        return
    if (init_method is None and world_size is None and rank is None
            and "WORLD_SIZE" not in os.environ):
        return
    dist.init_process_group(
        backend or default_backend(device), init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)


def process_info() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def global_ray_mesh(axis_name: str = "rays", device=None):
    """1-D ray mesh over every rank of the group (``make_device_mesh(0)``)."""
    from atray_tpu_torch.dist.mesh import make_device_mesh

    return make_device_mesh(0, axis_name=axis_name, device=device)


def host_local_slice(total_rows: int) -> slice:
    """Rows of a row-sharded film owned by this rank (even split; the last
    ranks may own fewer rows, or none)."""
    pid, pcount = process_info()
    per = -(-total_rows // pcount)
    lo = min(pid * per, total_rows)
    hi = min(lo + per, total_rows)
    return slice(lo, hi)


def assemble_film(film_local) -> np.ndarray:
    """Every rank's rows of a row-sharded film (``film_local``, a tensor or
    array, on a device the group's backend takes: a CUDA tensor under
    NCCL), concatenated in rank order on every rank, as host numpy. Ranks
    may hold different row counts (``host_local_slice``). Without a group
    it is the film itself."""
    x = torch.as_tensor(film_local)
    if not dist.is_initialized():
        return x.detach().cpu().numpy()
    world = dist.get_world_size()
    rows = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
    counts = [torch.zeros_like(rows) for _ in range(world)]
    dist.all_gather(counts, rows)
    counts = [int(c) for c in counts]
    most = max(counts)
    pad = x.new_zeros((most - x.shape[0],) + tuple(x.shape[1:]))
    parts = [x.new_empty((most,) + tuple(x.shape[1:])) for _ in range(world)]
    dist.all_gather(parts, torch.cat([x.detach(), pad]).contiguous())
    return torch.cat([p[:c] for p, c in zip(parts, counts)]).cpu().numpy()
