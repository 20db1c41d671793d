"""Ray sharding over the ranks of a process group (``atray_tpu/dist/mesh.py``).

The reference shards the flat ray axis over a 1-D ``jax.sharding.Mesh``
with ``shard_map``, one controller for every device. The port runs one
process per rank (``dist/multihost.py``): every rank makes the whole
frame's camera rays, which is cheap, traces only its own contiguous slice
of them, and the colours are assembled by ``all_gather``, so every rank
holds the film, as the reference's ``P(axis)`` output is one global array.

Every random number is a pure function of (key, GLOBAL ray id, bounce), and
a rank's slice keeps its global ids (``rank * shard_len + lane``), so the
sharded film equals the one-rank film bit for bit for any rank count.

``make_device_mesh`` gives a ``RayMesh``, a small frozen dataclass (the
group, its size, this rank, the rank's device and the axis name) rather than
``torch.distributed.device_mesh.DeviceMesh``: the ring and the gathers need
only the group and the rank, and a one-rank mesh needs no group at all.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from atray_tpu_torch.config import RenderSettings
from atray_tpu_torch.core.camera import Camera
from atray_tpu_torch.device import resolve_device
from atray_tpu_torch.dist.multihost import process_info


@dataclasses.dataclass(frozen=True)
class RayMesh:
    """A 1-D mesh of ``size`` ranks over the ray axis ``axis_name``; this
    process is ``rank`` and computes on ``device``. ``group`` is the process
    group of the collectives, None for a one-rank mesh without one (its
    gathers are the identity)."""

    size: int
    rank: int
    device: torch.device
    axis_name: str = "rays"
    group: Optional[object] = None


def rank_device(device=None) -> torch.device:
    """This rank's device: ``device`` as given, except that a CUDA device
    without an index (None means "cuda") becomes card ``LOCAL_RANK`` (as
    ``torchrun`` sets it; else the rank) modulo the visible cards."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", process_info()[0]))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return resolve_device(dev)


def make_device_mesh(num_devices: int = 0, axis_name: str = "rays", device=None) -> RayMesh:
    """1-D ray mesh over the ranks of the process group (one rank without
    a group). ``num_devices`` 0 or -1 means every rank; any other count
    must equal the world size, since a process is a rank here (the
    reference takes the first N devices of its one controller): a
    ``ValueError`` names both numbers otherwise. ``device`` is the rank's
    (``rank_device``); a CUDA one becomes the current device."""
    rank, world = process_info()
    if num_devices not in (0, -1, None) and num_devices != world:
        raise ValueError(
            f"a mesh of {num_devices} ranks asked for, but the process group has "
            f"{world}: launch {num_devices} ranks (torchrun --nproc-per-node "
            f"{num_devices}) or ask for {world}")
    dev = rank_device(device)
    if dev.type == "cuda" and dist.is_initialized():
        torch.cuda.set_device(dev)
    return RayMesh(size=world, rank=rank, device=dev, axis_name=axis_name,
                   group=dist.group.WORLD if dist.is_initialized() else None)


def gather_rows(x: torch.Tensor, mesh: RayMesh) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes), concatenated along dim 0 in rank
    order, on every rank: one ``all_gather`` over the mesh's group."""
    if mesh.group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x, group=mesh.group)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    """``gather_rows`` with a backward: the cotangent of the gathered rows,
    cut to this rank's own block. It is not summed over the ranks (as
    ``torch.distributed.nn.functional.all_gather``'s backward is): every
    rank computes the same loss from the same gathered rows, so each
    block's cotangent is already whole on its own rank, and a sum would
    count it ``mesh.size`` times. The replicated leaves are summed once,
    after ``autograd.grad``, by ``dist.train.reduce_grads``."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.rows, ctx.rank = x.shape[0], mesh.rank
        return gather_rows(x.detach(), mesh)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.rows
        return grad[lo:lo + ctx.rows], None


def gather_rows_grad(x: torch.Tensor, mesh: RayMesh) -> torch.Tensor:
    """``gather_rows`` that autograd differentiates: its backward hands
    each rank its own block of the cotangent and runs no collective."""
    if mesh.group is None:
        return x
    return _GatherRows.apply(x, mesh)


def shard_slice(n: int, mesh: RayMesh) -> slice:
    """The contiguous block of ``n`` rays (a multiple of ``mesh.size``) that
    this rank traces."""
    if n % mesh.size:
        raise ValueError(f"{n} rays do not divide over {mesh.size} ranks: pad them")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def trace_sharded(scene, orig: torch.Tensor, dirn: torch.Tensor, bounce_limit: int, key,
                  mesh: RayMesh, accel=None, axis_name: str = "rays") -> torch.Tensor:
    """Path-trace the global rays (R, 3), every rank holding all of them,
    with each rank tracing its contiguous block; scene and accel are
    replicated. R must divide over the ranks. Random streams are keyed by
    the global ray id, so the (R, 3) colours, gathered on every rank,
    equal ``trace_radiance`` on the same rays bit for bit."""
    from atray_tpu_torch.render.wavefront import trace_radiance

    check_axis(mesh, axis_name)
    part = shard_slice(orig.shape[0], mesh)
    ids = torch.arange(part.start, part.stop, dtype=torch.int32, device=orig.device)
    color = trace_radiance(scene, orig[part], dirn[part], bounce_limit, key=key, accel=accel,
                           ray_ids=ids)
    return gather_rows(color, mesh)


def render_sharded(scene, camera: Camera, settings: RenderSettings, key, mesh: RayMesh,
                   accel=None, axis_name: str = "rays"):
    """The sharded render: ``wavefront.render`` with ``mesh``, which runs
    the whole feature set (NEE, compaction, chunking, tile order) on each
    rank's slice and equals the one-rank film bit for bit."""
    from atray_tpu_torch.render.wavefront import render

    return render(scene, camera, settings, key, accel=accel, mesh=mesh, axis_name=axis_name)


def check_axis(mesh: RayMesh, axis_name: str) -> None:
    """Raise unless ``axis_name`` is the mesh's axis (the reference's
    ``shard_map`` fails on an axis its mesh lacks)."""
    if axis_name != mesh.axis_name:
        raise ValueError(f"axis {axis_name!r} is not the mesh's ({mesh.axis_name!r})")
