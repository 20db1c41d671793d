"""Per-ray lane take and scatter for wavefront compaction
(``atray_tpu/kernels/lane_pack.py``).

``lane_take(cols, idx)``: ``out[:, i] = cols[:, idx[i]]``, and 0 where
``idx[i]`` is negative (or not below N). ``cols`` is (C, N) of 32-bit words
(float32 or int32): the kernel moves bits, so float state planes and int32
ray ids ride one call exactly. ``pack_indices(alive)`` packs live rays to a
dense prefix, stably; ``unpack_indices(alive)`` routes packed values back.

``lane_scatter(cols, dst)``: ``out[:, dst[i]] += cols[:, i]`` over (C, N)
float32, from zeros; ``dst < 0`` (or not below N) drops the lane, lanes
nobody targets stay 0, duplicate targets sum. It is the take's transpose:
``lane_take_p`` and ``lane_scatter_p`` are ``torch.autograd.Function``s
whose backward is the other direction with the same index, as the
reference's custom VJPs are.

On a CUDA tensor ``lane_take`` launches ``csrc/lane_take.cu`` and
``lane_scatter`` ``csrc/lane_scatter.cu``, one launch a call; on a CPU
tensor they run ``lane_take_ref`` and ``lane_scatter_ref``. The reference's
band contract, window (``wcap``) and anchor alignment are TPU routing
constraints with no counterpart here: both kernels take any index map.
Both walk the planes in groups sized by ``plane_group`` so that one
group's planes stay in the card's L2 (see the kernels' head notes).
"""

from __future__ import annotations

import torch

from atray_tpu_torch.kernels import _build

COUNTER = _build.COUNTERS["lane_take"]
SCATTER_COUNTER = _build.COUNTERS["lane_scatter"]

# L2 bytes the planes of one group may fill: two planes of a 4,147,200-ray
# chunk, four of a 2,073,600-ray one. Smaller groups gather a scattered map
# faster, but each group re-reads the index, which the path's pack and
# unpack maps and the gradient's sparse scatters pay for.
GROUP_BYTES = 32 << 20
L2_BYTES = 50 << 20        # the H100's L2


def plane_group(n: int, c: int) -> int:
    """Planes of N 32-bit lanes that one group of a lane kernel walks: as
    many as fit ``GROUP_BYTES``, at least one, at most ``c``. Each group
    re-reads the index (4 B x N), from L2 only while the group's planes and
    the index fit it together; where they do not, all ``c`` planes go in one
    group, which reads the index once. On the path that is the pair routing
    maps (N = K x R): one plane and the index exceed L2 there."""
    plane = 4 * n
    g = max(1, min(c, GROUP_BYTES // max(plane, 1)))
    return c if (g + 1) * plane > L2_BYTES else g


def _check(cols: torch.Tensor, idx: torch.Tensor, dtypes=(torch.float32, torch.int32)) -> None:
    if cols.dim() != 2 or cols.dtype not in dtypes:
        raise TypeError(f"cols must be a (C, N) tensor of {dtypes}")
    if idx.dtype != torch.int32 or idx.shape != (cols.shape[1],):
        raise TypeError("idx must be an (N,) int32 tensor")
    if idx.device != cols.device:
        raise TypeError("cols and idx must be on one device")
    if not (cols.is_contiguous() and idx.is_contiguous()):
        raise ValueError("cols and idx must be contiguous")
    if cols.device.type not in ("cpu", "cuda"):
        raise TypeError(f"no lane kernel for device {cols.device}")


def _launch(fn_name: str, counter: _build.Counter, cols, idx, out) -> None:
    lib = _build.load()
    c, n = cols.shape
    with torch.cuda.device(cols.device):
        stream = torch.cuda.current_stream(cols.device).cuda_stream
        rc = getattr(lib, fn_name)(cols.data_ptr(), idx.data_ptr(), out.data_ptr(), c, n,
                                   plane_group(n, c), stream)
    counter.launches += 1
    _build.check(rc, fn_name)


def lane_take(cols: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather lanes of every plane; see the module docstring."""
    _check(cols, idx)
    if cols.device.type == "cpu":
        return lane_take_ref(cols, idx)
    out = torch.empty_like(cols)
    _launch("atray_lane_take", COUNTER, cols, idx, out)
    return out


def lane_take_ref(cols: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the take kernel."""
    COUNTER.plain_calls += 1
    n = cols.shape[1]
    ok = (idx >= 0) & (idx < n)
    src = torch.where(ok, idx, 0).long()
    return torch.where(ok[None, :], cols[:, src], torch.zeros((), dtype=cols.dtype, device=cols.device))


def lane_scatter(cols: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Scatter-add lanes of every plane; see the module docstring."""
    _check(cols, dst, dtypes=(torch.float32,))
    if cols.device.type == "cpu":
        return lane_scatter_ref(cols, dst)
    out = torch.zeros_like(cols)
    _launch("atray_lane_scatter", SCATTER_COUNTER, cols, dst, out)
    return out


def lane_scatter_ref(cols: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the scatter kernel, without a library
    scatter-add: sources are sorted by target (stably), and round r adds
    every target's r-th source, so each round is an assignment to distinct
    lanes. An injective map takes one round; duplicates sum in input order."""
    SCATTER_COUNTER.plain_calls += 1
    n = cols.shape[1]
    out = torch.zeros_like(cols)
    src = torch.nonzero((dst >= 0) & (dst < n)).squeeze(1)
    if src.numel() == 0:
        return out
    d = dst[src].long()
    order = torch.argsort(d, stable=True)
    src, d = src[order], d[order]
    pos = torch.arange(d.numel(), device=d.device)
    first = torch.ones_like(d, dtype=torch.bool)
    first[1:] = d[1:] != d[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), dim=0).values
    for r in range(int(rank.max()) + 1):
        sel = rank == r
        ds = d[sel]
        out[:, ds] = out[:, ds] + cols[:, src[sel]]
    return out


class _LaneTake(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cols, idx):
        ctx.save_for_backward(idx)
        return lane_take(cols, idx)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return lane_scatter(ct.contiguous(), idx), None


class _LaneScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cols, dst):
        ctx.save_for_backward(dst)
        return lane_scatter(cols, dst)

    @staticmethod
    def backward(ctx, ct):
        (dst,) = ctx.saved_tensors
        return lane_take(ct.contiguous(), dst), None


def lane_take_p(cols: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Differentiable ``lane_take`` over float32 planes: the take is linear
    in ``cols`` and its transpose is ``lane_scatter`` by the same index."""
    return _LaneTake.apply(cols, idx)


def lane_scatter_p(cols: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Differentiable ``lane_scatter``; its transpose is ``lane_take`` by
    ``dst``."""
    return _LaneScatter.apply(cols, dst)


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
