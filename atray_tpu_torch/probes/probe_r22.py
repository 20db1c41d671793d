"""Probe P11 (``scripts/probe_r22.py``): the lane take with source rows
staged through shared memory, bisected into full, no-copy and no-compute
runs, against ``csrc/lane_take.cu``'s direct gather.

``stream_take(cols, idx, mode)`` computes ``lane_take``'s function,
``out[c, i] = cols[c, idx[i]]`` for ``idx[i]`` in ``[0, N)``, else 0,
over (C, rows, 128) 32-bit words, N = 128 rows. On a CUDA tensor it launches
``csrc/probe_stream_take.cu``: five blocks an SM, each a producer warp that
reads an output row's index words, finds the span of source rows its live
lanes read with a warp min/max and fills a ring of two stages of
``STAGE_ROWS`` plane-rows with bulk copies (one a plane of the span), and
eight consumer warps that gather from shared memory; a row with no live
lane is only zeroed, and a row wider than a stage is gathered from device
memory (``row_spans`` gives the spans). ``mode``:

- ``"full"``: the take (exact, checked);
- ``"nocopy"``: the TPU's ``nodma``, no copy issued or awaited, the gather
  reads stale shared memory (timing only);
- ``"nocompute"``: the copies only, the output left as zeros (timing only).

On a CPU tensor it runs ``stream_take_ref`` (the take; the timing modes have
no plain counterpart). ``python -m atray_tpu_torch.probes.probe_r22``
prints, on the card, the script's table at 16,200 rows x 14 planes and
occupancy 0.15 and 0.035, with ``lane_take``'s time on the same data and
maps beside it.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np
import torch

from atray_tpu_torch.kernels import _build
from atray_tpu_torch.kernels.lane_pack import lane_take, pack_indices, unpack_indices
from atray_tpu_torch.probes import _timing
from atray_tpu_torch.probes import probe_r21
from atray_tpu_torch.probes.probe_r21 import C, LANE, ROWS, occupancy_map, scattered_map, take_work

CASES = ((0.15, 16), (0.035, 64))   # occupancy, the TPU script's wcap
MODES = ("full", "nocopy", "nocompute")
STAGE_ROWS = 40                     # plane-rows a stage holds (kCap; check() holds them equal)


def _check(cols: torch.Tensor, idx: torch.Tensor) -> torch.device:
    dev = _timing.check_device(cols, idx)
    if cols.dim() != 3 or cols.shape[2] != LANE or cols.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"cols must be a (C, rows, {LANE}) float32 or int32 tensor")
    if idx.dtype != torch.int32 or idx.shape != (cols.shape[1] * LANE,):
        raise TypeError("idx must be a (rows * 128,) int32 tensor")
    return dev


def stream_take_ref(cols: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of the take over (C, rows, 128)."""
    _build.COUNTERS["probe_stream_take"].plain_calls += 1
    c, rows, _ = cols.shape
    flat = cols.reshape(c, rows * LANE)
    ok = (idx >= 0) & (idx < rows * LANE)
    got = flat[:, torch.where(ok, idx, 0).long()]
    got = torch.where(ok[None], got, torch.zeros((), dtype=cols.dtype, device=cols.device))
    return got.reshape(c, rows, LANE)


def stream_take(cols: torch.Tensor, idx: torch.Tensor, mode: str = "full") -> torch.Tensor:
    """P11: the staged take; see the module docstring."""
    dev = _check(cols, idx)
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}")
    if dev.type == "cpu":
        if mode != "full":
            raise ValueError("the timing modes run only on the card")
        return stream_take_ref(cols, idx)
    out = torch.zeros_like(cols) if mode == "nocompute" else torch.empty_like(cols)
    _timing.launch("atray_probe_stream_take", "probe_stream_take", dev, cols.data_ptr(),
                   idx.data_ptr(), out.data_ptr(), cols.shape[1], cols.shape[0], MODES.index(mode))
    return out


def row_spans(idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(first source row, source rows spanned) of each output row's live
    lanes; (0, 0) for a row with none."""
    n = idx.shape[0]
    src = idx.reshape(-1, LANE).long()
    ok = (src >= 0) & (src < n)
    lo = torch.where(ok, src // LANE, n).amin(1)
    hi = torch.where(ok, src // LANE, -1).amax(1)
    live = hi >= 0
    return torch.where(live, lo, 0), torch.where(live, hi - lo + 1, 0)


def staged_bytes(idx: torch.Tensor, c: int) -> int:
    """Bytes the staged take copies: the spans of ``row_spans`` that fit a
    stage, C planes of 512 B a source row."""
    span = row_spans(idx)[1]
    return int(span[span <= STAGE_ROWS].sum()) * c * LANE * 4


def design_work(idx: torch.Tensor, c: int) -> int:
    """Bytes this design moves through device memory: the staged rows, the
    index once and the output."""
    return staged_bytes(idx, c) + 4 * idx.shape[0] + 4 * c * idx.shape[0]


def launch_shape() -> dict:
    """The kernel's threads, shared memory a block, stages and plane-rows a
    stage."""
    shape = (ctypes.c_int * 4)()
    _build.check(_build.load().atray_probe_stream_take_shape(shape),
                 "atray_probe_stream_take_shape")
    return dict(zip(("threads", "smem", "stages", "cap"), shape))


def resources() -> str:
    """Threads, shared memory and ptxas's registers and spills of the kernel."""
    sh = launch_shape()
    return (f"{sh['threads']} threads, {sh['smem']} B shared memory, {sh['stages']} stages of "
            f"{sh['cap']} plane-rows, ptxas "
            f"{_timing.ptxas('probe_stream_take_kernel')}")


def edge_map(rows: int = ROWS) -> torch.Tensor:
    """The identity map with rows at a stage's edge: output row 100 spans
    exactly ``STAGE_ROWS`` source rows (staged, one plane a stage) and row
    101 one more (gathered directly); row 102 has no live lane."""
    idx = torch.arange(rows * LANE, dtype=torch.int32).view(rows, LANE)
    idx[100, 127] = (100 + STAGE_ROWS - 1) * LANE + 5
    idx[101, 0] = (101 - STAGE_ROWS) * LANE + 7
    idx[102] = -1
    return idx.reshape(-1)


def check_maps(dev, rng) -> list:
    """(label, planes, map) of the card check beyond the occupancy maps:
    dead rows interleaving live ones (the unpacked map of a mask with half
    its rows dead; a packed map with its rows shuffled), the stage's edge,
    a row count that no grid divides (ROWS + 3, and 37 rows: fewer chunks
    than SMs), C = 1 and int32 words."""
    def planes(c, rows, dtype=torch.float32):
        if dtype == torch.int32:
            return torch.from_numpy(rng.integers(-2**31, 2**31, size=(c, rows, LANE),
                                                 dtype=np.int64).astype(np.int32)).to(dev)
        return torch.from_numpy(rng.normal(size=(c, rows, LANE)).astype(np.float32)).to(dev)

    def mask(rows, occ):
        return torch.from_numpy(rng.random(rows * LANE) < occ).to(dev)

    live_rows = torch.from_numpy(rng.random(ROWS) < 0.5).to(dev)
    half = mask(ROWS, 0.3) & live_rows.repeat_interleave(LANE)
    shuffled = occupancy_map(dev, 0.15, rng).view(ROWS, LANE)[torch.from_numpy(
        rng.permutation(ROWS)).to(dev)].reshape(-1)
    return [("unpacked, half the rows dead", planes(C, ROWS), unpack_indices(half)),
            ("packed, rows shuffled", planes(C, ROWS), shuffled),
            ("stage edge", planes(C, ROWS), edge_map().to(dev)),
            (f"{ROWS + 3} rows", planes(C, ROWS + 3), pack_indices(mask(ROWS + 3, 0.15))),
            ("37 rows", planes(C, 37), pack_indices(mask(37, 0.15))),
            ("C=1", planes(1, ROWS), occupancy_map(dev, 0.035, rng)),
            ("int32", planes(C, ROWS, torch.int32), occupancy_map(dev, 0.15, rng))]


def check(dev: torch.device, out=print) -> dict:
    """The full take equal to its plain version at 16,200 rows x 14 planes
    on the maps of every occupancy of r21 and r22, on a scattered map (whose
    rows are gathered directly) and on ``check_maps``."""
    if launch_shape()["cap"] != STAGE_ROWS:
        raise AssertionError(f"P11: the kernel's stage holds {launch_shape()['cap']} plane-rows, "
                             f"STAGE_ROWS says {STAGE_ROWS}")
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.normal(size=(C, ROWS, LANE)).astype(np.float32)).to(dev)
    occs = sorted({occ for occ, _ in CASES + probe_r21.CASES}, reverse=True)
    cases = [(f"occupancy {occ}", base, occupancy_map(dev, occ, rng)) for occ in occs]
    cases += [("scattered", base, scattered_map(dev, rng))] + check_maps(dev, rng)
    for label, cols, idx in cases:
        if not torch.equal(stream_take(cols, idx), stream_take_ref(cols, idx)):
            raise AssertionError(f"P11 {label}: kernel != plain version")
    out(f"probe_r22 check: staged take == plain version (bit-equal) on {len(cases)} maps: "
        f"{', '.join(label for label, _, _ in cases)}")
    return {"probe_stream_take": 0.0}


def table(dev: torch.device, out=print) -> List[_timing.Timed]:
    """The script's measurements on the card: each mode at each occupancy
    beside the direct ``lane_take`` on the same data and maps, with the need
    bound and the bound of the bytes this design moves (``design_work``);
    returns the timed full takes."""
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.normal(size=(C, ROWS, LANE)).astype(np.float32)).to(dev)
    planes = base.reshape(C, ROWS * LANE)
    res = []
    for occ, wcap in CASES:
        idx = occupancy_map(dev, occ, rng)
        direct = _timing.events_ms(lambda: lane_take(planes, idx), 10)
        b_ms, by = _timing.bound(take_work(idx, C), 0.0)
        staged = staged_bytes(idx, C)
        d_ms, _ = _timing.bound(design_work(idx, C), 0.0)
        for mode in MODES:
            ms = _timing.events_ms(lambda mode=mode: stream_take(base, idx, mode), 10)
            t = _timing.Timed("probe_stream_take", f"occ={occ} {mode}", ms, b_ms, by,
                              one_block=False)
            out(f"probe_r22 occ={occ:.3f} (the script's wcap {wcap}) {mode:10s}: {ms:.4f} ms; "
                f"direct lane_take {direct:.4f} ms; staged {staged / 1e6:.1f} MB; "
                f"{t.bound_text()}; the design's bound {d_ms:.6g} ms ({ms / d_ms:.3f}x)")
            if mode == "full":
                res.append(t)
    return res


def main() -> None:
    dev = _timing.require_cuda()
    print(_timing.gpu_line())
    check(dev)
    table(dev)
    print(f"probe_r22 kernel: {resources()}")


if __name__ == "__main__":
    main()
