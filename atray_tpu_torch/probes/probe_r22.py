"""Probe P11 (``scripts/probe_r22.py``): the lane take with source rows
staged through shared memory, bisected into full, no-copy and no-compute
runs, against ``csrc/lane_take.cu``'s direct gather.

``stream_take(cols, idx, mode)`` computes ``lane_take``'s function,
``out[c, i] = cols[c, idx[i]]`` for ``idx[i]`` in ``[0, N)``, else 0, over
(C, rows, 128) 32-bit words, N = 128 rows. On a CUDA tensor it launches
``csrc/probe_stream_take.cu``: each block stages the source rows an output
row's map touches, a group of planes at a time, into a double-buffered ring
of bulk copies, and gathers from shared memory. ``mode``:

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

from typing import List

import numpy as np
import torch

from atray_tpu_torch.kernels import _build
from atray_tpu_torch.kernels.lane_pack import lane_take
from atray_tpu_torch.probes import _timing
from atray_tpu_torch.probes import probe_r21
from atray_tpu_torch.probes.probe_r21 import C, LANE, ROWS, occupancy_map, scattered_map, take_work

CASES = ((0.15, 16), (0.035, 64))   # occupancy, the TPU script's wcap
MODES = ("full", "nocopy", "nocompute")
STAGE_ROWS = 96                     # plane-rows a stage holds (csrc/probe_stream_take.cu)


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


def staged_bytes(idx: torch.Tensor, c: int) -> int:
    """Bytes the staged take copies: each output row's span of source rows,
    C planes of 512 B each (rows wider than a stage of STAGE_ROWS are
    gathered directly and not counted)."""
    n = idx.shape[0]
    rows = idx.reshape(-1, LANE).long()
    ok = (rows >= 0) & (rows < n)
    lo = torch.where(ok, rows // LANE, n).amin(1)
    hi = torch.where(ok, rows // LANE, -1).amax(1)
    span = torch.clamp(hi - lo + 1, min=0)
    return int(torch.where(span <= STAGE_ROWS, span, 0).sum()) * c * LANE * 4


def check(dev: torch.device, out=print) -> dict:
    """The full take equal to its plain version at 16,200 rows x 14 planes
    on the maps of every occupancy of r21 and r22 and on a scattered map
    (whose rows are gathered directly)."""
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.normal(size=(C, ROWS, LANE)).astype(np.float32)).to(dev)
    occs = sorted({occ for occ, _ in CASES + probe_r21.CASES}, reverse=True)
    for idx in [occupancy_map(dev, occ, rng) for occ in occs] + [scattered_map(dev, rng)]:
        if not torch.equal(stream_take(base, idx), stream_take_ref(base, idx)):
            raise AssertionError("P11: kernel != plain version")
    out(f"probe_r22 check: staged take == plain version at {ROWS} rows x {C} planes, occupancy "
        f"{occs} and a scattered map (bit-equal)")
    return {"probe_stream_take": 0.0}


def table(dev: torch.device, out=print) -> List[_timing.Timed]:
    """The script's measurements on the card: each mode at each occupancy
    beside the direct ``lane_take`` on the same data and maps; returns the
    timed full takes."""
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.normal(size=(C, ROWS, LANE)).astype(np.float32)).to(dev)
    planes = base.reshape(C, ROWS * LANE)
    res = []
    for occ, wcap in CASES:
        idx = occupancy_map(dev, occ, rng)
        direct = _timing.events_ms(lambda: lane_take(planes, idx), 10)
        b_ms, by = _timing.bound(take_work(idx, C), 0.0)
        staged = staged_bytes(idx, C)
        for mode in MODES:
            ms = _timing.events_ms(lambda mode=mode: stream_take(base, idx, mode), 10)
            t = _timing.Timed("probe_stream_take", f"occ={occ} {mode}", ms, b_ms, by,
                              one_block=False)
            out(f"probe_r22 occ={occ:.3f} (the script's wcap {wcap}) {mode:10s}: {ms:.4f} ms; "
                f"direct lane_take {direct:.4f} ms; staged {staged / 1e6:.1f} MB; "
                f"{t.bound_text()}")
            if mode == "full":
                res.append(t)
    return res


def main() -> None:
    dev = _timing.require_cuda()
    print(_timing.gpu_line())
    check(dev)
    table(dev)


if __name__ == "__main__":
    main()
