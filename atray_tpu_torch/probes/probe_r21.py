"""Probe P10 (``scripts/probe_r21.py``): the lane take over a ray-major
``(rows, C, 128)`` layout against the package's plane-major ``(C, rows, 128)``.

``take_rm(cols, idx)``: ``out[j, c, l] = cols[s // 128, c, s % 128]`` for
``s = idx[128 j + l]`` in ``[0, N)``, else 0, over 32-bit words (float32 or
int32), N = 128 rows. On a CUDA tensor it launches ``csrc/probe_take_rm.cu``
(one thread per output lane, C words each); on a CPU tensor it runs
``take_rm_ref``. The TPU kernel (``_kernel``, through ``lane_take_rm``)
routes each output row through a window of ``wcap`` rows and drops sources
beyond it; this take has no band and no ``wcap``, and agrees with it on the
banded maps of ``pack_indices``.

``python -m atray_tpu_torch.probes.probe_r21`` prints, on the card, the
script's table at 16,200 rows x 14 planes (2,073,600 lanes) and occupancy
0.15, 0.07 and 0.035: the ray-major take's time beside ``lane_take``
(``csrc/lane_take.cu``) on the plane-major copy of the same data and maps.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from atray_tpu_torch.kernels import _build
from atray_tpu_torch.kernels.lane_pack import lane_take, pack_indices
from atray_tpu_torch.probes import _timing

LANE = 128
ROWS = 16_200
C = 14
CASES = ((0.15, 16), (0.07, 32), (0.035, 64))   # occupancy, the TPU script's wcap


def _check(cols: torch.Tensor, idx: torch.Tensor) -> torch.device:
    dev = _timing.check_device(cols, idx)
    if cols.dim() != 3 or cols.shape[2] != LANE or cols.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"cols must be a (rows, C, {LANE}) float32 or int32 tensor")
    if idx.dtype != torch.int32 or idx.shape != (cols.shape[0] * LANE,):
        raise TypeError("idx must be a (rows * 128,) int32 tensor")
    return dev


def take_rm_ref(cols: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of the ray-major take."""
    _build.COUNTERS["probe_take_rm"].plain_calls += 1
    rows, c, _ = cols.shape
    n = rows * LANE
    ok = (idx >= 0) & (idx < n)
    s = torch.where(ok, idx, 0).long()
    got = cols[s // LANE, :, s % LANE]                      # (N, C)
    got = torch.where(ok[:, None], got, torch.zeros((), dtype=cols.dtype, device=cols.device))
    return got.reshape(rows, LANE, c).permute(0, 2, 1).contiguous()


def take_rm(cols: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P10: the take over (rows, C, 128) words; see the module docstring."""
    dev = _check(cols, idx)
    if dev.type == "cpu":
        return take_rm_ref(cols, idx)
    out = torch.empty_like(cols)
    _timing.launch("atray_probe_take_rm", "probe_take_rm", dev, cols.data_ptr(), idx.data_ptr(),
                   out.data_ptr(), cols.shape[0], cols.shape[1])
    return out


def take_work(idx: torch.Tensor, c: int) -> int:
    """Bytes the take needs: the index, the C words of each live lane, the
    output."""
    n = idx.shape[0]
    live = int(((idx >= 0) & (idx < n)).sum())
    return 4 * n + 4 * c * live + 4 * c * n


def occupancy_map(dev, occ: float, rng) -> torch.Tensor:
    """``pack_indices`` of a liveness mask at ``occ`` over ROWS x 128 lanes."""
    alive = torch.from_numpy(rng.random(ROWS * LANE) < occ).to(dev)
    return pack_indices(alive)


def scattered_map(dev, rng, n: int = ROWS * LANE) -> torch.Tensor:
    """A permutation of the lanes with 5% -1: no band at all."""
    scat = rng.permutation(n).astype(np.int32)
    scat[rng.random(n) < 0.05] = -1
    return torch.from_numpy(scat).to(dev)


def check(dev: torch.device, out=print) -> dict:
    """The take equal to its plain version at 16,200 rows x 14 planes on
    the maps of every occupancy and on a scattered map."""
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.normal(size=(ROWS, C, LANE)).astype(np.float32)).to(dev)
    maps = [occupancy_map(dev, occ, rng) for occ, _ in CASES] + [scattered_map(dev, rng)]
    for idx in maps:
        if not torch.equal(take_rm(base, idx), take_rm_ref(base, idx)):
            raise AssertionError("P10: kernel != plain version")
    out(f"probe_r21 check: ray-major take == plain version at {ROWS} rows x {C} planes, "
        f"occupancy {[occ for occ, _ in CASES]} and a scattered map (bit-equal)")
    return {"probe_take_rm": 0.0}


def table(dev: torch.device, out=print) -> List[_timing.Timed]:
    """The script's measurements on the card: the ray-major take at each
    occupancy beside the plane-major ``lane_take`` on the same data and
    maps; returns the timed ray-major takes."""
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.normal(size=(ROWS, C, LANE)).astype(np.float32)).to(dev)
    planes = base.permute(1, 0, 2).reshape(C, ROWS * LANE).contiguous()
    res = []
    for occ, wcap in CASES:
        idx = occupancy_map(dev, occ, rng)
        ms = _timing.events_ms(lambda: take_rm(base, idx), 10)
        pm_ms = _timing.events_ms(lambda: lane_take(planes, idx), 10)
        b_ms, by = _timing.bound(take_work(idx, C), 0.0)
        t = _timing.Timed("probe_take_rm", f"occ={occ}", ms, b_ms, by, one_block=False)
        out(f"probe_r21 occ={occ:.3f} (the script's wcap {wcap}): ray-major take {ms:.4f} ms, "
            f"plane-major lane_take {pm_ms:.4f} ms; {t.bound_text()}")
        res.append(t)
    return res


def main() -> None:
    dev = _timing.require_cuda()
    print(_timing.gpu_line())
    check(dev)
    table(dev)


if __name__ == "__main__":
    main()
