"""Probe P10 (``scripts/probe_r21.py``): the lane take over a ray-major
``(rows, C, 128)`` layout against the package's plane-major ``(C, rows, 128)``.

``take_rm(cols, idx)``: ``out[j, c, l] = cols[s // 128, c, s % 128]`` for
``s = idx[128 j + l]`` in ``[0, N)``, else 0, over 32-bit words (float32 or
int32), N = 128 rows. On a CUDA tensor it launches ``csrc/probe_take_rm.cu``
(a warp an output row, read in 16-byte index words and gathered 32
consecutive lanes an instruction, dead rows only zeroed; an ``idx`` off a
16-byte boundary is refused); on a CPU tensor it runs
``take_rm_ref``, which takes any contiguous view. The TPU kernel
(``_kernel``, through ``lane_take_rm``) routes each output row through a
window of ``wcap`` rows and drops sources beyond it; this take has no band
and no ``wcap``, and agrees with it on the banded maps of ``pack_indices``.

``python -m atray_tpu_torch.probes.probe_r21`` prints, on the card, the
checks and the script's table at 16,200 rows x 14 planes (2,073,600 lanes)
and occupancy 0.15, 0.07 and 0.035: the ray-major take's CUDA-event mean
and device time beside ``lane_take`` (``csrc/lane_take.cu``) on the
plane-major copy of the same data and maps, against the bytes the take
needs (``take_work``) and the sectors it must read (``sector_work``); the
scattered map on a line of its own; and the kernel's resources.
"""

from __future__ import annotations

import ctypes
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


def launch_take_rm(cols: torch.Tensor, idx: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the kernel on checked tensors: each warp reads its row's index
    words in 16-byte units, so an ``idx`` off a 16-byte boundary (a
    contiguous view can be 4 bytes off) raises before the library is
    loaded."""
    if idx.data_ptr() % 16:
        raise ValueError("the ray-major take reads idx in 16-byte units; pass an idx that "
                         "starts on a 16-byte boundary (the plain version takes any view)")
    _timing.launch("atray_probe_take_rm", "probe_take_rm", out.device, cols.data_ptr(),
                   idx.data_ptr(), out.data_ptr(), cols.shape[0], cols.shape[1])


def take_rm(cols: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P10: the take over (rows, C, 128) words; see the module docstring."""
    dev = _check(cols, idx)
    if dev.type == "cpu":
        return take_rm_ref(cols, idx)
    out = torch.empty_like(cols)
    launch_take_rm(cols, idx, out)
    return out


def take_work(idx: torch.Tensor, c: int) -> int:
    """Bytes the take needs: the index, the C words of each live lane, the
    output."""
    n = idx.shape[0]
    live = int(((idx >= 0) & (idx < n)).sum())
    return 4 * n + 4 * c * live + 4 * c * n


SECTOR_LANES = 8              # 32-bit words in a 32-byte sector of device memory


def sector_work(idx: torch.Tensor, c: int) -> int:
    """Bytes any design must move for this map: the index, 32 B x C for each
    distinct 32-byte sector (``SECTOR_LANES`` lanes of one source row) that
    holds a live source, and the output. Device memory moves whole sectors,
    so this is the least any design can read for the map; ``take_work``
    counts 4 C bytes a live lane, which no read of scattered words reaches."""
    n = idx.shape[0]
    s = idx.long()
    ok = (s >= 0) & (s < n)
    sectors = torch.unique(s[ok] // SECTOR_LANES).numel()
    return 4 * n + 4 * SECTOR_LANES * c * sectors + 4 * c * n


def occupancy_map(dev, occ: float, rng) -> torch.Tensor:
    """``pack_indices`` of a liveness mask at ``occ`` over ROWS x 128 lanes."""
    alive = torch.from_numpy(rng.random(ROWS * LANE) < occ).to(dev)
    return pack_indices(alive)


def scattered_map(dev, rng, n: int = ROWS * LANE) -> torch.Tensor:
    """A permutation of the lanes with 5% -1: no band at all."""
    scat = rng.permutation(n).astype(np.int32)
    scat[rng.random(n) < 0.05] = -1
    return torch.from_numpy(scat).to(dev)


def launch_shape(rows: int = ROWS, c: int = C) -> dict:
    """The kernel's threads, blocks an SM (the occupancy query's) and grid
    at ``rows`` x ``c`` planes."""
    shape = (ctypes.c_int * 3)()
    _build.check(_build.load().atray_probe_take_rm_shape(rows, c, shape),
                 "atray_probe_take_rm_shape")
    return dict(zip(("threads", "blocks_per_sm", "grid"), shape))


def resources(rows: int = ROWS, c: int = C) -> str:
    """Threads, grid and ptxas's registers and spills of the instance that
    moves ``c`` planes (16 above 16: more planes run as chunks of 16)."""
    sh = launch_shape(rows, c)
    return (f"{sh['threads']} threads, grid {sh['grid']} ({sh['blocks_per_sm']} blocks an SM), "
            f"ptxas {_timing.ptxas(f'probe_take_rm_kernelILi{min(c, 16)}E')}")


NAN_BITS = (0x7FC00000, 0x7FC00001, 0xFFC00000, 0x7F800001, 0xFF800000, 0x7F800000)


def nan_words(dev, rng, rows: int = ROWS, c: int = C) -> torch.Tensor:
    """(rows, c, 128) int32 words drawn from NaN and infinity bit patterns
    (``NAN_BITS``): a take that sent a word through a float operation would
    change some of them."""
    bits = np.array(NAN_BITS, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(rng.choice(bits, size=(rows, c, LANE))).to(dev)


def edge_maps(dev, rng, rows: int = ROWS) -> list:
    """(label, map) over ``rows`` x 128 lanes: every lane dead, the
    identity, indices at N and above (and at the int32 extremes) between
    live ones, and only the last row live."""
    n = rows * LANE
    ident = torch.arange(n, dtype=torch.int32, device=dev)
    over = ident.clone()
    over[0::3] = n
    over[1::7] = n + 1 + torch.arange(len(range(1, n, 7)), dtype=torch.int32, device=dev)
    over[5] = 2 ** 31 - 1
    over[6] = -2 ** 31
    last = torch.full((n,), -1, dtype=torch.int32, device=dev)
    last[-LANE:] = torch.from_numpy(rng.permutation(n)[:LANE].astype(np.int32)).to(dev)
    return [("all -1", torch.full((n,), -1, dtype=torch.int32, device=dev)),
            ("identity", ident), ("at N and above", over), ("last row only", last)]


def check_maps(dev, rng) -> list:
    """(label, cols, map) of the check beyond the script's maps, at 16,200
    rows: ``edge_maps`` at C = 14, int32 words with NaN bit patterns
    (``nan_words``) on a packed map, the identity at C = 1, 3 and 17 (17
    runs as a chunk of 16 planes and one of 1), and 37 rows, which leave
    the last block's last three warps without a row."""
    def planes(c, rows=ROWS):
        return torch.from_numpy(rng.normal(size=(rows, c, LANE)).astype(np.float32)).to(dev)

    maps = dict(edge_maps(dev, rng))
    small = torch.from_numpy(rng.random(37 * LANE) < 0.15).to(dev)
    return ([(label, planes(C), idx) for label, idx in maps.items()]
            + [("int32 NaN bits", nan_words(dev, rng), occupancy_map(dev, 0.15, rng))]
            + [(f"identity C={c}", planes(c), maps["identity"]) for c in (1, 3, 17)]
            + [("37 rows", planes(C, 37), pack_indices(small))])


def check(dev: torch.device, out=print) -> dict:
    """The take equal to its plain version, bit for bit, at 16,200 rows x 14
    planes on the maps of every occupancy and on a scattered map, and on
    ``check_maps``."""
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.normal(size=(ROWS, C, LANE)).astype(np.float32)).to(dev)
    cases = [(f"occupancy {occ}", base, occupancy_map(dev, occ, rng)) for occ, _ in CASES]
    cases += [("scattered", base, scattered_map(dev, rng))] + check_maps(dev, rng)
    for label, cols, idx in cases:
        if not torch.equal(take_rm(cols, idx), take_rm_ref(cols, idx)):
            raise AssertionError(f"P10 {label}: kernel != plain version")
    out(f"probe_r21 check: ray-major take == plain version (bit-equal) on {len(cases)} maps: "
        f"{', '.join(label for label, _, _ in cases)}")
    return {"probe_take_rm": 0.0}


def timed(label: str, cols: torch.Tensor, idx: torch.Tensor) -> _timing.Timed:
    """The take's CUDA-event mean of 10 launches and its device time
    (``_timing.device_ms``), each held to the bound of ``take_work`` (a time
    under it raises); ``sector_bound_ms`` is the bound of ``sector_work``,
    printed and not enforced, since L2 can keep part of ``cols`` between
    back-to-back calls."""
    c = cols.shape[1]
    ms = _timing.events_ms(lambda: take_rm(cols, idx), 10)
    dev_ms = _timing.device_ms(lambda: take_rm(cols, idx))
    b_ms, by = _timing.bound(take_work(idx, c), 0.0)
    _timing.at_least_bound(ms, b_ms, f"probe_take_rm {label}")
    _timing.at_least_bound(dev_ms, b_ms, f"probe_take_rm {label} (device time)")
    sector_ms = _timing.bound(sector_work(idx, c), 0.0)[0]
    return _timing.Timed("probe_take_rm", label, ms, b_ms, by, one_block=False,
                         device_ms=dev_ms, sector_bound_ms=sector_ms)


def timed_text(t: _timing.Timed) -> str:
    """The events mean and device time, each over the sector bound."""
    return (f"ray-major take {t.ms:.4f} ms, device {t.device_ms:.5f} ms a launch (queued "
            f"launches); {t.bound_text()}; sector bound {t.sector_bound_ms:.6g} ms "
            f"({t.ms / t.sector_bound_ms:.3f}x, device {t.device_ms / t.sector_bound_ms:.3f}x)")


def table(dev: torch.device, out=print) -> List[_timing.Timed]:
    """The script's measurements on the card: the ray-major take at each
    occupancy beside the plane-major ``lane_take`` on the same data and
    maps, then on the scattered map (a line of its own); returns the timed
    ray-major takes at the script's occupancies."""
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.normal(size=(ROWS, C, LANE)).astype(np.float32)).to(dev)
    planes = base.permute(1, 0, 2).reshape(C, ROWS * LANE).contiguous()
    res = []
    for occ, wcap in CASES:
        idx = occupancy_map(dev, occ, rng)
        t = timed(f"occ={occ}", base, idx)
        pm_ms = _timing.events_ms(lambda: lane_take(planes, idx), 10)
        out(f"probe_r21 occ={occ:.3f} (the script's wcap {wcap}): {timed_text(t)}; "
            f"plane-major lane_take {pm_ms:.4f} ms")
        res.append(t)
    idx = scattered_map(dev, rng)
    out(f"probe_r21 scattered (5% -1, no band): {timed_text(timed('scattered', base, idx))}")
    return res


def main() -> None:
    dev = _timing.require_cuda()
    print(_timing.gpu_line())
    check(dev)
    table(dev)
    print(f"probe_r21 kernel: {resources()}")


if __name__ == "__main__":
    main()
