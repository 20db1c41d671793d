"""Probes P6-P9 (``scripts/probe_r20.py``): what one step of a lane-routing
loop costs, piece by piece, with the trip count read at run time.

The TPU kernels route with the one-hot product ``blk . OH_r``,
``OH_r[k, l] = (k + r == rel[l])``, which is a gather:
``acc[c, l] += blk[c, rel[l] - r]`` where ``0 <= rel[l] - r < 128``. The
kernels of ``csrc/probe_route.cu`` compute that function directly, one block
of 128 lanes, thread l owning lane l's 14 sums:

- ``route_loop`` (P6, ``make_kern(variant, unroll).kern``): ``n`` trips of
  ``unroll`` steps on a (14, 128) sum: ``empty``; ``iota`` (+1 each step);
  ``dot`` (+ window row 0, the product with the identity); ``build+dot``
  (+ the gather from window row 0);
- ``route_dyn`` (P7, ``_kern_dyn``): ``build+dot`` from window row ``r % 16``;
- ``route_nested`` (P8, ``_kern_nested``): outer rows ``jj < n`` of
  ``min(jj % 7 + 1, inner)`` steps each from zero; ``when_store`` writes the
  row's sum (twice it on odd rows), ``carry6`` carries six integers;
- ``route_bigread`` (P9, ``_kern_bigread``): per row ``jj`` the lane reads
  ``rel = idx[(7 jj) % rows]`` and gathers window row ``jj % 16`` at it;
  ``store_dyn`` also writes the sum to row ``(13 jj) % 450`` of half
  ``jj % 2`` of a (2, 14, 450, 128) slab in device memory.

P6 ``build+dot`` and P7 walk the window columns k = 127 ... 0 (step
r = rel - k, so increasing r), cut to the warp's lanes' ranges: at most 128
iterations, each lane adding only its own terms (the steps without one add
nothing, as the plain version's +0.0), from row 0 staged alone (P6) or the
window staged with row fastest (P7). ``iota`` sums 1.0 a step once for its
14 equal sums, in partial chains; ``dot`` keeps each lane's 14 words in
registers; ``empty`` stages the window and walks its trips.
P8 keeps each lane's gathered words in registers and stores every row
into a shared-memory out block that reaches ``out`` once, after the rows,
as the TPU's VMEM block did; each of its rows starts from a zero the
compilers cannot see, so that no row's sums are hoisted out of the row
loop. P9 keeps the index words of the next rows in flight in a per-lane
``cp.async`` ring. Each probe is timed against an issue-rate bound: the
instructions its busiest warp must issue (``issue_instr``) over one warp
scheduler's rate; a time under it raises.

``n`` is an int32 tensor of one element on the kernel's device. Each
wrapper launches its kernel on a CUDA tensor and runs its plain version on a
CPU tensor. ``python -m atray_tpu_torch.probes.probe_r20`` prints the
script's table on the card.
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np
import torch

from atray_tpu_torch.kernels import _build
from atray_tpu_torch.probes import _timing

C = 14
LANE = 128
WIN_ROWS = 16
STEPS = 16_384             # the loop probes' steps
OUTER_ROWS = 2_436         # the nested and big-read probes' outer rows
IDX_ROWS = 16_200          # rows of the big-read index table
SLAB_ROWS = 450
VARIANTS = ("empty", "iota", "dot", "build+dot")
LOOP_CASES = (("empty", 1), ("iota", 1), ("dot", 1), ("build+dot", 1), ("build+dot", 4),
              ("build+dot", 8))
WARPS = LANE // 32         # the block's warps, one to a scheduler
# Instructions a warp must issue, counted as chip_smoke.py counts
# INSTR_PER_TREELET: only what no compiler can remove.
INSTR_PER_TERM = C         # a lane's term: one add a distinct sum
INSTR_PER_IOTA_STEP = 1    # iota: the 14 sums are equal, so one add serves them all
INSTR_PER_DOT_STEP = C     # dot: every lane adds its own column, every step
INSTR_PER_ROW_STORE = C    # a row's 14 sums stored (P8 with when_store, P9 with store_dyn)
INSTR_PER_ODD_ROW = C      # P8 doubles an odd row's 14 sums before it stores them
INSTR_PER_CARRY_ROW = 6    # P8's six carries


def _check(n: torch.Tensor, win: torch.Tensor, rel: torch.Tensor = None) -> torch.device:
    tensors = (n, win) if rel is None else (n, win, rel)
    dev = _timing.check_device(*tensors)
    if n.dtype != torch.int32 or n.numel() != 1:
        raise TypeError("n must be an int32 tensor of one element")
    if win.dtype != torch.float32 or win.shape != (C, WIN_ROWS, LANE):
        raise TypeError(f"win must be a ({C}, {WIN_ROWS}, {LANE}) float32 tensor")
    if rel is not None and (rel.dtype != torch.int32 or rel.shape != (LANE,)):
        raise TypeError(f"rel must be a ({LANE},) int32 tensor")
    return dev


def _routed_sum(win: torch.Tensor, rel: torch.Tensor, steps: int, dynamic_row: bool):
    """Sum over steps r < ``steps`` of the gather ``win[:, row, rel - r]``
    where ``0 <= rel - r < 128`` (row 0, or ``r % 16`` if ``dynamic_row``),
    each lane's terms added in increasing r, as the kernels add them:
    k = rel - r runs from 127 down to 0."""
    acc = torch.zeros((C, LANE), dtype=torch.float32, device=win.device)
    rel = rel.long()
    for k in range(LANE - 1, -1, -1):
        r = rel - k
        ok = (r >= 0) & (r < steps)
        row = torch.remainder(r, WIN_ROWS) if dynamic_row else torch.zeros_like(r)
        acc = acc + torch.where(ok[None], win[:, row, k], 0.0)
    return acc


def route_loop_ref(n: torch.Tensor, win: torch.Tensor, rel: torch.Tensor, variant: str,
                   unroll: int) -> torch.Tensor:
    """Plain version of P6 over ``n * unroll`` steps."""
    _build.COUNTERS["probe_route_loop"].plain_calls += 1
    steps = int(n.reshape(-1)[0]) * unroll
    acc = torch.zeros((C, LANE), dtype=torch.float32, device=win.device)
    if variant == "iota":
        # 1.0 added ``steps`` times: exact below 2**24
        if steps >= 2 ** 24:
            raise ValueError("iota sums are exact only below 2**24 steps")
        acc += float(max(steps, 0))
    elif variant == "dot":
        for _ in range(steps):
            acc = acc + win[:, 0, :]
    elif variant == "build+dot":
        acc = _routed_sum(win, rel, steps, dynamic_row=False)
    return acc


def route_loop(n: torch.Tensor, win: torch.Tensor, rel: torch.Tensor, variant: str = "build+dot",
               unroll: int = 1) -> torch.Tensor:
    """P6: ``n`` trips of ``unroll`` steps of ``variant``; (14, 128) sum."""
    dev = _check(n, win, rel)
    if variant not in VARIANTS or unroll not in (1, 4, 8):
        raise ValueError(f"variant in {VARIANTS}, unroll in (1, 4, 8)")
    if dev.type == "cpu":
        return route_loop_ref(n, win, rel, variant, unroll)
    out = torch.empty((C, LANE), dtype=torch.float32, device=dev)
    _timing.launch("atray_probe_route_loop", "probe_route_loop", dev, n.data_ptr(), win.data_ptr(),
                   rel.data_ptr(), out.data_ptr(), VARIANTS.index(variant), unroll)
    return out


def route_dyn_ref(n: torch.Tensor, win: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """Plain version of P7."""
    _build.COUNTERS["probe_route_dyn"].plain_calls += 1
    return _routed_sum(win, rel, int(n.reshape(-1)[0]), dynamic_row=True)


def route_dyn(n: torch.Tensor, win: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """P7: ``n`` routing steps, step r gathering from window row r % 16."""
    dev = _check(n, win, rel)
    if dev.type == "cpu":
        return route_dyn_ref(n, win, rel)
    out = torch.empty((C, LANE), dtype=torch.float32, device=dev)
    _timing.launch("atray_probe_route_dyn", "probe_route_dyn", dev, n.data_ptr(), win.data_ptr(),
                   rel.data_ptr(), out.data_ptr())
    return out


def nested_carries(rows: int) -> List[int]:
    """The six int32 carries of P8 after ``rows`` outer rows."""
    a = b = c = d = e = f = 0
    for jj in range(rows):
        a, b, c, d, e, f = a + 1, b + jj, c ^ jj, d + 2, e + 3, f + jj % 3
    return [(x + 2 ** 31) % 2 ** 32 - 2 ** 31 for x in (a, b, c, d, e, f)]


def route_nested_ref(n: torch.Tensor, win: torch.Tensor, rel: torch.Tensor, inner: int,
                     when_store: bool, carry6: bool):
    """Plain version of P8: only the last row's store survives, so the output
    is that row's sum (twice it if the row is odd); zeros without
    ``when_store`` (the TPU kernel leaves it undefined)."""
    _build.COUNTERS["probe_route_nested"].plain_calls += 1
    rows = int(n.reshape(-1)[0])
    out = torch.zeros((C, LANE), dtype=torch.float32, device=win.device)
    carry = torch.zeros(6, dtype=torch.int32, device=win.device)
    if rows > 0 and when_store:
        jj = rows - 1
        out = _routed_sum(win, rel, min(jj % 7 + 1, inner), dynamic_row=True)
        if jj % 2:
            out = out * 2.0
    if carry6:
        carry = torch.tensor(nested_carries(rows), dtype=torch.int32, device=win.device)
    return out, carry


def route_nested(n: torch.Tensor, win: torch.Tensor, rel: torch.Tensor, inner: int = 7,
                 when_store: bool = True, carry6: bool = False):
    """P8: (out (14, 128), carries (6,) int32). Without ``when_store`` the
    kernel never writes ``out``, which stays zero; without ``carry6`` the
    carries stay zero."""
    dev = _check(n, win, rel)
    if dev.type == "cpu":
        return route_nested_ref(n, win, rel, inner, when_store, carry6)
    out = torch.zeros((C, LANE), dtype=torch.float32, device=dev)
    carry = torch.zeros(6, dtype=torch.int32, device=dev)
    _timing.launch("atray_probe_route_nested", "probe_route_nested", dev, n.data_ptr(),
                   win.data_ptr(), rel.data_ptr(), out.data_ptr(), carry.data_ptr(), int(inner),
                   int(bool(when_store)), int(bool(carry6)))
    return out, carry


def route_bigread_ref(n: torch.Tensor, idx: torch.Tensor, win: torch.Tensor, store_dyn: bool):
    """Plain version of P9, row by row."""
    _build.COUNTERS["probe_route_bigread"].plain_calls += 1
    rows = int(n.reshape(-1)[0])
    acc = torch.zeros((C, LANE), dtype=torch.float32, device=win.device)
    slab = torch.zeros((2, C, SLAB_ROWS, LANE), dtype=torch.float32, device=win.device)
    for jj in range(rows):
        rel = idx[(7 * jj) % idx.shape[0]].long()
        ok = (rel >= 0) & (rel < LANE)
        acc = acc + torch.where(ok[None], win[:, jj % WIN_ROWS, rel.clamp(0, LANE - 1)], 0.0)
        if store_dyn:
            slab[jj % 2, :, (13 * jj) % SLAB_ROWS] = acc
    return acc, slab


def route_bigread(n: torch.Tensor, idx: torch.Tensor, win: torch.Tensor, store_dyn: bool = False):
    """P9: (out (14, 128), slab (2, 14, 450, 128)); idx (rows, 128) int32
    with values in [0, 128). The slab stays zero without ``store_dyn``."""
    dev = _check(n, win)
    if idx.device != dev or idx.dtype != torch.int32 or idx.dim() != 2 or idx.shape[1] != LANE:
        raise TypeError(f"idx must be a (rows, {LANE}) int32 tensor on {dev}")
    if not idx.is_contiguous():
        raise ValueError("idx must be contiguous")
    if dev.type == "cpu":
        return route_bigread_ref(n, idx, win, store_dyn)
    out = torch.empty((C, LANE), dtype=torch.float32, device=dev)
    slab = torch.zeros((2, C, SLAB_ROWS, LANE), dtype=torch.float32, device=dev)
    _timing.launch("atray_probe_route_bigread", "probe_route_bigread", dev, n.data_ptr(),
                   idx.data_ptr(), idx.shape[0], win.data_ptr(), out.data_ptr(), slab.data_ptr(),
                   int(bool(store_dyn)))
    return out, slab


def inputs(dev, seed: int = 0):
    """The script's window (14, 16, 128) normal float32 and rel (128,) in [0, 2048)."""
    rng = np.random.default_rng(seed)
    win = torch.from_numpy(rng.normal(size=(C, WIN_ROWS, LANE)).astype(np.float32)).to(dev)
    rel = torch.from_numpy(rng.integers(0, 2048, size=(1, LANE)).astype(np.int32)[0]).to(dev)
    return win, rel


def bigread_idx(dev, seed: int = 0, rows: int = IDX_ROWS) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, LANE, size=(rows, LANE)).astype(np.int32)).to(dev)


def trips(dev, count: int) -> torch.Tensor:
    return torch.tensor([count], dtype=torch.int32, device=dev)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _lane_terms(rel, steps: int) -> np.ndarray:
    """(WARPS, 32) int: each lane's terms, the steps r < ``steps`` with
    0 <= rel - r < 128."""
    rel = _np(rel).astype(np.int64).reshape(WARPS, 32)
    first = np.maximum(rel - (LANE - 1), 0)
    last = np.minimum(rel, int(steps) - 1)
    return np.maximum(last - first + 1, 0)


def issue_instr(kernel: str, n: int, rel=None, idx=None, variant: str = "build+dot",
                unroll: int = 1, inner: int = 7, when_store: bool = False, carry6: bool = False,
                store_dyn: bool = False) -> List[int]:
    """Instructions each of the block's warps must issue in one launch of
    ``kernel`` (a counter name, P6-P9) at trip count ``n``, on ``rel`` (P6-P8)
    or ``idx`` (P9) and the flags: the float adds of distinct sums, P8's 14
    stores a row with ``when_store`` and 14 doublings on its odd rows, its 6
    carry operations a row with ``carry6``, and P9's 14 stores a row with
    ``store_dyn``. A list of ``WARPS`` counts.

    Lane l owns its 14 sums and one warp instruction serves all 32 lanes,
    so the routed adds (P6 ``build+dot``, P7, each P8 row, each P9 row) a
    warp needs are 14 x the most terms any one of its lanes adds: a walk
    over the window columns k = 127 ... 0 issues no more. 14 for every
    step on which any lane of the warp gathers would count a schedule that
    walks the steps, not a least count. ``iota`` needs 1 add a step (its 14
    sums are equal), ``dot`` 14 (each adds its word every step), ``empty``
    none."""
    n = max(int(n), 0)
    if kernel in ("probe_route_loop", "probe_route_dyn"):
        steps = n * (unroll if kernel == "probe_route_loop" else 1)
        if kernel == "probe_route_loop" and variant != "build+dot":
            per = {"empty": 0, "iota": INSTR_PER_IOTA_STEP, "dot": INSTR_PER_DOT_STEP}[variant]
            return [steps * per] * WARPS
        return [int(t) * INSTR_PER_TERM for t in _lane_terms(rel, steps).max(1)]
    jj = np.arange(n)
    if kernel == "probe_route_nested":
        # the most terms of any lane of each warp in a row of q steps, q = 0..7
        most = np.stack([_lane_terms(rel, q).max(1) for q in range(8)], 1)
        q = np.clip(np.minimum(jj % 7 + 1, inner), 0, 7)
        per_row = INSTR_PER_ROW_STORE * when_store + INSTR_PER_CARRY_ROW * carry6
        rest = n * per_row + INSTR_PER_ODD_ROW * when_store * int((jj % 2).sum())
        return [int(most[w, q].sum()) * INSTR_PER_TERM + rest for w in range(WARPS)]
    if kernel == "probe_route_bigread":
        # a lane has at most one term a row
        idx = _np(idx)
        words = idx[(7 * jj) % idx.shape[0]].reshape(n, WARPS, 32)
        rows = ((words >= 0) & (words < LANE)).any(2).sum(0)
        return [int(r) * INSTR_PER_TERM + n * INSTR_PER_ROW_STORE * store_dyn for r in rows]
    raise ValueError(f"no issue count for {kernel}")


def issue_bound_ms(instr: List[int]) -> float:
    """The issue-rate bound: the busiest warp's instructions over one
    scheduler's rate."""
    return _timing.issue_ms(max(instr))


def _gathers(rel, steps: int) -> int:
    """Lane-steps r < ``steps`` whose gather falls in the window: the adds
    the function needs, over 14."""
    return int(_lane_terms(rel, steps).sum())


def route_masks(rel: torch.Tensor, steps: int):
    """The 0/1 float32 matrices that make P6 ``build+dot`` and P7 one product
    each, the library yardstick: M6 (128, 128), M6[k, l] = (0 <= rel[l] - k
    < steps), for ``win[:, 0, :] @ M6``; M7 (2048, 128), M7[row * 128 + k, l]
    = M6[k, l] and (rel[l] - k) % 16 == row, for ``win.reshape(14, 2048) @
    M7``."""
    r = rel.long().view(1, LANE) - torch.arange(LANE, device=rel.device).view(LANE, 1)
    m6 = (r >= 0) & (r < steps)
    row = torch.arange(WIN_ROWS, device=rel.device).view(WIN_ROWS, 1, 1)
    m7 = (m6 & (torch.remainder(r, WIN_ROWS) == row)).reshape(WIN_ROWS * LANE, LANE)
    return m6.float(), m7.float()


# A float32 sum of n <= 128 terms, in any order, lies within
# (n - 1) u / (1 - (n - 1) u) < 128 u, u = 2^-24, times the sum of their
# magnitudes of the exact sum; the product's and the plain version's sums
# so lie within twice that of each other.
LIBRARY_TOL = 2 * LANE * 2.0 ** -24


def library_calls(win: torch.Tensor, rel: torch.Tensor, steps: int) -> dict:
    """Counter name -> the one ``torch.matmul`` call (float32, PyTorch's
    default of no TF32) that computes P6 ``build+dot`` or P7 at ``steps``,
    its masks built here, outside the call; each call's result is first held
    to the plain version within ``LIBRARY_TOL`` x the sum of the terms'
    magnitudes, else AssertionError."""
    m6, m7 = route_masks(rel, steps)
    row0, flat = win[:, 0, :], win.reshape(C, WIN_ROWS * LANE)
    calls = {"probe_route_loop": (lambda: torch.matmul(row0, m6), row0, m6, False),
             "probe_route_dyn": (lambda: torch.matmul(flat, m7), flat, m7, True)}
    for name, (call, a, m, dynamic_row) in calls.items():
        err = (call() - _routed_sum(win, rel, steps, dynamic_row)).abs()
        if (err > LIBRARY_TOL * torch.matmul(a.abs(), m)).any():
            raise AssertionError(f"{name}: the library product is not within its tolerance of the "
                                 f"plain version (max abs err {float(err.max()):.3g})")
    return {name: call for name, (call, *_) in calls.items()}


WIN_BYTES = C * WIN_ROWS * LANE * 4
OUT_BYTES = C * LANE * 4


def _timed(kernel, label, fn, nbytes, ops, instr, reps=5) -> _timing.Timed:
    """Mean ms of ``reps`` launches with the card bound of (``nbytes``,
    ``ops``) and the issue-rate bound of ``instr``; raises on a time under
    the issue-rate bound."""
    ms = _timing.events_ms(fn, reps)
    b_ms, by = _timing.bound(nbytes, ops)
    issue = issue_bound_ms(instr)
    _timing.at_least_bound(ms, issue, f"{kernel} {label} (issue rate)")
    return _timing.Timed(kernel, label, ms, b_ms, by, one_block=True, issue_bound_ms=issue)


def _equal(got, want, what: str) -> None:
    for x, y in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        if not torch.equal(x, y):
            raise AssertionError(f"{what}: kernel != plain version")


def launch_shape() -> dict:
    """The kernels' launch shape from the library: threads a block, the
    dynamic shared memory of P8 (with the store), P9, P6 build+dot and P7,
    and P9's index rows in flight."""
    shape = (ctypes.c_int * 6)()
    _build.check(_build.load().atray_probe_route_shape(shape), "atray_probe_route_shape")
    return {"threads": shape[0], "nested_smem": shape[1], "bigread_smem": shape[2],
            "depth": shape[3], "loop_smem": shape[4], "dyn_smem": shape[5]}


# counter name -> (its shared memory in launch_shape, the instance that
# phase 14 reports): P6 build+dot x1, P7, P8 with the store and the
# carries, P9 with the store
_REPORTED = {
    "probe_route_loop": ("loop_smem", "probe_route_loop_kernelILi3ELi1EE"),
    "probe_route_dyn": ("dyn_smem", "probe_route_dyn_kernel"),
    "probe_route_nested": ("nested_smem", "probe_route_nested_kernelILb1ELb1EE"),
    "probe_route_bigread": ("bigread_smem", "probe_route_bigread_kernelILb1EE"),
}


def resources(kernel: str) -> str:
    """Threads, shared memory and ptxas's registers and spills of the
    instance of ``kernel`` that phase 14 reports (``_REPORTED``)."""
    shape = launch_shape()
    smem, entry = _REPORTED[kernel]
    extra = f", {shape['depth']} index rows in flight" if kernel == "probe_route_bigread" else ""
    return (f"{shape['threads']} threads, {shape[smem]} B shared memory{extra}, ptxas "
            f"{_timing.ptxas(entry)}")


NESTED_CHECK_ROWS = (0, 1, 2, 7, 8, OUTER_ROWS)
NESTED_CHECK_INNER = (1, 3, 7)
ROUTE_CHECK_STEPS = (0, 1, LANE - 1, LANE, LANE + 1, STEPS)


def route_rel_sets(rel: torch.Tensor, steps: int) -> dict:
    """The rel sets of the P6 and P7 check at ``steps`` steps: the script's;
    rel % 136 (most lanes in the window); every lane at 127 or more (a
    lane's whole window once the steps reach it); all lanes equal (one
    range for the warp); every lane at or past the step count, lane 0 at
    it (terms from k = rel - steps + 1, or none)."""
    past = steps + torch.remainder(rel, 136)
    past[0] = steps
    return {"script": rel, "rel % 136": torch.remainder(rel, 136),
            "127 + rel % 64": LANE - 1 + torch.remainder(rel, 64),
            "all 100": torch.full_like(rel, 100), "at or past the steps": past}


def loop_trips(steps: int, unroll: int) -> List[int]:
    """Trip counts whose n x ``unroll`` is ``steps`` rounded down and up."""
    return sorted({steps // unroll, -(-steps // unroll)})


def check_routes(dev: torch.device, win: torch.Tensor, rel: torch.Tensor) -> int:
    """Every P6 variant and P7 equal to its plain version at n x unroll in
    ``ROUTE_CHECK_STEPS`` (rounded to a multiple of unroll) on each of
    ``route_rel_sets``; the number of cases. The plain iota, dot and empty
    do not read rel, so each is taken once a trip count."""
    cases = 0
    for steps in ROUTE_CHECK_STEPS:
        for variant, unroll in LOOP_CASES:
            for count in loop_trips(steps, unroll):
                n = trips(dev, count)
                want = None
                for name, r in route_rel_sets(rel, count * unroll).items():
                    if want is None or variant == "build+dot":
                        want = route_loop_ref(n, win, r, variant, unroll)
                    _equal(route_loop(n, win, r, variant, unroll), want,
                           f"P6 {variant} x{unroll} n={count} rel {name}")
                    cases += 1
        n = trips(dev, steps)
        for name, r in route_rel_sets(rel, steps).items():
            _equal(route_dyn(n, win, r), route_dyn_ref(n, win, r), f"P7 n={steps} rel {name}")
            cases += 1
    return cases


def check(dev: torch.device, out=print) -> dict:
    """Each kernel equal to its plain version (every step adds one selected
    term in the plain version's order): every loop variant and the dynamic
    row (``check_routes``); the nested rows at 0, 1, 2, 7, 8 and the
    script's rows, inner 1, 3 and 7, each flag, with the script's rel and
    with rel below 136 so that their short loops gather (carries included);
    the big read at 0, 1, D - 1, D, D + 1 and the script's rows, D the rows
    in flight, on the script's table and on one of 5 rows (so that
    (7 jj) % rows wraps inside the queue), each flag, slab included."""
    win, rel = inputs(dev)
    route_cases = check_routes(dev, win, rel)
    # P6 build+dot and P7 stage the window by 16-byte loads: a window off
    # that boundary is refused, not read
    off = torch.zeros(win.numel() + 1, dtype=win.dtype, device=dev)[1:].view(win.shape)
    for name, call in (("P6", lambda: route_loop(trips(dev, 1), off, rel)),
                       ("P7", lambda: route_dyn(trips(dev, 1), off, rel))):
        try:
            call()
        except RuntimeError:
            continue
        raise AssertionError(f"{name}: a window off a 16-byte boundary was not refused")
    for r in (rel, torch.remainder(rel, 136)):
        for rows in NESTED_CHECK_ROWS:
            n = trips(dev, rows)
            for inner in NESTED_CHECK_INNER:
                for ws in (False, True):
                    for c6 in (False, True):
                        _equal(route_nested(n, win, r, inner, ws, c6),
                               route_nested_ref(n, win, r, inner, ws, c6),
                               f"P8 rows={rows} inner={inner} when_store={ws} carry6={c6}")
    depth = launch_shape()["depth"]
    big_rows = (0, 1, depth - 1, depth, depth + 1, OUTER_ROWS)
    for idx in (bigread_idx(dev), bigread_idx(dev, rows=5)):
        for rows in big_rows:
            n = trips(dev, rows)
            for sd in (False, True):
                _equal(route_bigread(n, idx, win, sd), route_bigread_ref(n, idx, win, sd),
                       f"P9 idx rows={idx.shape[0]} rows={rows} store_dyn={sd}")
    out(f"probe_r20 check: P6 {len(LOOP_CASES)} variants and P7 at n x unroll near "
        f"{ROUTE_CHECK_STEPS} on {len(route_rel_sets(rel, 0))} rel sets ({route_cases} cases); P8 "
        f"at rows {NESTED_CHECK_ROWS}, inner {NESTED_CHECK_INNER}, both rel sets; P9 at rows "
        f"{big_rows} ({depth} in flight), idx of {IDX_ROWS} and 5 rows; every flag: kernel == "
        f"plain version (bit-equal)")
    return {k: 0.0 for k in ("probe_route_loop", "probe_route_dyn", "probe_route_nested",
                             "probe_route_bigread")}


def table(dev: torch.device, out=print) -> List[_timing.Timed]:
    """The script's measurements on the card, each with its bounds: the loop
    variants (ms, ns per step and per trip), the dynamic-row step, the
    nested rows (inner 7, each store and carry flag), the big read (each
    store flag). The card bound counts the adds the function needs; the
    issue-rate bound the busiest warp's instructions (``issue_instr``), and
    a time under it raises."""
    win, rel = inputs(dev)
    res = []
    io = WIN_BYTES + LANE * 4 + OUT_BYTES

    def busiest(instr):
        return f"busiest warp {max(instr)} instructions"

    for variant, unroll in LOOP_CASES:
        n = trips(dev, STEPS // unroll)
        adds = {"empty": 0, "iota": STEPS * C * LANE, "dot": STEPS * C * LANE,
                "build+dot": _gathers(rel, STEPS) * C}[variant]
        instr = issue_instr("probe_route_loop", STEPS // unroll, rel, variant=variant,
                            unroll=unroll)
        t = _timed("probe_route_loop", f"{variant} x{unroll}",
                   lambda n=n, v=variant, u=unroll: route_loop(n, win, rel, v, u), io, adds, instr)
        out(f"probe_r20 {variant:10s} x{unroll}: {t.ms:8.3f} ms total, "
            f"{t.ms * 1e6 / STEPS:8.1f} ns per STEP, {t.ms * 1e6 / (STEPS // unroll):8.1f} ns per "
            f"ITERATION ({t.bound_text()}; {busiest(instr)})")
        res.append(t)
    n = trips(dev, STEPS)
    instr = issue_instr("probe_route_dyn", STEPS, rel)
    t = _timed("probe_route_dyn", "dyn", lambda: route_dyn(n, win, rel), io,
               _gathers(rel, STEPS) * C, instr)
    out(f"probe_r20 dyn-read+build+dot x1: {t.ms * 1e6 / STEPS:8.1f} ns per step ({t.ms:.4f} ms; "
        f"{t.bound_text()}; {busiest(instr)})")
    res.append(t)
    n = trips(dev, OUTER_ROWS)
    inner = 7
    gathers = sum(_gathers(rel, min(jj % 7 + 1, inner)) for jj in range(OUTER_ROWS))
    for ws in (False, True):
        for c6 in (False, True):
            label = f"inner<={inner} when_store={int(ws)} carry6={int(c6)}"
            instr = issue_instr("probe_route_nested", OUTER_ROWS, rel, inner=inner, when_store=ws,
                                carry6=c6)
            t = _timed("probe_route_nested", label,
                       lambda ws=ws, c6=c6: route_nested(n, win, rel, inner, ws, c6), io,
                       gathers * C, instr)
            out(f"probe_r20 nested {label}: "
                f"{t.ms:7.3f} ms = {t.ms * 1e6 / OUTER_ROWS:8.1f} ns per OUTER row "
                f"({t.bound_text()}; {busiest(instr)})")
            res.append(t)
    idx = bigread_idx(dev)
    for sd in (False, True):
        slab_rows = len({(jj % 2, (13 * jj) % SLAB_ROWS) for jj in range(OUTER_ROWS)}) if sd else 0
        nbytes = WIN_BYTES + OUTER_ROWS * LANE * 4 + OUT_BYTES + slab_rows * C * LANE * 4
        instr = issue_instr("probe_route_bigread", OUTER_ROWS, idx=idx, store_dyn=sd)
        t = _timed("probe_route_bigread", f"store_dyn={int(sd)}",
                   lambda sd=sd: route_bigread(n, idx, win, sd), nbytes, OUTER_ROWS * LANE * C,
                   instr)
        out(f"probe_r20 bigread store_dyn={int(sd)}: {t.ms:7.3f} ms = "
            f"{t.ms * 1e6 / OUTER_ROWS:8.1f} ns per row ({t.bound_text()}; {busiest(instr)})")
        res.append(t)
    return res


def device_table(dev: torch.device, out=print) -> dict:
    """(counter name, label) -> the device ms of one launch of each P6
    variant and of P7 at the script's shapes, from launches queued behind
    a spin (``_timing.device_ms``), each against its issue-rate bound (a
    time under it raises). ``table``'s CUDA-event mean of a launch of a few
    microseconds is the wrapper's host time; this is the kernel's own. Its
    launches are not ``table``'s."""
    win, rel = inputs(dev)
    cases = [("probe_route_loop", f"{v} x{u}", STEPS // u,
              lambda v=v, u=u, n=trips(dev, STEPS // u): route_loop(n, win, rel, v, u),
              {"variant": v, "unroll": u}) for v, u in LOOP_CASES]
    n = trips(dev, STEPS)
    cases.append(("probe_route_dyn", "dyn", STEPS, lambda: route_dyn(n, win, rel), {}))
    res = {}
    for kernel, label, count, fn, kw in cases:
        ms = _timing.device_ms(fn)
        bound = issue_bound_ms(issue_instr(kernel, count, rel, **kw))
        _timing.at_least_bound(ms, bound, f"{kernel} {label} (issue rate, device time)")
        res[(kernel, label)] = ms
        out(f"probe_r20 device time {kernel} {label}: {ms * 1e3:.2f} us a launch (queued launches; "
            f"issue-rate bound {bound * 1e3:.3f} us)")
    return res


def main() -> None:
    dev = _timing.require_cuda()
    print(_timing.gpu_line())
    check(dev)
    table(dev)
    device_table(dev)


if __name__ == "__main__":
    main()
