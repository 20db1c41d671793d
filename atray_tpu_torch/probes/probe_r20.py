"""Probes P6-P9 (``scripts/probe_r20.py``): what one step of a lane-routing
loop costs, piece by piece, with the trip count read at run time.

The TPU kernels route with the one-hot product ``blk . OH_r``,
``OH_r[k, l] = (k + r == rel[l])``, which is a gather:
``acc[c, l] += blk[c, rel[l] - r]`` where ``0 <= rel[l] - r < 128``. The
kernels of ``csrc/probe_route.cu`` compute that function directly, one block
of 128 lanes with the (14, 16, 128) window in shared memory:

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
INSTR_PER_GATHER_STEP = C  # a step in which any lane of the warp gathers: one add a distinct sum
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


def _gather_steps(rel, steps: int) -> np.ndarray:
    """(WARPS, steps) bool: whether any lane of the warp gathers at step r,
    that is has 0 <= rel - r < 128."""
    rel = _np(rel).astype(np.int64).reshape(WARPS, 32)
    diff = np.zeros((WARPS, steps + 1), np.int64)
    warp = np.repeat(np.arange(WARPS), 32)
    np.add.at(diff, (warp, np.clip(rel - (LANE - 1), 0, steps).reshape(-1)), 1)
    np.add.at(diff, (warp, np.clip(rel + 1, 0, steps).reshape(-1)), -1)
    return np.cumsum(diff[:, :steps], 1) > 0


def issue_instr(kernel: str, n: int, rel=None, idx=None, variant: str = "build+dot",
                unroll: int = 1, inner: int = 7, when_store: bool = False, carry6: bool = False,
                store_dyn: bool = False) -> List[int]:
    """Instructions each of the block's warps must issue in one launch of
    ``kernel`` (a counter name, P6-P9) at trip count ``n``, on ``rel`` (P6-P8)
    or ``idx`` (P9) and the flags: the float adds of distinct sums (14 on a
    warp-step in which any lane of the warp gathers, ``iota`` 1 a step,
    ``dot`` 14), P8's 14 stores a row with ``when_store`` and 14 doublings on
    its odd rows, its 6 carry operations a row with ``carry6``, and P9's 14
    stores a row with ``store_dyn``. A list of ``WARPS`` counts."""
    n = max(int(n), 0)
    if kernel in ("probe_route_loop", "probe_route_dyn"):
        steps = n * (unroll if kernel == "probe_route_loop" else 1)
        if kernel == "probe_route_loop" and variant != "build+dot":
            per = {"empty": 0, "iota": INSTR_PER_IOTA_STEP, "dot": INSTR_PER_DOT_STEP}[variant]
            return [steps * per] * WARPS
        return [int(c) * INSTR_PER_GATHER_STEP for c in _gather_steps(rel, steps).sum(1)]
    jj = np.arange(n)
    if kernel == "probe_route_nested":
        # gathering steps r < q of each warp, q = 0..7
        before = np.concatenate([np.zeros((WARPS, 1), np.int64),
                                 np.cumsum(_gather_steps(rel, 7), 1)], 1)
        q = np.clip(np.minimum(jj % 7 + 1, inner), 0, 7)
        per_row = INSTR_PER_ROW_STORE * when_store + INSTR_PER_CARRY_ROW * carry6
        rest = n * per_row + INSTR_PER_ODD_ROW * when_store * int((jj % 2).sum())
        return [int(before[w, q].sum()) * INSTR_PER_GATHER_STEP + rest for w in range(WARPS)]
    if kernel == "probe_route_bigread":
        idx = _np(idx)
        words = idx[(7 * jj) % idx.shape[0]].reshape(n, WARPS, 32)
        rows = ((words >= 0) & (words < LANE)).any(2).sum(0)
        return [int(r) * INSTR_PER_GATHER_STEP + n * INSTR_PER_ROW_STORE * store_dyn for r in rows]
    raise ValueError(f"no issue count for {kernel}")


def issue_bound_ms(instr: List[int]) -> float:
    """The issue-rate bound: the busiest warp's instructions over one
    scheduler's rate."""
    return _timing.issue_ms(max(instr))


def _gathers(rel: torch.Tensor, steps: int) -> int:
    """Lane-steps r < ``steps`` whose gather falls in the window: the adds
    the function needs, over 14."""
    r = rel.long().cpu()
    first = torch.clamp(r - (LANE - 1), min=0)
    last = torch.clamp(r, max=steps - 1)
    return int(torch.clamp(last - first + 1, min=0).sum())


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
    """The kernels' launch shape from the library: threads a block, P8's and
    P9's dynamic shared memory, and P9's index rows in flight."""
    shape = (ctypes.c_int * 4)()
    _build.check(_build.load().atray_probe_route_shape(shape), "atray_probe_route_shape")
    return {"threads": shape[0], "nested_smem": shape[1], "bigread_smem": shape[2],
            "depth": shape[3]}


def resources(kernel: str) -> str:
    """Threads, shared memory and ptxas's registers and spills of the
    instance that phase 14 reports: P8 with the store and the carries, P9
    with the store."""
    shape = launch_shape()
    if kernel == "probe_route_nested":
        smem, entry = shape["nested_smem"], "probe_route_nested_kernelILb1ELb1EE"
    else:
        smem, entry = shape["bigread_smem"], "probe_route_bigread_kernelILb1EE"
    extra = f", {shape['depth']} index rows in flight" if kernel == "probe_route_bigread" else ""
    return (f"{shape['threads']} threads, {smem} B shared memory{extra}, ptxas "
            f"{_timing.ptxas(entry)}")


NESTED_CHECK_ROWS = (0, 1, 2, 7, 8, OUTER_ROWS)
NESTED_CHECK_INNER = (1, 3, 7)


def check(dev: torch.device, out=print) -> dict:
    """Each kernel equal to its plain version (every step adds one selected
    term in the plain version's order): every loop variant and the dynamic
    row at the script's trip counts; the nested rows at 0, 1, 2, 7, 8 and
    the script's rows, inner 1, 3 and 7, each flag, with the script's rel
    and with rel below 136 so that their short loops gather (carries
    included); the big read at 0, 1, D - 1, D, D + 1 and the script's rows,
    D the rows in flight, on the script's table and on one of 5 rows (so
    that (7 jj) % rows wraps inside the queue), each flag, slab included."""
    win, rel = inputs(dev)
    for variant, unroll in LOOP_CASES:
        n = trips(dev, STEPS // unroll)
        _equal(route_loop(n, win, rel, variant, unroll),
               route_loop_ref(n, win, rel, variant, unroll), f"P6 {variant} x{unroll}")
    n = trips(dev, STEPS)
    _equal(route_dyn(n, win, rel), route_dyn_ref(n, win, rel), "P7")
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
    out(f"probe_r20 check: P6 {len(LOOP_CASES)} variants at {STEPS} steps, P7 at {STEPS}; P8 at "
        f"rows {NESTED_CHECK_ROWS}, inner {NESTED_CHECK_INNER}, both rel sets; P9 at rows "
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


def main() -> None:
    dev = _timing.require_cuda()
    print(_timing.gpu_line())
    check(dev)
    table(dev)


if __name__ == "__main__":
    main()
