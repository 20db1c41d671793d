"""Probes P4 and P5 (``scripts/probe_r19.py``): one block's product cost
against the contraction width K, and whether independent products overlap.

- ``dot_k`` (P4, ``_kern_k``): ``out = sum over reps of a . b`` with a
  (M, K), b (K, 128), K a multiple of 128 (the script's 128 to 4096);
- ``dot_indep`` (P5, ``_kern_indep``): four independent 128-deep products
  ``a[:, 128 j : 128 (j + 1)] . b[128 j : 128 (j + 1)]`` into four sums,
  added as ``acc0 + acc1 + acc2 + acc3`` at the end (a (M, 512), b (512, 128)).

Both run one block of ``csrc/probe_dot.cu``'s ``probe_dot_stream_kernel``
(b alone is 2 MiB at K = 4096): 128-deep slices of a and b stream on every
rep through a ring of three one-slice stages in shared memory (full and
empty mbarriers; a producer warp copies a's rows by cp.async and b's slice
by one bulk copy), eight consumer warps split each slice over K with a
register tile of M rows x 4 columns a lane and keep a carry each, and the
carries are summed at the end (P5: warp group j takes slice j, so group j's
carries are acc_j). The rep loop stays outermost and the product is formed
every rep in full float32 FFMA, so one SM's float32 rate bounds it
(``bound_ms * 132``); the stream it needs, 72.7 KB a slice from L2, moves in
0.39 us a slice with no FFMA (186 GB/s into one SM; ``PERF.md``, the P4/P5
ladder), under half the 0.9 us of FFMA at that bound.
``python -m atray_tpu_torch.probes.probe_r19`` prints the script's table on
the card: ns per product and per 128-slice for M = 14, 16 and each K, then
the four independent products, each line with the block's threads, shared
memory, registers and its time over the one-SM bound.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from atray_tpu_torch.kernels import _build
from atray_tpu_torch.probes import _timing
from atray_tpu_torch.probes.probe_r18 import (
    F32_ROWS, N, dot_f32, dot_ref, product_ref, product_work, resources, sum_err, timed)

REPS = 20_000
SLICE = 128
WIDTHS = (128, 256, 512, 1024, 2048, 4096)
INDEP_K = 4 * SLICE


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("a and b must be float32")
    k = a.shape[1] if a.dim() == 2 else -1
    if a.shape[0] not in F32_ROWS or k <= 0 or k % SLICE or b.shape != (k, N):
        raise ValueError(f"a must be (M in {F32_ROWS}, K), K a multiple of {SLICE}, "
                         f"and b (K, {N})")


def dot_k(a: torch.Tensor, b: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """P4: ``sum over reps of a . b`` over a K-wide contraction."""
    _check(a, b)
    return dot_f32(a, b, reps, 2, "probe_dot_k")


def dot_indep(a: torch.Tensor, b: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """P5: four independent 128-deep products per rep into four sums."""
    _check(a, b)
    if a.shape[1] != INDEP_K:
        raise ValueError(f"dot_indep contracts K = {INDEP_K}")
    if a.device.type == "cpu":
        return dot_indep_ref(a, b, reps)
    return dot_f32(a, b, reps, 3, "probe_dot_indep")


def dot_indep_ref(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """Plain version of P5: sum j gets ``reps`` additions of product j, and
    the four sums are added left to right."""
    _build.COUNTERS["probe_dot_indep"].plain_calls += 1
    accs = []
    for j in range(4):
        p = product_ref(a[:, j * SLICE:(j + 1) * SLICE], b[j * SLICE:(j + 1) * SLICE])
        acc = torch.zeros_like(p)
        for _ in range(reps):
            acc = acc + p
        accs.append(acc)
    return accs[0] + accs[1] + accs[2] + accs[3]


def dot_k_ref(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """Plain version of P4."""
    return dot_ref(a, b, reps, "probe_dot_k")


def inputs(dev, m: int, k: int, rng, density: float):
    """The script's operands: a normal, b 0/1 at ``density``, float32."""
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
    b = torch.from_numpy((rng.random((k, N)) < density).astype(np.float32)).to(dev)
    return a, b


def dense_inputs(dev, m: int, k: int, rng):
    """a and b both normal, float32: every product term counts."""
    a = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.normal(size=(k, N)).astype(np.float32)).to(dev)
    return a, b


# Summation depth of the final combine (warps, then groups) in the tolerance.
COMBINE_DEPTH = 16


def dense_tolerance(a: torch.Tensor, b: torch.Tensor, reps: int) -> torch.Tensor:
    """(M, 128) bound on |kernel - plain| for any b: ``(K + reps + 16)
    2^-23 reps sum_k |a[i, k] b[k, n]|``. Either side sums the reps K terms
    ``a[i, k] b[k, n]`` in a tree at most ``K + reps + 16`` deep (a share's
    chain, then the reps-long carry, then the combine; the plain version's
    product rounding adds one), so each lies within ``depth 2^-24`` times the
    sum of the terms' magnitudes of the exact value; the two orders differ by
    at most twice that."""
    k = a.shape[1]
    return (k + reps + COMBINE_DEPTH) * 2.0 ** -23 * reps * product_ref(a.abs(), b.abs())


def dense_err(got: torch.Tensor, want: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
              reps: int, what: str) -> tuple:
    """(max |got - want|, max of |got - want| over ``dense_tolerance``);
    raises where a difference exceeds its tolerance (at reps 0 any)."""
    diff = (got - want).abs()
    tol = dense_tolerance(a, b, reps)
    if bool((diff > tol).any()):
        raise AssertionError(f"{what}: kernel != plain version (max |diff| {float(diff.max())}, "
                             f"dense-b tolerance exceeded)")
    ratio = float((diff / tol).max()) if reps > 0 else 0.0
    return float(diff.max()), ratio


def check(dev: torch.device, reps: int = 8, out=print) -> dict:
    """Each kernel against its plain version, at reps 0, 1 and ``reps``.

    On the script's inputs (b 0/1) within rtol 1e-5, atol 1e-5 * reps: P4 at
    every M and K, P5. On a dense normal b within ``dense_tolerance`` (reps 1
    and ``reps``): P4 at M = 16, K = 512 and 4096, P5 at M = 14 and 16; a
    split-K or ring fault that drops or repeats a share breaks it. Returns
    the max |diff| of each kernel over all its cases."""
    rng = np.random.default_rng(0)
    cases = (0, 1, reps)
    err_k = 0.0
    for m in F32_ROWS:
        for k in WIDTHS:
            a, b = inputs(dev, m, k, rng, 1.0 / k)
            for r in cases:
                err_k = max(err_k, sum_err(dot_k(a, b, r), dot_k_ref(a, b, r), r,
                                          f"P4 M={m} K={k} reps={r}"))
    a, b = inputs(dev, 14, INDEP_K, rng, 0.002)
    err_i = max(sum_err(dot_indep(a, b, r), dot_indep_ref(a, b, r), r, f"P5 reps={r}")
                for r in cases)
    ratio = 0.0
    for name, fn, ref, m, k in (("P4", dot_k, dot_k_ref, 16, 512),
                                ("P4", dot_k, dot_k_ref, 16, 4096),
                                ("P5", dot_indep, dot_indep_ref, 14, INDEP_K),
                                ("P5", dot_indep, dot_indep_ref, 16, INDEP_K)):
        a, b = dense_inputs(dev, m, k, rng)
        for r in (1, reps):
            e, q = dense_err(fn(a, b, r), ref(a, b, r), a, b, r, f"{name} dense M={m} K={k} reps={r}")
            ratio = max(ratio, q)
            if name == "P4":
                err_k = max(err_k, e)
            else:
                err_i = max(err_i, e)
    out(f"probe_r19 check (reps {cases}): P4 max |diff| {err_k:.3g} over M={F32_ROWS} and "
        f"K={WIDTHS}, P5 {err_i:.3g} (b 0/1: rtol 1e-5, atol 1e-5 x reps; dense b at "
        f"{ratio:.3g} of its tolerance); {resources(14, 2, INDEP_K)}")
    return {"probe_dot_k": err_k, "probe_dot_indep": err_i}


def table(dev: torch.device, reps: int = REPS, out=print) -> List[_timing.Timed]:
    """The script's measurements on the card: P4 for M = 14, 16 and each K
    (ns per product and per 128-slice), then P5 at M = 14, K = 512; each
    line with its bound. Returns the timed variants."""
    rng = np.random.default_rng(0)
    res = []
    for m in F32_ROWS:
        for k in WIDTHS:
            a, b = inputs(dev, m, k, rng, 1.0 / k)
            t = timed("probe_dot_k", f"M={m} K={k}", lambda r: dot_k(a, b, r),
                      product_work(m, k, reps), reps)
            out(f"probe_r19 f32 M={m:2d} K={k:5d}: {t.ms * 1e6 / reps:9.1f} ns/dot "
                f"({t.ms * 1e6 / reps / (k // SLICE):7.1f} ns per 128-slice; {t.bound_text()}; "
                f"{_timing.over_one_sm(t):.3f}x the one-SM bound; {resources(m, 2, k)})")
            res.append(t)
    m = 14
    a, b = inputs(dev, m, INDEP_K, rng, 0.002)
    t = timed("probe_dot_indep", f"M={m} K={INDEP_K}", lambda r: dot_indep(a, b, r),
              product_work(m, SLICE, reps, products=4), reps)
    out(f"probe_r19 f32 M={m} 4 indep 128-dots: {t.ms * 1e6 / reps:9.1f} ns/iter "
        f"({t.ms * 1e6 / reps / 4:7.1f} ns per dot; {t.bound_text()}; "
        f"{_timing.over_one_sm(t):.3f}x the one-SM bound; {resources(m, 3, INDEP_K)})")
    res.append(t)
    return res


def main() -> None:
    dev = _timing.require_cuda()
    print(_timing.gpu_line())
    check(dev)
    table(dev)


if __name__ == "__main__":
    main()
