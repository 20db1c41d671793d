"""Probes P4 and P5 (``scripts/probe_r19.py``): one block's product cost
against the contraction width K, and whether independent products overlap.

- ``dot_k`` (P4, ``_kern_k``): ``out = sum over reps of a . b`` with a
  (M, K), b (K, 128), K a multiple of 128 (the script's 128 to 4096);
- ``dot_indep`` (P5, ``_kern_indep``): four independent 128-deep products
  ``a[:, 128 j : 128 (j + 1)] . b[128 j : 128 (j + 1)]`` into four sums,
  added as ``acc0 + acc1 + acc2 + acc3`` at the end (a (M, 512), b (512, 128)).

Both stream 128-deep K-slices of a and b through a double-buffered ring in
one block of ``csrc/probe_dot.cu`` (b alone is 2 MiB at K = 4096), so the
cost per slice as K grows is the card's L2-to-SM rate against one SM's FFMA
rate. ``python -m atray_tpu_torch.probes.probe_r19`` prints the script's
table on the card: ns per product and per 128-slice for M = 14, 16 and each
K, then the four independent products.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from atray_tpu_torch.kernels import _build
from atray_tpu_torch.probes import _timing
from atray_tpu_torch.probes.probe_r18 import (
    F32_ROWS, N, dot_f32, dot_ref, product_ref, product_work, sum_err, timed)

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


def check(dev: torch.device, reps: int = 8, out=print) -> dict:
    """Each kernel against its plain version on the script's inputs, reps
    cut to ``reps``, within rtol 1e-5, atol 1e-5 * reps: P4 at every M and
    K, P5. Returns the max |diff| of each kernel."""
    rng = np.random.default_rng(0)
    err_k = 0.0
    for m in F32_ROWS:
        for k in WIDTHS:
            a, b = inputs(dev, m, k, rng, 1.0 / k)
            err_k = max(err_k, sum_err(dot_k(a, b, reps), dot_k_ref(a, b, reps), reps,
                                      f"P4 M={m} K={k}"))
    a, b = inputs(dev, 14, INDEP_K, rng, 0.002)
    err_i = sum_err(dot_indep(a, b, reps), dot_indep_ref(a, b, reps), reps, "P5")
    out(f"probe_r19 check ({reps} reps): P4 max |diff| {err_k:.3g} over M={F32_ROWS} and "
        f"K={WIDTHS}, P5 {err_i:.3g} (rtol 1e-5, atol 1e-5 x reps)")
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
                f"({t.ms * 1e6 / reps / (k // SLICE):7.1f} ns per 128-slice; {t.bound_text()})")
            res.append(t)
    m = 14
    a, b = inputs(dev, m, INDEP_K, rng, 0.002)
    t = timed("probe_dot_indep", f"M={m} K={INDEP_K}", lambda r: dot_indep(a, b, r),
              product_work(m, SLICE, reps, products=4), reps)
    out(f"probe_r19 f32 M={m} 4 indep 128-dots: {t.ms * 1e6 / reps:9.1f} ns/iter "
        f"({t.ms * 1e6 / reps / 4:7.1f} ns per dot; {t.bound_text()})")
    res.append(t)
    return res


def main() -> None:
    dev = _timing.require_cuda()
    print(_timing.gpu_line())
    check(dev)
    table(dev)


if __name__ == "__main__":
    main()
