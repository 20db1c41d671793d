"""Probes P1-P3 (``scripts/probe_r18.py``): what one block pays for a
(M, 128) x (128, 128) product, repeated ``reps`` times into a float32 sum.

- ``dot_t`` (P1, ``_kern_t``): ``out = sum over reps of a . b^T``, b
  contracted on its dim 1, as the scatter-style routing would use it;
- ``dot_n`` (P2, ``_kern_n``): ``out = sum over reps of a . b``;
- ``dot_bf16`` (P3, ``_kern_bf16``): as P2 with bf16 operands on the tensor
  cores, the sum in float32.

Each launches one block of ``csrc/probe_dot.cu`` on a CUDA tensor and runs
its plain version (``dot_ref``) on a CPU tensor. ``python -m
atray_tpu_torch.probes.probe_r18`` prints the script's table on the card:
ns per product of P2 and P1, and of P3 at M = 14 and 56.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from atray_tpu_torch.kernels import _build
from atray_tpu_torch.probes import _timing

REPS = 20_000
K = 128
N = 128
F32_ROWS = (14, 16)        # the kernel's float32 row counts
BF16_ROWS = (14, 56)       # the script's bf16 row counts


def product_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b in float32 as elementwise products summed over the contraction."""
    return (a.float()[:, :, None] * b.float()[None]).sum(1)


def dot_ref(a: torch.Tensor, b: torch.Tensor, reps: int, counter: str = "probe_dot_n",
            transpose: bool = False) -> torch.Tensor:
    """Plain version of P1-P4: ``reps`` float32 additions of the product
    ``a . b`` (``a . b^T`` with ``transpose``) to a zero sum. The product is
    the same every rep, so it is formed once."""
    _build.COUNTERS[counter].plain_calls += 1
    p = product_ref(a, b.t() if transpose else b)
    acc = torch.zeros_like(p)
    for _ in range(reps):
        acc = acc + p
    return acc


def _check_f32(a: torch.Tensor, b: torch.Tensor, k: int) -> None:
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError("a and b must be float32")
    if a.dim() != 2 or a.shape[0] not in F32_ROWS or a.shape[1] != k or b.shape != (k, N):
        raise ValueError(f"a must be (M in {F32_ROWS}, {k}) and b ({k}, {N})")


def dot_f32(a: torch.Tensor, b: torch.Tensor, reps: int, variant: int, counter: str,
            transpose: bool = False) -> torch.Tensor:
    """One block of ``atray_probe_dot`` (variant 0: P2, 1: P1, 2: P4, 3: P5)
    on a CUDA tensor; the plain version on a CPU tensor."""
    if reps < 0:
        raise ValueError("reps must be >= 0")
    dev = _timing.check_device(a, b)
    if dev.type == "cpu":
        return dot_ref(a, b, reps, counter, transpose)
    out = torch.empty((a.shape[0], N), dtype=torch.float32, device=dev)
    _timing.launch("atray_probe_dot", counter, dev, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                   a.shape[0], a.shape[1], reps, variant)
    return out


def dot_t(a: torch.Tensor, b: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """P1: ``sum over reps of a . b^T``, a (M, 128) and b (128, 128) float32."""
    _check_f32(a, b, K)
    return dot_f32(a, b, reps, 1, "probe_dot_t", transpose=True)


def dot_n(a: torch.Tensor, b: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """P2: ``sum over reps of a . b``, a (M, 128) and b (128, 128) float32."""
    _check_f32(a, b, K)
    return dot_f32(a, b, reps, 0, "probe_dot_n")


def dot_bf16(a: torch.Tensor, b: torch.Tensor, reps: int = REPS) -> torch.Tensor:
    """P3: ``sum over reps of a . b`` with bf16 a (M, 128), M <= 64, and b
    (128, 128), products and sum in float32 (tensor cores on the card)."""
    dev = _timing.check_device(a, b)
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError("a and b must be bfloat16")
    if a.dim() != 2 or not 1 <= a.shape[0] <= 64 or a.shape[1] != K or b.shape != (K, N):
        raise ValueError("a must be (M <= 64, 128) and b (128, 128)")
    if dev.type == "cpu":
        return dot_ref(a, b, reps, "probe_dot_bf16")
    out = torch.empty((a.shape[0], N), dtype=torch.float32, device=dev)
    _timing.launch("atray_probe_dot_bf16", "probe_dot_bf16", dev, a.data_ptr(), b.data_ptr(),
                   out.data_ptr(), a.shape[0], reps)
    return out


def product_work(m: int, k: int, reps: int, products: int = 1, elem: int = 4):
    """(bytes, operations) the function needs: a and b read once, out
    written once; 2 m k 128 operations a product, ``products`` a rep."""
    return (elem * (m * k * products + k * products * N) + 4 * m * N,
            2.0 * m * k * N * products * reps)


def inputs(dev, seed: int = 0, m: int = 14):
    """The script's f32 operands: a and b normal, float32."""
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(size=(m, K)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)).to(dev)
    return a, b


def bf16_inputs(dev, m: int, rng) -> tuple:
    """The script's bf16 operands: a normal, b 0/1 at density 0.01."""
    a = torch.from_numpy(rng.normal(size=(m, K)).astype(np.float32)).to(torch.bfloat16).to(dev)
    b = torch.from_numpy((rng.random((K, N)) < 0.01).astype(np.float32)).to(torch.bfloat16).to(dev)
    return a, b


def timed(kernel: str, label: str, fn: Callable[[int], object], work, reps: int,
          ops_per_s=_timing.FP32_OPS_PER_S) -> _timing.Timed:
    """One launch of ``fn(reps)`` timed after a warm-up of two reps, with the
    bound of ``work`` (bytes, operations)."""
    fn(min(reps, 2))
    ms = _timing.events_ms(lambda: fn(reps), warm=False)
    b_ms, by = _timing.bound(work[0], work[1], ops_per_s)
    return _timing.Timed(kernel, label, ms, b_ms, by, one_block=True)


def sum_err(got: torch.Tensor, want: torch.Tensor, reps: int, what: str) -> float:
    """Max |got - want|; raises beyond rtol 1e-5, atol 1e-5 * reps (the
    float32 sums are taken in another order)."""
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5 * max(reps, 1)):
        raise AssertionError(f"{what}: kernel != plain version (max |diff| {err})")
    return err


def check(dev: torch.device, reps: int = 64, out=print) -> dict:
    """Each kernel against its plain version on the script's inputs, reps
    cut to ``reps``: P1 and P2 within rtol 1e-5, atol 1e-5 * reps, P3 (0/1
    operands) equal. Returns the max |diff| of each kernel."""
    a, b = inputs(dev)
    want_t = dot_ref(a, b, reps, "probe_dot_t", transpose=True)
    errs = {"probe_dot_t": sum_err(dot_t(a, b, reps), want_t, reps, "P1"),
            "probe_dot_n": sum_err(dot_n(a, b, reps), dot_ref(a, b, reps), reps, "P2")}
    rng = np.random.default_rng(1)
    for m in BF16_ROWS:
        ha, hb = bf16_inputs(dev, m, rng)
        if not torch.equal(dot_bf16(ha, hb, reps), dot_ref(ha, hb, reps, "probe_dot_bf16")):
            raise AssertionError(f"P3 M={m}: kernel != plain version")
    errs["probe_dot_bf16"] = 0.0
    out(f"probe_r18 check ({reps} reps): P1 max |diff| {errs['probe_dot_t']:.3g}, P2 "
        f"{errs['probe_dot_n']:.3g} (rtol 1e-5, atol 1e-5 x reps), P3 M={BF16_ROWS} equal")
    return errs


def table(dev: torch.device, reps: int = REPS, out=print) -> List[_timing.Timed]:
    """The script's measurements on the card: ns per product of P2, P1 and
    P3 (M = 14, 56), each with its bound. Returns the timed variants."""
    a, b = inputs(dev)
    res = []
    for kernel, name, fn in (("probe_dot_n", "normal  (a . b)  ", dot_n),
                             ("probe_dot_t", "rhs-T   (a . b^T)", dot_t)):
        t = timed(kernel, "M=14", lambda r, fn=fn: fn(a, b, r), product_work(14, K, reps), reps)
        out(f"probe_r18 {name}: {t.ms * 1e6 / reps:8.1f} ns/dot ({t.ms:.4f} ms for {reps} reps; "
            f"{t.bound_text()})")
        res.append(t)
    rng = np.random.default_rng(1)
    for m in BF16_ROWS:
        ha, hb = bf16_inputs(dev, m, rng)
        t = timed("probe_dot_bf16", f"M={m}", lambda r: dot_bf16(ha, hb, r),
                  product_work(m, K, reps, elem=2), reps, _timing.BF16_OPS_PER_S)
        out(f"probe_r18 bf16 M={m:3d} dot: {t.ms * 1e6 / reps:8.1f} ns/dot ({t.ms:.4f} ms; "
            f"{t.bound_text()})")
        res.append(t)
    return res


def main() -> None:
    dev = _timing.require_cuda()
    print(_timing.gpu_line())
    check(dev)
    table(dev)


if __name__ == "__main__":
    main()
