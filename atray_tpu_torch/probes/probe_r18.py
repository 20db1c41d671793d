"""Probes P1-P3 (``scripts/probe_r18.py``): what one block pays for a
(M, 128) x (128, 128) product, repeated ``reps`` times into a float32 sum.

- ``dot_t`` (P1, ``_kern_t``): ``out = sum over reps of a . b^T``, b
  contracted on its dim 1, as the scatter-style routing would use it;
- ``dot_n`` (P2, ``_kern_n``): ``out = sum over reps of a . b``;
- ``dot_bf16`` (P3, ``_kern_bf16``): as P2 with bf16 operands on the tensor
  cores, the sum in float32.

Each launches one block of ``csrc/probe_dot.cu`` on a CUDA tensor and runs
its plain version (``dot_ref``) on a CPU tensor. P1 and P2 share one kernel
(``probe_dot_resident_kernel``): 256 threads, eight warps splitting the
128-deep contraction 16 rows a warp, a lane holding all M rows x 4 adjacent
columns; P2 reads b's rows k, P1 reads b as stored, along its rows, from a
stage whose 16-byte chunks are permuted within each row so that a quarter
warp's eight row loads fall on distinct banks. The rep loop is outermost,
each rep forms the product from shared memory in full float32 FFMA, a warp
sums runs of 16 reps' partials before adding them to its carry in shared
memory (one carry a warp for every rep failed the check on these normal
inputs), and the carries meet in warp order at the end. One SM's float32
rate bounds it (``bound_ms * 132``); ``PERF.md``'s P1/P2 ladder has the
other shapes measured. P3 (``probe_dot_bf16_kernel<N>``) runs on
``wgmma``, which takes 64 rows of its A operand, so it computes the product
transposed, ``out^T = b^T . a^T``: b, staged as stored, is A (two 64-row
tiles read through the transpose bit, one for each of two warpgroups) and
a, padded with zero rows to N = M rounded up to 8, is B; each rep a
warpgroup's 8 ``wgmma`` form its tile of the product from zero and one
float32 add a value puts it on the carry. One SM's bf16 tensor rate bounds
it; ``PERF.md``'s P3 ladder has the other shapes measured. ``python -m
atray_tpu_torch.probes.probe_r18`` prints the script's table on the card:
ns per product of P2 and P1 at M = 14 and 16 and of P3 at M = 14 and 56,
each line with the block's threads, shared memory, registers and its time
over the one-SM bound.
"""

from __future__ import annotations

import ctypes
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
BF16_CHECK_ROWS = (1, 8, 14, 16, 17, 24, 32, 40, 48, 56, 64)   # every instance N, and its edges


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
    if reps < 0:
        raise ValueError("reps must be >= 0")
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


def permutation_b(dev, rng) -> torch.Tensor:
    """A bf16 (128, 128) permutation: one 1 in each column and each row, so
    that out's column n is a's column of that row, and a k or n mapping
    fault shows."""
    b = np.zeros((K, N), np.float32)
    b[rng.permutation(K), np.arange(N)] = 1.0
    return torch.from_numpy(b).to(torch.bfloat16).to(dev)


def timed(kernel: str, label: str, fn: Callable[[int], object], work, reps: int,
          ops_per_s=_timing.FP32_OPS_PER_S) -> _timing.Timed:
    """One launch of ``fn(reps)`` timed after a warm-up of two reps, with the
    bound of ``work`` (bytes, operations)."""
    fn(min(reps, 2))
    ms = _timing.events_ms(lambda: fn(reps), warm=False)
    b_ms, by = _timing.bound(work[0], work[1], ops_per_s)
    t = _timing.Timed(kernel, label, ms, b_ms, by, one_block=True)
    if _timing.over_one_sm(t) < 1.0:
        raise AssertionError(f"{kernel} {label}: {ms:.4f} ms is under its one-SM bound; the "
                             f"compiler must have moved work out of the rep loop")
    return t


def sum_err(got: torch.Tensor, want: torch.Tensor, reps: int, what: str) -> float:
    """Max |got - want|; raises beyond rtol 1e-5, atol 1e-5 * reps (the
    float32 sums are taken in another order)."""
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, rtol=1e-5, atol=1e-5 * max(reps, 1)):
        raise AssertionError(f"{what}: kernel != plain version (max |diff| {err})")
    return err


def check(dev: torch.device, reps: int = 64, out=print) -> dict:
    """Each kernel against its plain version on the script's inputs: P1 and
    P2 at M = 14 and 16 and reps 0, 1 and ``reps``, within rtol 1e-5, atol
    1e-5 * reps; P3 (0/1 operands) equal at reps 0, 1 and ``reps``, at every
    instance's M and its edges, with the script's b and a permutation b.
    Returns the max |diff| of each kernel."""
    errs = {"probe_dot_t": 0.0, "probe_dot_n": 0.0}
    cases = (0, 1, reps)
    for m in F32_ROWS:
        a, b = inputs(dev, m=m)
        for r in cases:
            for name, what, fn, trans in (("probe_dot_t", "P1", dot_t, True),
                                          ("probe_dot_n", "P2", dot_n, False)):
                want = dot_ref(a, b, r, name, transpose=trans)
                err = sum_err(fn(a, b, r), want, r, f"{what} M={m} reps={r}")
                errs[name] = max(errs[name], err)
    rng = np.random.default_rng(1)
    perm = permutation_b(dev, rng)
    for m in BF16_CHECK_ROWS:
        ha, hb = bf16_inputs(dev, m, rng)
        for what, b in (("b at density 0.01", hb), ("b a permutation", perm)):
            for r in cases:
                if not torch.equal(dot_bf16(ha, b, r), dot_ref(ha, b, r, "probe_dot_bf16")):
                    raise AssertionError(f"P3 M={m} reps={r} {what}: kernel != plain version")
    errs["probe_dot_bf16"] = 0.0
    out(f"probe_r18 check (P1, P2 at M={F32_ROWS}, reps {cases}): P1 max |diff| "
        f"{errs['probe_dot_t']:.3g}, P2 {errs['probe_dot_n']:.3g} (rtol 1e-5, atol 1e-5 x reps); "
        f"P3 equal at M={BF16_CHECK_ROWS}, reps {cases}, b at density 0.01 and a permutation")
    return errs


def launch_shape(m: int, variant: int) -> tuple:
    """(threads, dynamic shared memory bytes, ring stages) of a block of
    ``atray_probe_dot`` variant ``variant`` (0: P2, 1: P1, 2: P4, 3: P5) at
    ``m`` rows."""
    shape = (ctypes.c_int * 3)()
    _build.check(_build.load().atray_probe_dot_shape(m, variant, shape), "atray_probe_dot_shape")
    return shape[0], shape[1], shape[2]


def bf16_shape(m: int) -> tuple:
    """(threads, dynamic shared memory bytes, the instance's N) of P3's
    block at ``m`` rows."""
    shape = (ctypes.c_int * 3)()
    _build.check(_build.load().atray_probe_dot_bf16_shape(m, shape), "atray_probe_dot_bf16_shape")
    return shape[0], shape[1], shape[2]


def bf16_resources(m: int) -> str:
    """P3's threads, shared memory, and ptxas's registers and spills of the
    instance that ``m`` rows select."""
    threads, smem, n = bf16_shape(m)
    return (f"{threads} threads, {smem} B shared memory, wgmma m64n{n}k16, ptxas "
            f"{_timing.ptxas(f'probe_dot_bf16_kernelILi{n}EE')}")


def resources(m: int, variant: int, k: int = K) -> str:
    """The block's threads and shared memory, and ptxas's registers and
    spills, of ``atray_probe_dot`` variant ``variant`` at ``m`` rows and
    contraction ``k``: P2 (0) and P1 (1) one resident kernel each; P4 (2)
    and P5 (3) the stream kernel's instance for a ring refilled, or filled
    once where the slices fit the stages."""
    threads, smem, stages = launch_shape(m, variant)
    if variant in (0, 1):
        entry, what = f"probe_dot_resident_kernelILi{m}ELb{variant}EE", "operands resident"
    else:
        ring = k // K > stages
        entry = f"probe_dot_stream_kernelILi{m}ELi{1 if variant == 2 else 4}ELb{int(ring)}EE"
        what = "ring refilled" if ring else "ring filled once"
    return f"{threads} threads, {smem} B shared memory, {what}, ptxas {_timing.ptxas(entry)}"


def table(dev: torch.device, reps: int = REPS, out=print) -> List[_timing.Timed]:
    """The script's measurements on the card: ns per product of P2 and P1 at
    M = 14 and 16 and of P3 (M = 14, 56), each with its bound. Returns the
    timed variants."""
    res = []
    for m in F32_ROWS:
        a, b = inputs(dev, m=m)
        for kernel, name, fn, variant in (("probe_dot_n", "normal  (a . b)  ", dot_n, 0),
                                          ("probe_dot_t", "rhs-T   (a . b^T)", dot_t, 1)):
            t = timed(kernel, f"M={m}", lambda r, fn=fn: fn(a, b, r), product_work(m, K, reps),
                      reps)
            out(f"probe_r18 {name} M={m}: {t.ms * 1e6 / reps:8.1f} ns/dot ({t.ms:.4f} ms for "
                f"{reps} reps; {t.bound_text()}; {_timing.over_one_sm(t):.3f}x the one-SM bound; "
                f"{resources(m, variant)})")
            res.append(t)
    rng = np.random.default_rng(1)
    for m in BF16_ROWS:
        ha, hb = bf16_inputs(dev, m, rng)
        t = timed("probe_dot_bf16", f"M={m}", lambda r: dot_bf16(ha, hb, r),
                  product_work(m, K, reps, elem=2), reps, _timing.BF16_OPS_PER_S)
        out(f"probe_r18 bf16 M={m:3d} dot: {t.ms * 1e6 / reps:8.1f} ns/dot ({t.ms:.4f} ms; "
            f"{t.bound_text()}; {_timing.over_one_sm(t):.3f}x the one-SM bound; "
            f"{bf16_resources(m)})")
        res.append(t)
    return res


def main() -> None:
    dev = _timing.require_cuda()
    print(_timing.gpu_line())
    check(dev)
    table(dev)


if __name__ == "__main__":
    main()
