"""Helpers shared by the probes: the card check, its name and power limit,
CUDA-event timing, the bound of a measurement, and the launch of a probe
kernel with its count."""

from __future__ import annotations

import dataclasses
import subprocess
from typing import Callable, Optional, Tuple

import torch

from atray_tpu_torch.kernels import _build

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12        # float32 peak outside the tensor cores
BF16_OPS_PER_S = 989e12       # dense bf16 tensor-core peak
SMS = 132                     # streaming multiprocessors of the H100 SXM
# float32 instructions at the issue rate: one a lane a clock, half the FMA
# peak (which counts an FMA as two operations), as chip_smoke.py counts them;
# one warp's scheduler issues a 4 x 32-lane share of an SM's
FP32_INSTR_PER_S = FP32_OPS_PER_S / 2
SCHEDULER_INSTR_PER_S = FP32_INSTR_PER_S / (SMS * 4 * 32)


def require_cuda() -> torch.device:
    """The card, or a RuntimeError: a probe measures the card and nothing else."""
    if not torch.cuda.is_available():
        raise RuntimeError("the probes run on a CUDA device; none is available")
    return torch.device("cuda", torch.cuda.current_device())


def gpu_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def events_ms(fn: Callable[[], object], reps: int = 1, warm: bool = True) -> float:
    """Mean ms of ``reps`` calls of ``fn`` between two CUDA events, after one
    untimed call if ``warm``."""
    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


HOLD_CYCLES = 20_000_000      # the spin that holds the card while calls queue: about 10 ms
DEVICE_REPS = 20              # calls that device_ms queues behind the spin
HOLD_TRIES = 3


def device_ms(fn: Callable[[], object]) -> float:
    """Mean device ms of one of ``DEVICE_REPS`` calls of ``fn`` (after one untimed
    call) queued behind a spin kernel, between CUDA events: the host
    queues every call while the card spins, so the card runs them back to
    back and the time holds none of the host's launch time, which a
    CUDA-event mean of a short kernel holds. It is the kernels' own time
    and the gaps between them, never less. Where the spin ended before the
    last call was queued the try is thrown away and the spin lengthened;
    raises after ``HOLD_TRIES``. (torch.profiler's mean of the same launches
    once read half of a kernel's time on the H100.)"""
    fn()
    torch.cuda.synchronize()
    cycles = HOLD_CYCLES
    for _ in range(HOLD_TRIES):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(DEVICE_REPS):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / DEVICE_REPS
        cycles *= 4
    raise RuntimeError(f"device_ms: the card ran the calls before the host had queued them all, "
                       f"{HOLD_TRIES} times")


def bound(nbytes: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> Tuple[float, str]:
    """(least ms on the whole card, "bytes" or "operations"): the larger of
    the bytes over the memory rate and the operations over their peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass
class Timed:
    """One timed variant of a probe: its kernel's counter name, the label
    the table prints, ms of one launch, and its bound on the whole card
    (``bound_ms`` by ``bound_by``); a one-block kernel's one-SM bound is
    ``bound_ms * SMS``, unless it has an issue-rate bound (``issue_bound_ms``:
    its busiest warp's instructions over one scheduler's rate), which
    replaces it. A take may add its device time (``device_ms``, of
    ``device_ms()``) and the bound of the sectors it must read
    (``sector_bound_ms``)."""

    kernel: str
    label: str
    ms: float
    bound_ms: float
    bound_by: str
    one_block: bool
    issue_bound_ms: Optional[float] = None
    device_ms: Optional[float] = None
    sector_bound_ms: Optional[float] = None

    def bound_text(self) -> str:
        text = f"bound {self.bound_ms:.6g} ms by {self.bound_by} (card)"
        if self.issue_bound_ms is not None:
            text += f", {self.issue_bound_ms:.6g} ms (issue rate, {over_issue_text(self)})"
        elif self.one_block:
            text += f", {self.bound_ms * SMS:.6g} ms (one SM)"
        return text


def over_one_sm(t: Timed) -> float:
    """A one-block measurement's time over its one-SM bound."""
    return t.ms / (t.bound_ms * SMS)


def issue_ms(instr: float) -> float:
    """ms for one warp's scheduler to issue ``instr`` instructions."""
    return instr / SCHEDULER_INSTR_PER_S * 1e3


def at_least_bound(ms: float, bound_ms: float, what: str) -> float:
    """``ms`` over ``bound_ms`` (inf where the bound is 0); raises where the
    time is under its bound: the compiler must then have removed work the
    function needs."""
    if ms < bound_ms:
        raise AssertionError(f"{what}: {ms:.6g} ms is under its bound of {bound_ms:.6g} ms; the "
                             f"compiler must have removed work the function needs")
    return ms / bound_ms if bound_ms > 0 else float("inf")


def over_issue_text(t: Timed) -> str:
    """"<time over the issue-rate bound>x", or why there is no ratio."""
    if not t.issue_bound_ms:
        return "no instruction to issue"
    return f"{t.ms / t.issue_bound_ms:.3f}x"


def ptxas(entry: str) -> str:
    """The ``-Xptxas -v`` stack frame and spills, and registers, of the first
    kernel whose mangled name contains ``entry``, from this process's build
    of the library."""
    lines = _build._loaded.log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and entry in line:
            frame = ""
            for nxt in lines[i + 1:]:
                if "stack frame" in nxt:
                    frame = nxt.strip() + "; "
                if "registers" in nxt:
                    return frame + nxt.split(":", 1)[-1].strip()
    return "not in this process's build log"


def launch(fn_name: str, counter: str, device: torch.device, *args) -> None:
    """Call C launcher ``fn_name`` with ``args`` and the current stream of
    ``device``, count the launch, and raise if CUDA refused it."""
    lib = _build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*args, stream)
    _build.COUNTERS[counter].launches += 1
    _build.check(rc, fn_name)


def check_device(*tensors: torch.Tensor) -> torch.device:
    """The one CPU or CUDA device of ``tensors``; they must be contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise TypeError("a probe's tensors must be on one device")
        if not t.is_contiguous():
            raise ValueError("a probe's tensors must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise TypeError(f"no probe kernel for device {dev}")
    return dev
