"""Helpers shared by the probes: the card check, its name and power limit,
CUDA-event timing, the bound of a measurement, and the launch of a probe
kernel with its count."""

from __future__ import annotations

import dataclasses
import subprocess
from typing import Callable, Tuple

import torch

from atray_tpu_torch.kernels import _build

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12        # float32 peak outside the tensor cores
BF16_OPS_PER_S = 989e12       # dense bf16 tensor-core peak
SMS = 132                     # streaming multiprocessors of the H100 SXM


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
    ``bound_ms * SMS``."""

    kernel: str
    label: str
    ms: float
    bound_ms: float
    bound_by: str
    one_block: bool

    def bound_text(self) -> str:
        text = f"bound {self.bound_ms:.6g} ms by {self.bound_by} (card)"
        if self.one_block:
            text += f", {self.bound_ms * SMS:.6g} ms (one SM)"
        return text


def over_one_sm(t: Timed) -> float:
    """A one-block measurement's time over its one-SM bound."""
    return t.ms / (t.bound_ms * SMS)


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
