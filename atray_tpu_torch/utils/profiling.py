"""Phase timers and device traces (``atray_tpu/utils/profiling.py``).

- ``Phase("name")``: a wall-clock timer of one named phase, every run kept
  in a process-wide registry (load, build, render, backward ...), and a
  ``torch.profiler.record_function`` range of the same name, so phases show
  in device traces. With ``block=True`` the phase ends with
  ``torch.cuda.synchronize()``, so the card's work inside it is counted.
- ``phase_stats``, ``phase_report`` and ``metrics_json``: the end-of-run
  table and its JSON form.
- ``trace_to(dir)``: a ``torch.profiler`` trace of the block, written to
  ``dir`` for TensorBoard or Perfetto.
"""

from __future__ import annotations

import contextlib
import json
import time
from typing import Dict, List, Optional

import torch

_REGISTRY: Dict[str, List[float]] = {}


class Phase:
    """Context manager timing one named phase; re-enterable, every run is
    recorded."""

    def __init__(self, name: str, block: bool = False):
        self.name = name
        self.block = block
        self._t0 = 0.0
        self.seconds = 0.0    # the last run's time
        self._range = None

    def __enter__(self):
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.block and torch.cuda.is_available():
            torch.cuda.synchronize()
        self.seconds = time.perf_counter() - self._t0
        _REGISTRY.setdefault(self.name, []).append(self.seconds)
        self._range.__exit__(*exc)
        return False


def reset_phases() -> None:
    _REGISTRY.clear()


def phase_stats() -> Dict[str, Dict[str, float]]:
    """Per phase: runs, total, mean, min and max seconds."""
    return {name: {"runs": len(runs), "total_s": sum(runs), "mean_s": sum(runs) / len(runs),
                   "min_s": min(runs), "max_s": max(runs)}
            for name, runs in _REGISTRY.items()}


def phase_report(rays: Optional[int] = None, file=None) -> str:
    """Printable table of every phase; with ``rays``, a last line of rays/s
    over the best 'render' phase."""
    stats = phase_stats()
    lines = [f"{'phase':<24}{'runs':>6}{'total':>12}{'mean':>12}"]
    for name, s in sorted(stats.items()):
        lines.append(f"{name:<24}{s['runs']:>6}{s['total_s']:>11.3f}s{s['mean_s']:>11.3f}s")
    if rays is not None and "render" in stats:
        lines.append(f"{'rays/s (best render)':<24}{rays / stats['render']['min_s']:>18.3e}")
    text = "\n".join(lines)
    if file is not None:
        print(text, file=file)
    return text


def metrics_json(extra: Optional[dict] = None) -> str:
    """One JSON line: the phase stats and ``extra``."""
    payload = {"phases": phase_stats()}
    if extra:
        payload.update(extra)
    return json.dumps(payload)


@contextlib.contextmanager
def trace_to(log_dir: str):
    """A ``torch.profiler`` trace of the block (the CPU, and the card where
    there is one), written to ``log_dir`` as a TensorBoard trace; yields
    the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof
