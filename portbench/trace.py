"""The traced sub-window: a few units of the cell's loop under
``torch.profiler`` (CPU and CUDA activities), reduced to what the
per-layer metrics read.

The profiler can lose the records of a window's first device events and
at times of its last, so the window is padded with short spin kernels of
our own before and after, which are left out (frozen from
``chip_smoke.py::_profiled_kernels``). The sub-window is the span
``portbench.window`` that the harness opens around the units; its device
events are clipped to it. A driver marks each unit's end on the host
(``mark_unit``), once the unit's device work has been read back, so the
first launch of a kernel after a mark is the next unit's first.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Tuple

import numpy as np

from portbench.common import ROOT

EDGE = "spin_kernel"
EDGE_LEAD = 256
EDGE_TAIL = 16
SPAN = "portbench.window"
UNIT = "portbench.unit_end"
GAPS_NAMED = 100     # the longest idle gaps whose host op is looked up


def port_kernels() -> Tuple[str, ...]:
    """The names of the program's own CUDA kernels, read from its sources."""
    names = set()
    for path in glob.glob(os.path.join(ROOT, "atray_tpu_torch", "csrc", "*.cu")):
        with open(path) as fh:
            src = fh.read()
        for m in re.finditer(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)", src):
            names.add(m.group(1))
    return tuple(sorted(names))


def kernel_of(name: str, own: Tuple[str, ...]):
    """The program's kernel an event's name belongs to, or None."""
    return next((k for k in own if re.search(rf"\b{k}\b", name)), None)


def mark_unit() -> None:
    """Mark a unit's end in the profile (nothing where none is taken)."""
    from torch.profiler import record_function

    with record_function(UNIT):
        pass


def profiled(run_units):
    """Run ``run_units()`` under the profiler; returns (its result, summary)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(EDGE_LEAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        with record_function(SPAN):
            out = run_units()
            torch.cuda.synchronize()
        for _ in range(EDGE_TAIL):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
    events = prof.events()
    span = next(e for e in events if e.name == SPAN)
    lo, hi = span.time_range.start, span.time_range.end
    # the span shows on the device too, as a user annotation: left out
    dev = [e for e in events if e.device_type == DeviceType.CUDA and EDGE not in e.name
           and e.name != SPAN and e.time_range.end > lo and e.time_range.start < hi]
    host = [e for e in events if e.device_type == DeviceType.CPU and e.name != SPAN
            and e.time_range.end > lo and e.time_range.start < hi]
    return out, summarize(dev, host, lo, hi)


def _clip(e, lo, hi):
    return max(e.time_range.start, lo), min(e.time_range.end, hi)


def summarize(dev, host, lo: float, hi: float) -> Dict:
    """Device time by kernel, kernel launches, busy seconds (the union of
    the device events' intervals), the window's seconds, the longest idle
    gaps named by the innermost host op open at their middle, and for each
    of the program's kernels the first launch after the window's start and
    after each unit's end mark."""
    own = port_kernels()
    marks = [lo] + sorted(e.time_range.start for e in host if e.name == UNIT)
    host = [e for e in host if e.name != UNIT]
    first: Dict[str, List[float]] = {}
    for k in own:
        spans = sorted(_clip(e, lo, hi) for e in dev if kernel_of(e.name, (k,)))
        for m, m_next in zip(marks, marks[1:] + [hi]):
            ab = next(((a, b) for a, b in spans if m <= a < m_next and b > a), None)
            if ab is not None:
                first.setdefault(k, []).append((ab[1] - ab[0]) / 1e6)
    by_name: Dict[str, List[float]] = {}
    launches = 0
    iv = []
    for e in dev:
        a, b = _clip(e, lo, hi)
        if b <= a:
            continue
        iv.append((a, b))
        rec = by_name.setdefault(e.name, [0.0, 0])
        rec[0] += (b - a) / 1e6
        rec[1] += 1
        launches += not e.name.startswith(("Memcpy", "Memset"))
    iv.sort()
    busy, gaps, cur = 0.0, [], None
    for a, b in iv:
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
                gaps.append((cur[1], a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    if iv:
        gaps = [(lo, iv[0][0])] + gaps + [(cur[1], hi)]
    gap_names: Dict[str, float] = {}
    hs = np.array([e.time_range.start for e in host], np.float64)
    he = np.array([e.time_range.end for e in host], np.float64)
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:GAPS_NAMED]:
        mid = (a + b) / 2
        open_ = np.nonzero((hs <= mid) & (he >= mid))[0]
        name = (host[open_[np.argmin((he - hs)[open_])]].name if open_.size
                else "host outside torch ops")
        gap_names[name] = gap_names.get(name, 0.0) + (b - a) / 1e6
    kernels = {n: (s, c) for n, (s, c) in by_name.items()}
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6, "launches": launches,
            "kernels": kernels, "own": own, "first": first,
            "idle_gaps": sorted(gap_names.items(), key=lambda kv: -kv[1])[:10]}


def first_launches(summary: Dict, kernel: str) -> Tuple[float, int]:
    """(seconds, launches) of the first launch of the program's kernel
    ``kernel`` in each unit of the trace."""
    t = summary["first"].get(kernel, [])
    return sum(t), len(t)


def other_time(summary: Dict) -> float:
    """Seconds of device time of the kernels that are not the program's own
    (copies and fills left out)."""
    return sum(sec for name, (sec, _) in summary["kernels"].items()
               if kernel_of(name, summary["own"]) is None
               and not name.startswith(("Memcpy", "Memset")))


def breakdown(summary: Dict) -> Dict:
    ops = sorted(summary["kernels"].items(), key=lambda kv: -kv[1][0])[:10]
    return {"device_ops": [[n, s] for n, (s, _) in ops],
            "idle_gaps": [[n, s] for n, s in summary["idle_gaps"]]}
