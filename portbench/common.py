"""What the harness and the drivers share: the cell a run measures, the
record of a window, and file lookup by name."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
M32 = 0xFFFFFFFF


class StopWindow(Exception):
    """Raised from inside a driver's loop when the window is over."""


@dataclasses.dataclass
class Cell:
    """One run's cell: the workload's entry, its configuration and traffic
    files, its limits, the seed and the device. Drivers add what the
    metrics read: ``accel_build_s`` and ``shapes``."""

    name: str
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    seed: int
    device: Any
    chips: int = 1
    accel_build_s: Optional[float] = None
    shapes: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Window:
    """A measured stretch: its start on the host clock, the end of each
    unit (a pass, a step) on it, the work of a unit in the traffic's
    count, units that failed, and what the loop's correctness check reads."""

    t0: float
    ends: List[float]
    work_per_unit: float
    failed: int = 0
    records: Any = None

    @property
    def units(self) -> int:
        return len(self.ends)

    @property
    def seconds(self) -> float:
        return (self.ends[-1] - self.t0) if self.ends else 0.0

    def unit_seconds(self) -> List[float]:
        starts = [self.t0] + self.ends[:-1]
        return [e - s for s, e in zip(starts, self.ends)]


def read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    """The Python file ``path`` as a module (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: dict, workload: str) -> dict:
    """The entries and files of ``workload``: its entry, its configuration's
    entry, and the paths of its configuration, traffic and limits."""
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == wl["config"])
    return {"workload": wl, "config": cfg,
            "config_file": os.path.join(ROOT, cfg["file"]),
            "traffic_file": os.path.join(HERE, "traffic", wl["traffic"] + ".json"),
            "limits_file": os.path.join(HERE, "limits", workload + ".json")}


def applies(metric: dict, workload: str) -> bool:
    """Whether ``metric`` is reported in ``workload``: where it lists
    workloads, when it names this one; else in every cell."""
    return workload in metric.get("workloads", [workload])
