"""Run one cell of the benchmark of ``atray_tpu_torch`` on the card and
print its result as one JSON line, last on standard output.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (``BENCHMARK.json``'s workload) names
its configuration (``portbench/configs/``) and its traffic
(``portbench/traffic/<name>.json``, whose ``driver`` names the loop in
``portbench/drivers/``); its limits are ``portbench/limits/<cell>.json``
and each metric is read by ``portbench/metrics/<metric>.py``. A run sets
the cell up and warms it, measures ``--seconds`` of the loop (with
``--trace 1`` first a short sub-window under the profiler), frees the
program's state, checks the window's outputs against the plain reference
and prints the metrics (glibc's malloc thresholds are fixed first, see
``steady_malloc``): with ``--trace 0`` the cell's end-to-end ones,
with ``--trace 1`` its per-layer ones. It exits non-zero, printing no
result, without as many CUDA devices as the cell asks for, when
``atray_tpu_torch`` is not in the checkout, or when JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import ctypes  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.common import Cell, applies, cell_files, load_module, read_json  # noqa: E402

HERE = os.path.join(ROOT, "portbench")
BANNED = ("jax", "jaxlib", "flax", "atray_tpu")
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3


def steady_malloc() -> None:
    """Fix glibc's mmap and trim thresholds for this process, so that a
    host buffer of a few tens of MB that is freed is kept and reused. Left
    to glibc's dynamic thresholds, one process maps and faults in a fresh
    24.9 MB film buffer in every pass and the next reuses one, at random,
    and the two read apart by several milliseconds a pass."""
    try:
        libc = ctypes.CDLL("libc.so.6")
    except OSError:
        return
    libc.mallopt(M_MMAP_THRESHOLD, 32 << 20)
    libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)


class Context:
    """What a metric's ``read(ctx)`` sees."""

    def __init__(self, cell, window, setup_s, trace=None, trace_units=0, peak_window_bytes=None):
        self.cell = cell
        self.window = window
        self.setup_s = setup_s
        self.trace = trace
        self.trace_units = trace_units
        self.peak_window_bytes = peak_window_bytes


def banned_modules():
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (``atray_tpu_torch`` is not ``atray_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def run_cell(cell: Cell, bench: dict, seconds: float, traced: bool, t_start: float):
    """Set up, warm, (trace,) measure and check one cell. Returns the
    result's fields and the checks as (name, value, limit) triples."""
    import torch

    cuda = torch.device(cell.device).type == "cuda"
    driver = load_module(os.path.join(HERE, "drivers", cell.traffic["driver"] + ".py"),
                         "portbench_driver_" + cell.traffic["driver"])
    run = driver.setup(cell)
    run.warm()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    summary, trace_units = None, 0
    if traced:
        from portbench import trace

        tw, summary = trace.profiled(
            lambda: run.window(units=cell.traffic["trace_units"], tag=2))
        trace_units = tw.units
    peak_setup = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    win = run.window(seconds=seconds)
    if cuda:
        torch.cuda.synchronize()
    peak_window = torch.cuda.max_memory_allocated() if cuda else None
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
              "count": cell.chips,
              "memory_peak_bytes": max(peak_setup, peak_window or 0)}
    if summary is not None:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
    run.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    got = run.check(win)
    checks = [(k, got.get(k, math.inf), float(lim)) for k, lim in cell.limits.items()]
    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks) and win.failed == 0
    ctx = Context(cell, win, setup_s, summary, trace_units, peak_window)
    wanted = [m for m in bench["per_layer" if traced else "end_to_end"]
              if applies(m, cell.name)]
    metrics = {}
    for m in wanted:
        mod = load_module(os.path.join(HERE, "metrics", m["name"] + ".py"),
                          "portbench_metric_" + m["name"].replace(".", "_"))
        val = mod.read(ctx)
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": win.units, "failed": win.failed,
           "metrics": metrics, "device": device}
    if summary is not None:
        from portbench import trace

        out["breakdown"] = trace.breakdown(summary)
    return out, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    steady_malloc()

    bench = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    files = cell_files(bench, args.workload)
    chips = files["workload"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    try:
        import atray_tpu_torch
    except ImportError as exc:
        print(f"portbench: atray_tpu_torch is not in this checkout ({exc})", file=sys.stderr)
        return 2
    if not os.path.abspath(atray_tpu_torch.__file__).startswith(ROOT + os.sep):
        print(f"portbench: atray_tpu_torch loads from {atray_tpu_torch.__file__}, "
              f"not from the checkout {ROOT}", file=sys.stderr)
        return 2
    cell = Cell(args.workload, read_json(files["config_file"]), read_json(files["traffic_file"]),
                read_json(files["limits_file"]), args.seed, "cuda", chips)
    out, checks = run_cell(cell, bench, args.seconds, bool(args.trace), T_START)
    found = banned_modules()
    if found:
        print(f"portbench: JAX or the JAX package was loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    out["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in checks}
    for k, v, lim in checks:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
