"""The readings that the limits of ``correct`` are set from, for one cell
on the card: the program's numbers over many seeds (the lower readings)
and, on a few, the control's (the reference in bfloat16 put in the
program's place) and, for a training cell, the planted faults' (the upper
readings). The benchmark's own runs never run this.

    python3 portbench/control.py --workload <name> --seeds 1,2,... \\
        --control-seeds 1,2,3 [--seconds 3]

prints one JSON line a seed: ``{"seed", "program": {...}, "control":
{...}, "faults": {...}}``. The cell's set-up runs once a seed; a render
cell's window is ``--seconds`` long, enough for as many passes as a run
checks.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.common import Cell, cell_files, load_module, read_json  # noqa: E402

FAULTS = ("half", "grad")


def readings(cell: Cell, seconds: float, control: bool) -> dict:
    """One seed's readings of ``cell``."""
    import torch

    driver = load_module(os.path.join(ROOT, "portbench", "drivers",
                                      cell.traffic["driver"] + ".py"), "control_driver")
    t0 = time.perf_counter()
    run = driver.setup(cell)
    run.warm()
    win = run.window(seconds=seconds)
    run.free()
    gc.collect()
    torch.cuda.empty_cache()
    out = {"seed": cell.seed, "units": win.units}
    if cell.traffic["driver"] == "progressive":
        out["program"] = run.readings(win)
        if control:
            out["control"] = run.readings(win, torch.bfloat16)
    else:
        t1 = time.perf_counter()
        out["program"] = run.readings(run.reference())
        out["reference_s"] = time.perf_counter() - t1
        if control:
            out["control"] = run.readings(run.reference(torch.bfloat16))
            out["faults"] = {f: run.readings(run.reference(fault=f)) for f in FAULTS}
    out["seconds"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    bench = read_json(os.path.join(ROOT, "BENCHMARK.json"))
    files = cell_files(bench, args.workload)
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds + sorted(ctrl - set(seeds)):
        cell = Cell(args.workload, read_json(files["config_file"]),
                    read_json(files["traffic_file"]), read_json(files["limits_file"]), seed, "cuda")
        print(json.dumps(readings(cell, args.seconds, seed in ctrl)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
