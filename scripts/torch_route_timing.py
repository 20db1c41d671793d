"""Time the lane-routing loop probes P6 and P7 (``probe_r20.route_loop``
in each variant, ``probe_r20.route_dyn``) at the script's shapes: the
CUDA-event mean of 5 launches after a warm one, as ``probe_r20.table``
takes it, ten times over; the mean of 200 back-to-back launches; and, in
each of ``--rounds`` rounds, the device time of one of 20 launches by two
clocks: queued behind a spin kernel (this script's own
``_timing.device_ms``, which phase 14 bounds) and torch.profiler's
``key_averages`` mean over 20 launches between sleep kernels, with the
count of records it found. A launch of a few microseconds is timed by CUDA
events with the wrapper's host time; the other two clocks read the
kernel's own. Run on a CUDA machine, naming the checkout to measure (by
default the one that holds this script):

    python3 scripts/torch_route_timing.py [CHECKOUT] [--rounds N]

The package and ``chip_smoke.py`` are those of ``CHECKOUT``, so for an
A/B give each checkout in turns (A B B A) in one call. The last line sums
the rounds up: each clock's range by variant and the profiled windows that
did not hold 20 records.
"""

import argparse
import importlib.util
import pathlib
import statistics
import sys

ARGS = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
ARGS.add_argument("checkout", nargs="?", default=str(pathlib.Path(__file__).parents[1]))
ARGS.add_argument("--rounds", type=int, default=1)
OPTS = ARGS.parse_args()
ROOT = pathlib.Path(OPTS.checkout)
sys.path.insert(0, str(ROOT.resolve()))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# the queued-launch clock of this script's checkout, whichever checkout it times
_spec = importlib.util.spec_from_file_location(
    "route_timing_clock", pathlib.Path(__file__).parents[1] / "atray_tpu_torch/probes/_timing.py")
clock = importlib.util.module_from_spec(_spec)
sys.modules[_spec.name] = clock      # its dataclass looks its module up
_spec.loader.exec_module(clock)

REPS = clock.DEVICE_REPS


def profiled_us(fn, kernel):
    """(mean device us of a launch, records found) of ``REPS`` calls of
    ``fn`` from torch.profiler's ``key_averages``, the window padded with
    256 sleep kernels before and 16 after."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(256):
            torch.cuda._sleep(1)
        for _ in range(REPS):
            fn()
        for _ in range(16):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if kernel in e.key]
    count = sum(e.count for e in evs)
    return (sum(e.self_device_time_total for e in evs) / count if count else float("nan")), count


def main():
    from atray_tpu_torch.kernels import _build
    from atray_tpu_torch.probes import _timing, probe_r20 as p

    if not torch.cuda.is_available():
        sys.exit("torch_route_timing: no CUDA device")
    dev = torch.device("cuda:0")
    gpu = cs._gpu_line()
    _build.load()
    win, rel = p.inputs(dev)
    cases = [(f"P6 {v} x{u}", "probe_route_loop",
              lambda v=v, u=u, n=p.trips(dev, p.STEPS // u): p.route_loop(n, win, rel, v, u))
             for v, u in p.LOOP_CASES]
    n = p.trips(dev, p.STEPS)
    cases.append(("P7", "probe_route_dyn", lambda: p.route_dyn(n, win, rel)))
    reads = {label: [] for label, _, _ in cases}
    for rnd in range(OPTS.rounds):
        for label, kernel, fn in cases:
            fn()
            torch.cuda.synchronize()
            queued = clock.device_ms(fn) * 1e3
            prof_us, count = profiled_us(fn, kernel)
            reads[label].append((queued, prof_us, count))
            if rnd:
                continue
            five = [_timing.events_ms(fn, 5) for _ in range(10)]
            many = _timing.events_ms(fn, 200)
            print(f"route timing {label}: events 5 launches median {statistics.median(five):.5f} "
                  f"ms (min {min(five):.5f}, max {max(five):.5f}), 200 launches {many:.5f} ms, "
                  f"queued {queued:.2f} us a launch, profiler {prof_us:.2f} us a launch over "
                  f"{count} [{gpu}] {ROOT.resolve().name}", flush=True)
    short = sum(c != REPS for r in reads.values() for _, _, c in r)
    parts = []
    for label, r in reads.items():
        q = [x for x, _, _ in r]
        pr = [y for _, y, _ in r]
        parts.append(f"{label} queued {min(q):.2f}-{max(q):.2f}, profiler {min(pr):.2f}-"
                     f"{max(pr):.2f}, profiler/queued {min(y / x for x, y, _ in r):.3f}-"
                     f"{max(y / x for x, y, _ in r):.3f}")
    print(f"route timing over {OPTS.rounds} rounds (us a launch): {'; '.join(parts)}; profiled "
          f"windows without {REPS} records: {short} of {OPTS.rounds * len(cases)} [{gpu}] "
          f"{ROOT.resolve().name}", flush=True)


if __name__ == "__main__":
    main()
