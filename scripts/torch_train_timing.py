"""Repeated timing of the port's trainer step on ``make_accel``, and the
host time of its hit kernel's wrapper.

``chip_smoke.py`` phase 9 times 4 steps, which the host's run-to-run
spread swamps when two checkouts are compared. This script builds phase
9's trainer (BASELINE config 5's model width: ``dragon_proxy(139_000)``
seen from 16 orbit views at 64x64 px, 1 spp, 2 bounces, albedo and
vertices corrupted, Adam, ``refit=True``) with ``chip_smoke.py``'s
``_trainer`` and prints:

- the median, minimum and maximum wall seconds of ``STEPS`` steps after 3
  warm-up steps (and each), and the losses;
- the device kernel time of one step by kernel (``torch.profiler``);
- the host's self CPU time in torch ops a step (``torch.profiler``);
- the host seconds of one ``wide_exact_first_hit`` call on the step's
  primaries (its checks, any tables it derives and its launch; the card
  idle before and after), on a fresh ``refit_wide`` accel as each step
  makes one, and again on the same accel: median of ``HOST_REPS``.

Run from the root of a checkout on a CUDA machine:

    python3 scripts/torch_train_timing.py

The code that drives the trainer (this script and the ``chip_smoke.py``
beside it) is that of the script's own checkout; the ``atray_tpu_torch``
package is that of the directory it is run from. So one copy drives two
checkouts' packages the same way: run it from the root of each,
alternating (A B B A ...), on one machine in one go. It uses only entry
points whose signatures both packages share.
"""

import importlib.util
import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                               "chip_smoke.py"))
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

from atray_tpu_torch.accel.wide import make_accel, refit_wide  # noqa: E402
from atray_tpu_torch.config import KDTreeConfig  # noqa: E402
from atray_tpu_torch.kernels.wide_exact import wide_exact_first_hit  # noqa: E402
from atray_tpu_torch.render.rng import fold_in, prng_key  # noqa: E402

STEPS = 20
HOST_STEPS = 3
HOST_REPS = 20


def _wrapper_host_ms(accel, vertices, faces, orig, dirn):
    """Median host ms of one wrapper call on a fresh refit accel, and again
    on the same accel, the card synchronised around each call."""
    fresh, again = [], []
    for _ in range(HOST_REPS):
        acc = refit_wide(accel, vertices, faces)
        for out in (fresh, again):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            wide_exact_first_hit(acc, orig, dirn)
            out.append(time.perf_counter() - t0)
            torch.cuda.synchronize()
    return statistics.median(fresh) * 1e3, statistics.median(again) * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_train_timing: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gpu = cs._gpu_line()
    scene_host = cs._trainer_scene()
    accel = make_accel(scene_host.mesh.vertices, scene_host.mesh.faces,
                       KDTreeConfig(leaf_size=16)).to(dev)
    orig, dirn = cs._trainer_rays(dev)
    scene, _, p, target, steps = cs._trainer(scene_host, {"make_accel": accel}, orig, dirn, dev)
    step = steps["make_accel"]

    losses, secs = [], []
    for s in range(3 + STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(p, orig, dirn, target, fold_in(prng_key(0), s))))
        secs.append(time.perf_counter() - t0)
    secs = secs[3:]
    print(f"make_accel trainer step, {STEPS} steps after 3 warm-up: median "
          f"{statistics.median(secs):.4f} s, min {min(secs):.4f} s, max {max(secs):.4f} s "
          f"[{gpu}]")
    print("step seconds " + ", ".join(f"{x:.4f}" for x in secs))
    key = fold_in(prng_key(0), 3 + STEPS)
    cs._profile_frame(lambda: step(p, orig, dirn, target, key), statistics.median(secs), gpu,
                      "train timing", "one make_accel trainer step")
    # the host's side of a step: self CPU time of its torch ops and launches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for s in range(HOST_STEPS):
            step(p, orig, dirn, target, fold_in(prng_key(0), 4 + STEPS + s))
        torch.cuda.synchronize()
    host_ms = sum(e.self_cpu_time_total for e in prof.key_averages()) / 1e3 / HOST_STEPS
    print(f"host: {host_ms:.3f} ms of self CPU time in torch ops a step (mean of "
          f"{HOST_STEPS} profiled steps) [{gpu}]")
    with torch.no_grad():
        fresh_ms, again_ms = _wrapper_host_ms(accel, p.vertices.detach(), scene.mesh.faces,
                                              orig, dirn)
    print(f"wrapper host: wide_exact_first_hit on {orig.shape[0]} primaries, median of "
          f"{HOST_REPS}: {fresh_ms:.4f} ms on a fresh refit_wide accel, {again_ms:.4f} ms "
          f"again on it [{gpu}]")
    print("losses " + ", ".join(f"{x:.6g}" for x in losses))
    return 0


if __name__ == "__main__":
    sys.exit(main())
