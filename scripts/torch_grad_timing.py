"""Repeated timing of the port's gradient at ``bench.py``'s backward config.

``chip_smoke.py`` phase 8 times the forward and the forward+backward best
of 3, which the host's run-to-run spread swamps when two checkouts are
compared. This script builds the same scene, camera and settings
(960x540 x 4 spp x 3 bounces, one chunk, sort + lane pack, grads of every
``SceneParams`` leaf) through ``chip_smoke.py``'s helpers and prints the
median, minimum and maximum of 10 runs in three orders, with the caching
allocator's cudaMalloc/cudaFree counts over each order.

Run from the root of a checkout on a CUDA machine:

    python3 scripts/torch_grad_timing.py

To compare two checkouts, run it in each, alternating (A B B A), in one
machine session.
"""

import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from atray_tpu_torch.accel.shaded import build_shaded_accel  # noqa: E402
from atray_tpu_torch.config import KDTreeConfig, RenderSettings  # noqa: E402
from atray_tpu_torch.render.rng import prng_key  # noqa: E402
from atray_tpu_torch.render.wavefront import render  # noqa: E402

REPS = 10


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_grad_timing: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    scene_host = cs._slice_scene()
    accel = build_shaded_accel(scene_host, KDTreeConfig(leaf_size=16)).to(dev)
    scene = scene_host.to(dev)
    settings = RenderSettings(resolution=(960, 540), samples_per_pixel=4, bounce_limit=3,
                              ray_chunk=0)
    cam = cs._bwd_camera()
    p = cs._grad_leaves(scene)

    def loss_of(k):
        return render(scene.with_params(p), cam, settings, prng_key(k), accel=accel).sum()

    def fwd(k):
        with torch.no_grad():
            return float(loss_of(k))

    def fwd_bwd(k):
        return torch.autograd.grad(loss_of(k), p.leaves())

    def timed(f, k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f(k)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def stats(xs):
        if not xs:
            return "-"
        return f"median {statistics.median(xs):.4f} min {min(xs):.4f} max {max(xs):.4f}"

    print(cs._gpu_line())
    fwd(100)
    fwd_bwd(100)
    for order in ("forward x10 then forward+backward x10", "forward+backward x10",
                  "alternating x10"):
        s0 = torch.cuda.memory_stats()
        fs, bs = [], []
        for k in range(1, REPS + 1):
            if order.startswith("alternating"):
                fs.append(timed(fwd, k))
                bs.append(timed(fwd_bwd, k))
            elif order.startswith("forward x10"):
                fs.append(timed(fwd, k))
        if not order.startswith("alternating"):
            bs = [timed(fwd_bwd, k) for k in range(1, REPS + 1)]
        s1 = torch.cuda.memory_stats()
        print(f"{order}: forward {stats(fs)} s; forward+backward {stats(bs)} s; cudaMalloc "
              f"{s1['num_device_alloc'] - s0['num_device_alloc']}, cudaFree "
              f"{s1['num_device_free'] - s0['num_device_free']}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
