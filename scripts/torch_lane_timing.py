"""Time ``lane_take`` on the pair path's two routing maps, captured from
``render()``: the slice frame's (one 4,147,200-ray chunk, N = K x 4,147,200)
and the pair gradient's (one 2,073,600-ray chunk, N = K x 2,073,600).

Run from the root of a checkout on a CUDA machine:

    python3 scripts/torch_lane_timing.py [--groups 1,2,0]

The package and the scene, camera and timing helpers of ``chip_smoke.py``
are those of the directory it is run from, so each checkout's kernel is
timed on its own path's maps: run it from the root of each, in turns
(A B B A), in one call. A map is captured by replacing
``treelet_pairs.lane_take`` for one forward render: its first call there is
the routing take of bounce 1. Each time is the mean of 20 calls between
CUDA events after a warm-up. ``--groups`` also times the wrapper with
``lane_pack.plane_group`` fixed to each value (0: all planes), for a
package that has it.
"""

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def _routing_take(render):
    """(words, slot) of the first ``lane_take`` that ``render()`` makes
    through the pair path, cloned."""
    from atray_tpu_torch.kernels import treelet_pairs

    real, got = treelet_pairs.lane_take, []

    def spy(words, slot):
        if not got:
            got.append((words.clone(), slot.clone()))
        return real(words, slot)

    treelet_pairs.lane_take = spy
    try:
        with torch.no_grad():
            render()
        torch.cuda.synchronize()
    finally:
        treelet_pairs.lane_take = real
    return got[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--groups", default="", help="plane groups to time, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_lane_timing: no CUDA device", file=sys.stderr)
        return 2
    from atray_tpu_torch.accel.shaded import build_shaded_accel
    from atray_tpu_torch.config import KDTreeConfig, RenderSettings
    from atray_tpu_torch.kernels import lane_pack
    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.render.wavefront import render

    dev = torch.device("cuda:0")
    gpu = cs._gpu_line()
    print(f"{gpu}; package {os.path.abspath('atray_tpu_torch')}", flush=True)
    scene_host = cs._slice_scene()
    accel = build_shaded_accel(scene_host, KDTreeConfig(leaf_size=16)).to(dev)
    scene = scene_host.to(dev)
    frame, frame_cam = cs._slice_settings()
    grad = RenderSettings(resolution=(960, 540), samples_per_pixel=4, bounce_limit=3,
                          ray_chunk=0)
    cases = {"slice chunk": (dataclasses.replace(frame, pair_bounces=True), frame_cam),
             "gradient chunk": (dataclasses.replace(grad, pair_bounces=True), cs._bwd_camera())}
    groups = [int(g) for g in args.groups.split(",") if g]
    for label, (settings, cam) in cases.items():
        words, slot = _routing_take(
            lambda: render(scene, cam, settings, prng_key(0), accel=accel))
        want = lane_pack.lane_take_ref(words, slot)
        c, n = words.shape
        line = [f"lane_take pair routing, {label}: C={c} N={n} "
                f"({int((slot >= 0).sum())} routed)"]
        if not torch.equal(lane_pack.lane_take(words, slot), want):
            raise AssertionError(f"lane_take != lane_take_ref ({label})")
        line.append(f"wrapper {cs._cuda_ms(lambda: lane_pack.lane_take(words, slot), 20):.4f} ms")
        for g in groups:
            real = lane_pack.plane_group
            lane_pack.plane_group = lambda n_, c_, g=g: g or c_
            try:
                if not torch.equal(lane_pack.lane_take(words, slot), want):
                    raise AssertionError(f"lane_take != lane_take_ref ({label}, group {g})")
                ms = cs._cuda_ms(lambda: lane_pack.lane_take(words, slot), 20)
            finally:
                lane_pack.plane_group = real
            line.append(f"group {g or c} {ms:.4f} ms")
        print(f"{', '.join(line)} [{gpu}]", flush=True)
        del words, slot, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
