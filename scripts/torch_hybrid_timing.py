"""Time and profile ``chip_smoke.py`` phase 12's ``HybridAccel`` render:
the slice mesh at leaf_size 8, 960x540 x 4 spp x 3 bounces, one chunk,
key 8; the ``HybridAccel`` and the ``make_accel`` BVH of the same mesh.

A one-off for A/B runs against checkouts whose ``chip_smoke.py`` phase 12
has no render profile or film digest; where phase 12 prints its
``phase 12 profile`` and sha256 lines, read those instead. Run on a CUDA
machine, naming the checkout to measure (by default the one that holds
this script):

    python3 scripts/torch_hybrid_timing.py [CHECKOUT]

The package and the scene, camera and profiling helpers of
``chip_smoke.py`` are those of ``CHECKOUT``, so for an A/B give each
checkout in turns (A B B A) in one call. It prints the host seconds of 5
renders with each accel, alternating, after a warm-up render each; the
device time by kernel of one profiled ``HybridAccel`` render
(``chip_smoke._profile_frame``: ``ppacket``'s and ``wide_exact``'s device
ms and launches, the busy share against the mean of the 5 timed renders);
and the first 16 hex digits of the sha256 of the ``HybridAccel`` film's
float32 bytes.
"""

import hashlib
import pathlib
import sys
import time

ROOT = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else pathlib.Path(__file__).parents[1])
sys.path.insert(0, str(ROOT.resolve()))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    from atray_tpu_torch.accel.wide import hybrid_from_mesh, make_accel
    from atray_tpu_torch.config import KDTreeConfig, RenderSettings
    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.render.wavefront import render

    if not torch.cuda.is_available():
        sys.exit("torch_hybrid_timing: no CUDA device")
    dev = torch.device("cuda:0")
    gpu = cs._gpu_line()
    host = cs._slice_scene()
    scene = host.to(dev)
    cfg = KDTreeConfig(leaf_size=8)
    hybrid = hybrid_from_mesh(host.mesh.vertices, host.mesh.faces, cfg).to(dev)
    wide = make_accel(host.mesh.vertices, host.mesh.faces, cfg).to(dev)
    settings = RenderSettings(resolution=(960, 540), samples_per_pixel=4, bounce_limit=3,
                              ray_chunk=0)
    cam = cs._bwd_camera()
    for acc in (hybrid, wide):
        render(scene, cam, settings, prng_key(100), accel=acc)
    secs = {"HybridAccel": [], "make_accel": []}
    for _ in range(5):
        for name, acc in (("HybridAccel", hybrid), ("make_accel", wide)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            film = render(scene, cam, settings, prng_key(8), accel=acc)
            torch.cuda.synchronize()
            secs[name].append(time.perf_counter() - t0)
            if name == "HybridAccel":
                h_film = film
    for name, v in secs.items():
        print(f"render seconds {name}: {', '.join(f'{x:.4f}' for x in v)} [{gpu}]")
    cs._profile_frame(lambda: render(scene, cam, settings, prng_key(8), accel=hybrid),
                      sum(secs["HybridAccel"]) / 5, gpu, "hybrid", "one HybridAccel render")
    digest = hashlib.sha256(h_film.cpu().numpy().tobytes()).hexdigest()[:16]
    print(f"film sha256 HybridAccel {digest}")


if __name__ == "__main__":
    main()
