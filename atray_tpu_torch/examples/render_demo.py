"""End to end through the port's public API: build a scene, render a beauty
frame and the AOV films (``examples/render_demo.py``).

Run from the repository root:

    python3 -m atray_tpu_torch.examples.render_demo [--res 640x360] [--spp 8]
        [--bounces 4] [--tris 20000] [--out demo] [--device cuda|cpu]

Writes ``<out>.png`` (beauty, sRGB) and ``<out>_depth.png``,
``<out>_normal.png``, ``<out>_albedo.png``, ``<out>_emission.png``; prints
each path. ``--device`` defaults to ``cuda`` and raises without a card;
``cpu`` runs the kernels' plain versions. Scene -> accel -> camera ->
render -> image, as the reference's app loop drives it.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from atray_tpu_torch.accel.shaded import build_shaded_accel
from atray_tpu_torch.config import RenderSettings
from atray_tpu_torch.core.camera import look_at_camera
from atray_tpu_torch.device import resolve_device
from atray_tpu_torch.render.aov import aov_preview_films, render_aovs
from atray_tpu_torch.render.film import save_png
from atray_tpu_torch.render.rng import prng_key
from atray_tpu_torch.render.wavefront import render
from atray_tpu_torch.scene import build_scene, procedural
from atray_tpu_torch.scene.data import Planes, Spheres, make_materials
from atray_tpu_torch.scene.transforms import translate


def demo_scene(tris: int):
    """A dragon proxy of ``tris`` triangles (red, glossy), a warm light
    sphere, a mirror sphere and a grey floor, under a blue sky."""
    mats = make_materials([
        ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),   # 0: sky
        ((0.0, 0.0, 0.0), (0.7, 0.7, 0.7), 0.0),      # 1: grey diffuse
        ((0.0, 0.0, 0.0), (0.8, 0.2, 0.2), 0.7),      # 2: red glossy
        ((4.0, 3.5, 3.0), (0.0, 0.0, 0.0), 0.0),      # 3: warm light
        ((0.0, 0.0, 0.0), (0.95, 0.95, 0.95), 1.0),   # 4: mirror
    ])
    mesh = translate(procedural.dragon_proxy(target_tris=tris, material=2), (0.0, -0.5, -4.0))
    spheres = Spheres(centers=np.asarray([[1.8, 0.4, -5.0], [-1.8, 0.2, -4.5]], np.float32),
                      radii=np.asarray([0.8, 0.7], np.float32),
                      material_id=np.asarray([3, 4], np.int32))
    planes = Planes(normals=np.asarray([[0.0, 1.0, 0.0]], np.float32),
                    offsets=np.asarray([-1.5], np.float32),
                    material_id=np.asarray([1], np.int32))
    return build_scene([mesh], spheres=spheres, planes=planes, materials=mats)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--res", default="640x360")
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--bounces", type=int, default=4)
    ap.add_argument("--tris", type=int, default=20000)
    ap.add_argument("--out", default="demo")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    w, h = (int(v) for v in args.res.split("x"))
    dev = resolve_device(args.device)

    scene_host = demo_scene(args.tris)
    accel = build_shaded_accel(scene_host).to(dev)
    scene = scene_host.to(dev)
    cam = look_at_camera((0.0, 0.8, 1.2), (0.0, 0.0, -4.0), h_fov=0.9, aspect=w / h)
    settings = RenderSettings(resolution=(w, h), samples_per_pixel=args.spp,
                              bounce_limit=args.bounces, anti_aliasing=True)

    t0 = time.perf_counter()
    film = render(scene, cam, settings, prng_key(0), accel=accel, device=dev)
    film = film.cpu()       # waits for the card
    print(f"beauty {w}x{h}x{args.spp}spp: {time.perf_counter() - t0:.1f}s (first call, "
          f"the kernels' build included; device {dev})")
    print(save_png(f"{args.out}.png", film, srgb=True))
    aovs = render_aovs(scene, cam, w, h, accel=accel, device=dev)
    for name, f in aov_preview_films(aovs).items():
        print(save_png(f"{args.out}_{name}.png", f))
    return 0


if __name__ == "__main__":
    sys.exit(main())
