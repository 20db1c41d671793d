"""Inverse rendering (BASELINE config 5, ``examples/inverse_render.py``):
recover the material albedo and refine the vertex positions of a dragon
proxy from rendered target views, with the rays and targets sharded over
the ranks and the gradients summed over them.

Run from the repository root, alone or under ``torchrun``:

    python3 -m atray_tpu_torch.examples.inverse_render [--views 4] [--steps 60]
        [--res 32] [--tris 5000] [--bounces 2] [--checkpoint PATH]
        [--checkpoint-every 10] [--device cuda|cpu] [--dist-backend nccl|gloo]
    torchrun --standalone --nproc-per-node 2 -m atray_tpu_torch.examples.inverse_render ...

``--device`` defaults to ``cuda`` and raises without a card; ``cpu`` runs
the kernels' plain versions. Under ``torchrun`` every rank joins the
process group (``--dist-backend``, default ``nccl`` on cuda and ``gloo`` on
the CPU; two ranks sharing one card need ``gloo``) and the ray mesh spans
every rank; only rank 0 prints. The ``step ... loss ...`` lines keep the
reference's format.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from atray_tpu_torch.accel.wide import make_accel
from atray_tpu_torch.config import KDTreeConfig
from atray_tpu_torch.core.camera import camera_rays, look_at_camera
from atray_tpu_torch.dist.mesh import make_device_mesh, trace_sharded
from atray_tpu_torch.dist.multihost import init_distributed
from atray_tpu_torch.dist.train import make_train_step, run_training
from atray_tpu_torch.render.rng import prng_key
from atray_tpu_torch.scene import build_scene, procedural
from atray_tpu_torch.scene.data import make_materials
from atray_tpu_torch.scene.transforms import translate


def build_problem(views: int, res: int, tris: int, device):
    """(host scene, host ``make_accel`` at leaf 16, orig, dirn): the dragon
    proxy at (0, 0, -4) seen from ``views`` orbit views of res x res
    primaries, the rays of all views concatenated on ``device``."""
    mats = make_materials([
        ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.8, 0.45, 0.25), 0.2),   # the true albedo, to recover
    ])
    body = translate(procedural.dragon_proxy(target_tris=tris, material=1), (0, 0, -4))
    scene = build_scene([body], materials=mats)
    accel = make_accel(scene.mesh.vertices, scene.mesh.faces, KDTreeConfig(leaf_size=16))
    origs, dirns = [], []
    for v in range(views):
        ang = 2 * np.pi * v / views
        eye = (2.5 * np.sin(ang), 0.8, -4 + 2.5 * np.cos(ang))
        cam = look_at_camera(eye, (0, 0, -4), h_fov=0.8, aspect=1.0)
        o, d = camera_rays(cam, res, res, 1, device=device)
        origs.append(o)
        dirns.append(d)
    return scene, accel, torch.cat(origs), torch.cat(dirns)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--res", type=int, default=32)
    ap.add_argument("--tris", type=int, default=5000)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--bounces", type=int, default=2)
    ap.add_argument("--checkpoint", default=None,
                    help="npz train-state path; resumes if present "
                         "(params + optimizer state + step + seed)")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None)
    args = ap.parse_args(argv)

    owns = not dist.is_initialized()
    init_distributed(backend=args.dist_backend, device=args.device)
    try:
        return _run(args, make_device_mesh(0, device=args.device))
    finally:
        if owns and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, mesh) -> int:
    """``main`` on the ray mesh."""
    dev = mesh.device
    scene_host, accel, orig, dirn = build_problem(args.views, args.res, args.tris, dev)
    pad = (-orig.shape[0]) % mesh.size
    if pad:                                 # repeat the last ray
        orig = torch.cat([orig, orig[-1:].expand(pad, 3)])
        dirn = torch.cat([dirn, dirn[-1:].expand(pad, 3)])
    log = print if mesh.rank == 0 else (lambda *a, **k: None)
    log(f"{args.views} views x {args.res}^2 px = {orig.shape[0]} rays "
        f"over {mesh.size} device(s); {scene_host.mesh.num_faces} tris")

    # the target from the true parameters through the same sharded trace
    scene = scene_host.to(dev)
    accel = accel.to(dev)
    with torch.no_grad():
        target = trace_sharded(scene, orig, dirn, args.bounces, prng_key(0), mesh, accel=accel)

    # corrupt: wrong albedo and vertex noise
    true = scene.params()
    noise = np.random.default_rng(3).normal(0, 0.004, tuple(true.vertices.shape))
    p = dataclasses.replace(
        true, albedo=(true.albedo * 0.4 + 0.2).requires_grad_(),
        vertices=(true.vertices + torch.from_numpy(noise.astype(np.float32)).to(dev)
                  ).requires_grad_())
    opt = torch.optim.Adam([{"params": [p.albedo], "lr": 3e-2},
                            {"params": [p.vertices], "lr": 5e-4}])
    # refit=True: leaf records and boxes recomputed from the live vertices
    # at every step, so the walk follows the moving geometry
    step = make_train_step(scene_host, args.bounces, opt, accel=accel, refit=True, device=dev,
                           mesh=mesh)

    def on_step(i, loss):
        if i % 10 == 0 or i == args.steps - 1:
            # material 1 only: the sky row never reaches the image
            with torch.no_grad():
                alb_err = float((p.albedo[1] - true.albedo[1]).abs().max())
                v_err = float((p.vertices - true.vertices).abs().mean())
            log(f"step {i:4d}  loss {loss:.3e}  albedo_err {alb_err:.4f}  vert_err {v_err:.2e}")

    t0 = time.perf_counter()
    _, losses = run_training(step, opt, p, orig, dirn, target, num_steps=args.steps, seed=0,
                             checkpoint_path=args.checkpoint,
                             checkpoint_every=args.checkpoint_every, on_step=on_step)
    dt = time.perf_counter() - t0
    log(f"{len(losses)} steps in {dt:.1f}s "
        f"({len(losses) * orig.shape[0] * args.bounces / max(dt, 1e-9) / 1e6:.2f} "
        f"Mray-steps/s incl. backward)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
