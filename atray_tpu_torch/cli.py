"""Command line: TOML scenes rendered to PNG (``atray_tpu/cli.py``).

    python3 -m atray_tpu_torch.cli render scene.toml [-o out.png] [--spp N]
        [--res WxH] [--seed S] [--srgb] [--bounces N] [--nee]
        [--[no-]sort-bounces] [--[no-]lane-pack] [--chunk N] [--no-accel]
        [--progressive TOTAL_SPP [--checkpoint ck.npz] [--preview p.png]]
        [--telemetry N] [--aov PREFIX] [--device cuda|cpu]
        [--mesh N] [--treelet] [--dist-backend nccl|gloo]
    python3 -m atray_tpu_torch.cli info

Sharded renders run one process per rank, launched by ``torchrun``:

    torchrun --nproc-per-node N -m atray_tpu_torch.cli render scene.toml \
        --mesh N            # rays sharded over the N ranks
    torchrun --nproc-per-node N -m atray_tpu_torch.cli render scene.toml \
        --treelet           # triangles sharded, rays ride a ring

Every rank renders its share and holds the film; rank 0 writes the PNG,
the previews and checkpoints, and prints the progress and phase lines.

(``atray-torch`` once the package is installed.) Progress goes to stderr:
the scene line, a tick a chunk where the frame has several, a line a batch
in progressive mode, and the phase table (``utils.profiling``) at the end;
stdout gets the paths written.

Scene TOML (``examples/cornell.toml``, ``examples/arealight.toml``):

- ``[render]``: ``RenderSettings`` fields; ``[accel]``: ``KDTreeConfig``
  fields; ``[mesh]``: ``MeshConfig`` fields. An unknown key raises.
- ``[camera]``: ``eye``, ``look_at``, ``h_fov``.
- ``[[materials]]``: ``name``, ``emission``, ``albedo``, ``scatter``; the
  first entry is the sky. Without any, a blue sky and one grey material.
- ``[[meshes]]``: ``obj = path`` or ``procedural`` = ``cube`` (``size``,
  ``smooth``), ``uv_sphere`` (``rows``, ``cols``, ``radius``, ``smooth``),
  ``dragon`` (``tris``, ``smooth``) or ``quad`` (``corners``, counter-
  clockwise; an emissive quad is a NEE area light); then ``material``,
  ``scale_to`` and ``translate_to``, in that order.
- ``[[spheres]]``: ``center``, ``radius``, ``material``; ``[[planes]]``:
  ``normal`` (normalized here), ``offset``, ``material``.
- ``[texture]``: ``image = path`` (read with PIL, imported only then) or
  ``checker = [H, W]`` with ``color_a`` and ``color_b``.

Differences from the reference's command line:

- ``--device`` (default ``cuda``, which raises without a card; ``cpu``
  runs the plain PyTorch versions of the kernels, as the tests do).
- A ``build`` phase loads the kernels' library (on the card only) and
  uploads the scene and accel, where the reference has ``compile``.
- ``--mesh N`` (or ``[mesh] num_devices``; -1 means every rank) shards
  the rays over the ranks of the process group, which must number N (the
  reference takes the first N devices of its one controller); ``--treelet``
  shards the triangles over every rank (``dist/treelet.py``: kernel accels
  when the faces number at least ranks x leaf size, else the brute-force
  backend). Both join the group from ``torchrun``'s environment
  (``dist.multihost.init_distributed``); a process started alone is a
  world of one rank.
- ``--dist-backend {nccl,gloo}``: the process group's backend, which a
  process per rank needs and a single controller does not; by default
  ``nccl`` on a CUDA device and ``gloo`` on the CPU. Two ranks that share
  one card need ``gloo`` (NCCL refuses them).
- Only rank 0 writes files and prints the progress and phase lines.
- No ``bench`` subcommand until the port's bench exists (``ROADMAP.md``).
- No JAX compilation-cache settings.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import tomllib
from typing import Dict

import numpy as np


def _table(doc: dict, name: str, cls):
    """``cls(**doc[name])``, raising on a key that is not a field of ``cls``."""
    cfg = dict(doc.get(name, {}))
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(cfg) - known
    if unknown:
        raise ValueError(f"unknown [{name}] keys {sorted(unknown)}; valid: {sorted(known)}")
    return cfg


def _mesh_entry(m: dict, mid: int):
    from atray_tpu_torch.scene import load_obj, procedural
    from atray_tpu_torch.scene.transforms import scale_to, translate_to

    if "obj" in m:
        mesh = load_obj(m["obj"], default_material=mid)
    else:
        kind = m.get("procedural", "cube")
        if kind == "cube":
            mesh = procedural.cube(size=float(m.get("size", 2.0)), material=mid,
                                   smooth=bool(m.get("smooth", False)))
        elif kind == "uv_sphere":
            mesh = procedural.uv_sphere(rows=int(m.get("rows", 32)), cols=int(m.get("cols", 32)),
                                        radius=float(m.get("radius", 1.0)), material=mid,
                                        smooth=bool(m.get("smooth", True)))
        elif kind == "dragon":
            mesh = procedural.dragon_proxy(target_tris=int(m.get("tris", 139000)), material=mid,
                                           smooth=bool(m.get("smooth", True)))
        elif kind == "quad":
            c = m["corners"]
            mesh = procedural.quad(c[0], c[1], c[2], c[3], material=mid)
        else:
            raise ValueError(f"unknown procedural mesh {kind!r}")
    if "scale_to" in m:
        mesh = scale_to(mesh, float(m["scale_to"]))
    if "translate_to" in m:
        mesh = translate_to(mesh, m["translate_to"])
    return mesh


def load_scene_file(path: str):
    """Parse a scene TOML into (scene, camera, settings, accel_cfg,
    mesh_cfg): a host ``Scene``, a ``Camera``, ``RenderSettings``,
    ``KDTreeConfig`` and ``MeshConfig``."""
    from atray_tpu_torch.config import KDTreeConfig, MeshConfig, RenderSettings
    from atray_tpu_torch.core.camera import look_at_camera
    from atray_tpu_torch.scene import build_scene
    from atray_tpu_torch.scene.data import Planes, Spheres, make_materials

    with open(path, "rb") as fh:
        doc = tomllib.load(fh)

    rcfg = _table(doc, "render", RenderSettings)
    if "resolution" in rcfg:
        rcfg["resolution"] = tuple(rcfg["resolution"])
    settings = RenderSettings(**rcfg)
    accel_cfg = KDTreeConfig(**_table(doc, "accel", KDTreeConfig))
    mesh_cfg = MeshConfig(**_table(doc, "mesh", MeshConfig))

    mat_rows = []
    mat_index: Dict[str, int] = {}
    for i, m in enumerate(doc.get("materials", [])):
        mat_index[m.get("name", f"material_{i}")] = i
        mat_rows.append((tuple(m.get("emission", (0.0, 0.0, 0.0))),
                         tuple(m.get("albedo", (0.0, 0.0, 0.0))),
                         float(m.get("scatter", 0.0))))
    if not mat_rows:
        mat_rows = [((0.3, 0.4, 0.6), (0, 0, 0), 0.0), ((0.0, 0.0, 0.0), (0.7, 0.7, 0.7), 0.0)]
        mat_index = {"sky": 0, "default": 1}
    materials = make_materials(mat_rows)

    def mat_id(name, default=1):
        return mat_index.get(name, default)

    meshes = [_mesh_entry(m, mat_id(m.get("material", ""), 1)) for m in doc.get("meshes", [])]

    sph = doc.get("spheres", [])
    spheres = None
    if sph:
        spheres = Spheres(
            centers=np.asarray([s["center"] for s in sph], np.float32),
            radii=np.asarray([s["radius"] for s in sph], np.float32),
            material_id=np.asarray([mat_id(s.get("material", "")) for s in sph], np.int32))
    pln = doc.get("planes", [])
    planes = None
    if pln:
        normals = np.asarray([p["normal"] for p in pln], np.float32)
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        planes = Planes(
            normals=normals,
            offsets=np.asarray([p["offset"] for p in pln], np.float32),
            material_id=np.asarray([mat_id(p.get("material", "")) for p in pln], np.int32))

    texture = None
    tcfg = doc.get("texture", {})
    if "image" in tcfg:
        from PIL import Image

        img = Image.open(tcfg["image"]).convert("RGB")
        texture = np.asarray(img, np.float32) / 255.0
    elif "checker" in tcfg:
        th, tw = (int(x) for x in tcfg["checker"])
        ca = np.asarray(tcfg.get("color_a", (1.0, 1.0, 1.0)), np.float32)
        cb = np.asarray(tcfg.get("color_b", (0.2, 0.2, 0.2)), np.float32)
        yy, xx = np.mgrid[0:th, 0:tw]
        m = ((xx + yy) % 2).astype(np.float32)[..., None]
        texture = m * ca + (1.0 - m) * cb

    scene = build_scene(meshes, spheres=spheres, planes=planes, materials=materials,
                        texture=texture)

    ccfg = doc.get("camera", {})
    w, h = settings.resolution
    camera = look_at_camera(ccfg.get("eye", (0.0, 1.0, 1.0)),
                            ccfg.get("look_at", (0.0, 0.0, -4.0)),
                            h_fov=float(ccfg.get("h_fov", 0.9)), aspect=w / h)
    return scene, camera, settings, accel_cfg, mesh_cfg


def _apply_flags(settings, args):
    """``settings`` with the command line's overrides."""
    rep = dataclasses.replace
    if args.spp:
        settings = rep(settings, samples_per_pixel=args.spp)
    if args.res:
        w, h = (int(x) for x in args.res.split("x"))
        settings = rep(settings, resolution=(w, h))
    if args.bounces:
        settings = rep(settings, bounce_limit=args.bounces)
    if args.nee:
        settings = rep(settings, nee=True)
    if args.sort_bounces is not None:
        settings = rep(settings, sort_bounces=args.sort_bounces)
    if args.lane_pack is not None:
        settings = rep(settings, lane_pack=args.lane_pack)
    if args.chunk is not None:
        settings = rep(settings, ray_chunk=args.chunk)
    if args.no_accel:
        settings = rep(settings, use_accel=False)
    return settings


def _mesh_for(args, mesh_cfg):
    """(the ray mesh, whether this process made the process group), or
    (None, False) when neither ``--mesh``/``[mesh]`` nor ``--treelet`` asks
    for one. The flag overrides ``[mesh] num_devices``; -1 means every
    rank, and ``--treelet`` alone takes every rank."""
    mesh_n = args.mesh or mesh_cfg.num_devices
    if not (mesh_n or args.treelet):
        return None, False
    import torch.distributed as dist

    from atray_tpu_torch.dist.mesh import make_device_mesh
    from atray_tpu_torch.dist.multihost import init_distributed

    owns = not dist.is_initialized()
    init_distributed(backend=args.dist_backend, device=args.device)
    return make_device_mesh(num_devices=mesh_n, device=args.device), owns and dist.is_initialized()


def cmd_render(args) -> int:
    from atray_tpu_torch.device import resolve_device
    from atray_tpu_torch.utils.profiling import Phase

    with Phase("load"):
        scene, camera, settings, accel_cfg, mesh_cfg = load_scene_file(args.scene)
        settings = _apply_flags(settings, args)
    dmesh, owns_group = _mesh_for(args, mesh_cfg)
    try:
        return _render_command(args, scene, camera, settings, accel_cfg, dmesh,
                               resolve_device(args.device) if dmesh is None else dmesh.device)
    finally:
        if owns_group:
            import torch.distributed as dist

            dist.destroy_process_group()


def _render_command(args, scene, camera, settings, accel_cfg, dmesh, dev) -> int:
    """``cmd_render`` after the scene file is read: every rank renders;
    rank 0 (or the one process without a mesh) writes and prints."""
    from atray_tpu_torch.accel.shaded import build_shaded_accel
    from atray_tpu_torch.render.film import save_png
    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.render.wavefront import render
    from atray_tpu_torch.utils.profiling import Phase, phase_report

    lead = dmesh is None or dmesh.rank == 0

    def say(text: str) -> None:
        if lead:
            print(text, file=sys.stderr, flush=True)

    say(f"scene: {scene.mesh.num_faces} tris, {scene.spheres.count} spheres, "
        f"{scene.planes.count} planes; {settings.width}x{settings.height} "
        f"@ {settings.samples_per_pixel}spp x{settings.bounce_limit} bounces")
    # the treelet render walks per-rank part accels, not the whole mesh's
    treelet = args.treelet and not (args.progressive or args.telemetry)
    with Phase("accel_build"):
        accel = (build_shaded_accel(scene, accel_cfg)
                 if scene.mesh.num_faces > 0 and settings.use_accel and not treelet else None)
    if dmesh is not None:
        import torch.distributed as dist

        backend = dist.get_backend(dmesh.group) if dmesh.group is not None else "none"
        say(f"device mesh: {dmesh.size} rank(s), backend {backend}, rank 0 on {dmesh.device}")
    scene_host = scene
    with Phase("build", block=True):
        if dev.type == "cuda":
            from atray_tpu_torch.kernels import _build

            _build.load()
        scene = scene.to(dev)
        accel = None if accel is None else accel.to(dev)

    if args.progressive:
        from atray_tpu_torch.render.progressive import render_progressive

        preview = args.preview or (args.output + ".preview.png")

        def on_batch(state):
            say(f"  batch {state.batches_done}: {state.spp_total} spp total")
            if lead:
                save_png(preview, state.film(), srgb=args.srgb)

        with Phase("render", block=True):
            state = render_progressive(scene, camera, settings, total_spp=args.progressive,
                                       accel=accel, seed=args.seed,
                                       checkpoint_path=args.checkpoint, on_batch=on_batch,
                                       device=dev, mesh=dmesh)
        film = state.film()
    elif args.telemetry:
        from atray_tpu_torch.render.telemetry import render_telemetry, tail_report

        with Phase("render", block=True):
            film, report = render_telemetry(scene, camera, settings, prng_key(args.seed),
                                            accel=accel, n_chunks=args.telemetry, device=dev)
        per_shard = None
        if dmesh is not None:
            # the shard balance, from the sharded render's counts
            _, st = render(scene, camera, settings, prng_key(args.seed), accel=accel,
                           device=dev, mesh=dmesh, return_stats=True)
            per_shard = st["rays_cast_per_shard"].cpu().numpy()
        if lead:
            tail_report(report, rays_per_shard=per_shard, file=sys.stderr)
    elif treelet:
        from atray_tpu_torch.dist.treelet import build_treelet_accels, render_treelet

        say(f"treelet sharding over {dmesh.size} rank(s)")
        # kernel accels a part where the mesh is big enough to partition;
        # small meshes take the brute-force backend
        ta = None
        if scene.mesh.num_faces >= dmesh.size * accel_cfg.leaf_size:
            with Phase("bvh_build"):
                ta = build_treelet_accels(scene_host, dmesh.size, accel_cfg)
        with Phase("render", block=True):
            film = render_treelet(scene, camera, settings, prng_key(args.seed), dmesh,
                                  treelets=ta)
    else:
        n = settings.width * settings.height * settings.samples_per_pixel
        n_chunks = -(-n // settings.ray_chunk) if settings.ray_chunk else 1
        done = [0]

        def tick(live: int):
            done[0] += 1
            print(f"  chunk {done[0]}/{n_chunks}: {live / 1e6:.2f}M live rays traced",
                  file=sys.stderr, flush=True)

        # the sharded render calls back nothing (every rank would tick)
        with Phase("render", block=True):
            film = render(scene, camera, settings, prng_key(args.seed), accel=accel,
                          device=dev, mesh=dmesh,
                          progress_cb=tick if n_chunks > 1 and dmesh is None else None)

    if not lead:
        return 0
    with Phase("save"):
        path = save_png(args.output, film, srgb=args.srgb)
    if args.aov:
        from atray_tpu_torch.render.aov import aov_preview_films, render_aovs

        with Phase("aov", block=True):
            films = aov_preview_films(render_aovs(scene, camera, settings.width,
                                                  settings.height, accel=accel, device=dev))
            for name, f in films.items():
                print(save_png(f"{args.aov}_{name}.png", f))
    rays = settings.width * settings.height * settings.samples_per_pixel * settings.bounce_limit
    print(phase_report(rays=rays), file=sys.stderr)
    print(path)
    return 0


def cmd_info(args) -> int:
    import torch

    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            print(f"  cuda:{i} {torch.cuda.get_device_name(i)}")
    else:
        print("  no CUDA device (render with --device cpu)")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="atray-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a TOML scene to PNG")
    pr.add_argument("scene")
    pr.add_argument("-o", "--output", default="out.png")
    pr.add_argument("--spp", type=int, default=0)
    pr.add_argument("--res", default="")
    pr.add_argument("--seed", type=int, default=0)
    pr.add_argument("--srgb", action="store_true")
    pr.add_argument("--bounces", type=int, default=0)
    pr.add_argument("--nee", action="store_true",
                    help="next-event estimation (explicit shadow rays)")
    pr.add_argument("--sort-bounces", action=argparse.BooleanOptionalAction, default=None,
                    help="ray-queue compaction after the first diffuse bounce (on by default)")
    pr.add_argument("--lane-pack", action=argparse.BooleanOptionalAction, default=None,
                    help="pack live rays to a dense prefix on top of the compaction "
                         "(lane_take; on by default, film-identical)")
    pr.add_argument("--chunk", type=int, default=None,
                    help="trace rays in chunks of this many (device memory bound)")
    pr.add_argument("--no-accel", action="store_true",
                    help="test every triangle by brute force")
    pr.add_argument("--mesh", type=int, default=0,
                    help="shard rays over the N ranks of the process group (-1: every rank; "
                         "launch the ranks with torchrun)")
    pr.add_argument("--progressive", type=int, default=0,
                    help="total spp rendered in batches of render.samples_per_pixel")
    pr.add_argument("--checkpoint", default=None,
                    help="npz checkpoint path for progressive resume")
    pr.add_argument("--preview", default=None,
                    help="in-flight preview PNG path (progressive mode)")
    pr.add_argument("--telemetry", type=int, default=0, metavar="N",
                    help="render as N timed chunks and print the per-chunk cost table")
    pr.add_argument("--treelet", action="store_true",
                    help="shard the triangles over the ranks; rays ride a ring")
    pr.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="process-group backend for --mesh/--treelet (default: nccl on "
                         "cuda, gloo on cpu; ranks sharing one card need gloo)")
    pr.add_argument("--aov", default=None, metavar="PREFIX",
                    help="also write AOV films (depth/normal/albedo/emission) as "
                         "PREFIX_<name>.png from one deterministic primary pass")
    pr.add_argument("--device", default="cuda",
                    help="torch device to render on (cuda raises without a card; cpu runs "
                         "the kernels' plain versions)")
    pr.set_defaults(fn=cmd_render)

    pi = sub.add_parser("info", help="show torch, CUDA and the visible devices")
    pi.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
