"""PyTorch port: ray sharding over ``torch.distributed`` ranks
(``dist/mesh.py``, ``dist/multihost.py``, ``render(mesh=)``, the command
line's ``--mesh``): twins of ``tests/test_sharding.py``'s bit-exact sharded
renders and of ``tests/test_multihost.py``.

The rank side runs once for the whole file: the module-scoped fixture
``ranks`` spawns 3 gloo ranks over 127.0.0.1 (``spawn_ranks``), which run
every case's sharded work on inputs the parent made and write their results
under a temporary directory; the cases assert in the parent. 17x17 x 2 spp
is 578 rays, one pad ray over 3 ranks. The ranks import this file, so it
imports nothing of JAX at module level: the JAX side (``render_sharded`` on
a mesh of 3 of the conftest's 8 virtual CPU devices) is imported in the
fixture that renders it."""

import contextlib
import dataclasses
import io
import os
import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

torch.set_num_threads(2)

from atray_tpu_torch import cli  # noqa: E402
from atray_tpu_torch.accel.shaded import build_shaded_accel  # noqa: E402
from atray_tpu_torch.config import RenderSettings  # noqa: E402
from atray_tpu_torch.core.camera import camera_rays, look_at_camera  # noqa: E402
from atray_tpu_torch.dist.mesh import make_device_mesh, trace_sharded  # noqa: E402
from atray_tpu_torch.dist.multihost import (  # noqa: E402
    assemble_film,
    host_local_slice,
    init_distributed,
    process_info,
)
from atray_tpu_torch.interop import scene_from_numpy  # noqa: E402
from atray_tpu_torch.render.rng import prng_key  # noqa: E402
from atray_tpu_torch.render.wavefront import render, trace_radiance  # noqa: E402
from atray_tpu_torch.utils.profiling import reset_phases  # noqa: E402

WORLD = 3
RANK_TIMEOUT_S = 240
EYE, TARGET = (0.0, 0.4, 0.6), (0.0, 0.0, -4.0)
SETTINGS = {
    "plain": RenderSettings(resolution=(17, 17), samples_per_pixel=2, bounce_limit=3),
    "nee_chunked": RenderSettings(resolution=(17, 17), samples_per_pixel=2, bounce_limit=3,
                                  nee=True, ray_chunk=72),
}
ROWS = (0, 1, 2, 3, 5, 17, 100)     # host_local_slice's film heights

# a cube, a light sphere and a floor, 24x16 x 2 spp x 3 bounces
TOML = """
[render]
resolution = [24, 16]
samples_per_pixel = 2
bounce_limit = 3

[accel]
leaf_size = 4

[camera]
eye = [0.0, 0.5, 1.0]
look_at = [0.0, 0.0, -4.0]
h_fov = 0.9

[[materials]]
name = "sky"
emission = [0.1, 0.12, 0.2]

[[materials]]
name = "red"
albedo = [0.8, 0.3, 0.2]
scatter = 0.3

[[materials]]
name = "light"
emission = [5.0, 4.5, 4.0]

[[meshes]]
procedural = "cube"
material = "red"
translate_to = [0.0, 0.0, -4.0]

[[spheres]]
center = [1.2, 1.5, -3.5]
radius = 0.5
material = "light"

[[planes]]
normal = [0.0, 1.0, 0.0]
offset = -1.2
material = "red"
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_entry(rank, fn, world, port, job, out):
    torch.set_num_threads(2)
    init_distributed(f"tcp://127.0.0.1:{port}", world, rank, backend="gloo")
    try:
        fn(rank, job, out)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, job, out, world=WORLD, timeout=RANK_TIMEOUT_S):
    """``fn(rank, job, out)`` in ``world`` spawned processes joined as a
    gloo group over 127.0.0.1; a rank that raises fails the call (the
    others are stopped), and so does one still running at ``timeout``."""
    ctx = mp.start_processes(_rank_entry, args=(fn, world, free_port(), job, out),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _cli(argv):
    """``cli.main(argv)`` -> (exit code, its stderr), the phase table this
    command's alone."""
    reset_phases()
    err = io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(argv)
    return rc, err.getvalue()


def _dist_rank(rank, job, out):
    """The rank side of every case."""
    mesh = make_device_mesh(WORLD, device="cpu")
    scene = scene_from_numpy(job["scene"])
    cam = look_at_camera(EYE, TARGET, h_fov=0.9, aspect=1.0)
    res = {"rank_world": np.asarray(process_info())}
    for name, s in SETTINGS.items():
        film, st = render(scene, cam, s, prng_key(5), mesh=mesh, return_stats=True)
        res[f"{name}_film"] = film.numpy()
        res[f"{name}_per_shard"] = st["rays_cast_per_shard"].numpy()
        res[f"{name}_rays_cast"] = st["rays_cast"].numpy()
    o, d = job["rays"]
    res["trace"] = trace_sharded(scene, torch.from_numpy(o), torch.from_numpy(d), 2,
                                 prng_key(1), mesh).numpy()
    res["slices"] = np.asarray([[host_local_slice(r).start, host_local_slice(r).stop]
                                for r in ROWS])
    big = job["film"]
    res["assembled"] = assemble_film(torch.from_numpy(big[host_local_slice(big.shape[0])]))
    toml = job["toml"]
    for name, extra in (("mesh", []), ("telemetry", ["--telemetry", "2", "--nee"]),
                        ("progressive", ["--progressive", "4", "--checkpoint",
                                         os.path.join(out, "ck.npz")])):
        png = os.path.join(out, f"{name}_rank{rank}.png")
        rc, err = _cli(["render", toml, "-o", png, "--mesh", "3", "--device", "cpu",
                        "--dist-backend", "gloo"] + extra)
        assert rc == 0
        with open(os.path.join(out, f"{name}_rank{rank}.err"), "w") as fh:
            fh.write(err)
    # the telemetry command's sharded render, directly
    scene_t, cam_t, s_t, accel_cfg, _ = cli.load_scene_file(toml)
    _, st = render(scene_t, cam_t, dataclasses.replace(s_t, nee=True), prng_key(0),
                   accel=build_shaded_accel(scene_t, accel_cfg), mesh=mesh, return_stats=True)
    res["telemetry_per_shard"] = st["rays_cast_per_shard"].numpy()
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)


def _scene_tree():
    """``tests/test_sharding.py``'s NEE scene: a uv sphere and a light
    sphere, as the port's numpy tree (made by the JAX package)."""
    from atray_tpu.scene import build_scene, procedural
    from atray_tpu.scene.data import Spheres, make_materials
    from atray_tpu.scene.transforms import translate

    from test_torch_render import _tree

    mats = make_materials([
        ((0.05, 0.05, 0.08), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.8, 0.5, 0.3), 0.2),
        ((6.0, 5.0, 4.0), (0.0, 0.0, 0.0), 0.0),
    ])
    body = translate(procedural.uv_sphere(rows=8, cols=8, material=1), (0, 0, -4))
    spheres = Spheres(centers=np.asarray([[1.5, 2.0, -3.0]], np.float32),
                      radii=np.asarray([0.5], np.float32),
                      material_id=np.asarray([2], np.int32))
    return _tree(build_scene([body], spheres=spheres, materials=mats))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(job, {rank: results}, out dir) of the one spawn of 3 ranks."""
    out = str(tmp_path_factory.mktemp("dist_ranks"))
    toml = os.path.join(out, "scene.toml")
    with open(toml, "w") as fh:
        fh.write(TOML)
    rng = np.random.default_rng(3)
    cam = look_at_camera(EYE, TARGET, h_fov=0.9, aspect=1.0)
    o, d = camera_rays(cam, 8, 6, 1, device="cpu")        # 48 rays, 16 a rank
    job = {"scene": _scene_tree(), "rays": (o.numpy(), d.numpy()), "toml": toml,
           "film": rng.random((17, 5, 3)).astype(np.float32)}
    spawn_ranks(_dist_rank, job, out)
    res = {r: dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(WORLD)}
    return job, res, out


def _local(job, name):
    scene = scene_from_numpy(job["scene"])
    cam = look_at_camera(EYE, TARGET, h_fov=0.9, aspect=1.0)
    return render(scene, cam, SETTINGS[name], prng_key(5), device="cpu", return_stats=True)


@pytest.mark.parametrize("name", ["plain", "nee_chunked"])
def test_sharded_film_equals_local_bit_for_bit(ranks, name):
    # every rank holds the whole film, bit-equal to the one-rank render;
    # rays_cast sums the per-rank counts (one int64 a rank; unchunked, the
    # pad ray counts once more than the local render, at bounce 0, as in
    # the reference)
    job, res, _ = ranks
    film, st = _local(job, name)
    assert film.numpy().std() > 0.01
    for r in range(WORLD):
        assert list(res[r]["rank_world"]) == [r, WORLD]
        np.testing.assert_array_equal(res[r][f"{name}_film"], film.numpy())
        np.testing.assert_array_equal(res[r][f"{name}_per_shard"], res[0][f"{name}_per_shard"])
    per = res[0][f"{name}_per_shard"]
    assert per.shape == (WORLD,) and per.dtype == np.int64
    assert int(res[0][f"{name}_rays_cast"]) == per.sum()
    if name == "plain":
        assert per.sum() == int(st["rays_cast"]) + 1


def test_sharded_film_matches_jax_render_sharded(ranks, devices):
    # the JAX package's render on a mesh of 3 devices (brute force): the
    # film at test_render_oracle's tolerance, the per-shard counts equal
    import jax

    from atray_tpu.config import RenderSettings as JaxRenderSettings
    from atray_tpu.core.camera import look_at_camera as jax_look_at_camera
    from atray_tpu.dist.mesh import make_device_mesh as jax_make_device_mesh
    from atray_tpu.render.wavefront import render as jax_render

    job, res, _ = ranks
    s = SETTINGS["plain"]
    js = JaxRenderSettings(resolution=s.resolution, samples_per_pixel=s.samples_per_pixel,
                           bounce_limit=s.bounce_limit)
    jscene = _jax_scene(job["scene"])
    jcam = jax_look_at_camera(EYE, TARGET, h_fov=0.9, aspect=1.0)
    mesh = jax_make_device_mesh(WORLD)
    # jitted without LLVM's optimizations (tests/test_torch_nee.py's
    # FAST_COMPILE): the optimized build forks a path at one ulp on 3 of
    # these pixels, its local render too, where the unjitted render and
    # the port agree within 6e-8
    film, st = jax.jit(lambda k: jax_render(jscene, jcam, js, k, mesh=mesh, return_stats=True),
                       compiler_options={"xla_backend_optimization_level": 0}
                       )(jax.random.PRNGKey(5))
    np.testing.assert_allclose(res[0]["plain_film"], np.asarray(film), atol=2e-5)
    np.testing.assert_array_equal(res[0]["plain_per_shard"],
                                  np.asarray(st["rays_cast_per_shard"]).astype(np.int64))


def _jax_scene(tree):
    from atray_tpu.scene.data import Materials, Planes, Scene, Spheres, TriMesh

    return Scene(mesh=TriMesh(**tree["mesh"]), spheres=Spheres(**tree["spheres"]),
                 planes=Planes(**tree["planes"]), materials=Materials(**tree["materials"]))


def test_trace_sharded_equals_trace_radiance(ranks):
    # each rank traces its 16 rays under their global ids; the gathered
    # colours equal the one-rank trace bit for bit
    job, res, _ = ranks
    o, d = (torch.from_numpy(x) for x in job["rays"])
    want = trace_radiance(scene_from_numpy(job["scene"]), o, d, 2, prng_key(1)).numpy()
    for r in range(WORLD):
        np.testing.assert_array_equal(res[r]["trace"], want)


def test_host_local_slice_and_assemble_film(ranks):
    # the reference's arithmetic over film heights and ranks; the film's
    # row slices, gathered, are the film on every rank
    job, res, _ = ranks
    for r in range(WORLD):
        for (lo, hi), rows in zip(res[r]["slices"], ROWS):
            per = -(-rows // WORLD)
            want_lo = min(r * per, rows)
            assert (lo, hi) == (want_lo, min(want_lo + per, rows))
        np.testing.assert_array_equal(res[r]["assembled"], job["film"])
    # without a process group: rank 0 of 1, every row, the film itself
    assert process_info() == (0, 1) and host_local_slice(7) == slice(0, 7)
    np.testing.assert_array_equal(assemble_film(job["film"]), job["film"])


def test_cli_mesh_png_equals_one_rank(ranks, tmp_path):
    # `render --mesh 3` under 3 ranks: rank 0 writes the PNG, byte-equal to
    # the one-rank command's; the other ranks write nothing
    job, _, out = ranks
    one = str(tmp_path / "one.png")
    assert _cli(["render", job["toml"], "-o", one, "--device", "cpu"])[0] == 0
    with open(one, "rb") as a, open(os.path.join(out, "mesh_rank0.png"), "rb") as b:
        assert a.read() == b.read()
    assert not any(os.path.exists(os.path.join(out, f"mesh_rank{r}.png")) for r in (1, 2))
    err = open(os.path.join(out, "mesh_rank0.err")).read()
    assert "device mesh: 3 rank(s), backend gloo" in err and "render" in err
    assert open(os.path.join(out, "mesh_rank1.err")).read() == ""


def test_cli_mesh_telemetry_and_progressive(ranks, tmp_path):
    # --telemetry prints the per-shard row from the sharded render's
    # counts; --progressive renders each batch through the mesh, its PNG
    # byte-equal to the one-rank run's, and rank 0 alone writes the
    # checkpoint
    job, res, out = ranks
    err = open(os.path.join(out, "telemetry_rank0.err")).read()
    row = [line for line in err.splitlines() if line.startswith("shard live rays")]
    assert len(row) == 1
    nums = [float(x) for x in row[0].split()[3:]]
    per = res[0]["telemetry_per_shard"]
    assert nums[0] == per.min() and nums[3] == per.max()
    one = str(tmp_path / "prog.png")
    assert _cli(["render", job["toml"], "-o", one, "--device", "cpu", "--progressive", "4",
                 "--checkpoint", str(tmp_path / "ck.npz")])[0] == 0
    with open(one, "rb") as a, open(os.path.join(out, "progressive_rank0.png"), "rb") as b:
        assert a.read() == b.read()
    assert os.path.exists(os.path.join(out, "ck.npz"))
    assert "batch 2: 4 spp total" in open(os.path.join(out, "progressive_rank0.err")).read()


def test_make_device_mesh_takes_the_world(tmp_path):
    # one process without a group is a world of one rank: a mesh of 0 or
    # -1 ranks is that rank, any other count names both numbers
    init_distributed()                          # nothing given: no group
    assert not dist.is_initialized()
    for n in (0, -1):
        m = make_device_mesh(n, device="cpu")
        assert (m.size, m.rank, m.device.type, m.group) == (1, 0, "cpu", None)
    with pytest.raises(ValueError, match=r"mesh of 2 ranks .* has 1"):
        make_device_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="mesh of 8 ranks"):
        cli.main(["render", _write(tmp_path, TOML + "\n[mesh]\nnum_devices = 8\n"), "-o",
                  str(tmp_path / "x.png"), "--device", "cpu"])
    # a one-rank mesh renders the local film; its axis name is checked
    s = RenderSettings(resolution=(8, 6), samples_per_pixel=1, bounce_limit=2)
    scene, cam = cli.load_scene_file(_write(tmp_path, TOML))[:2]
    m = make_device_mesh(device="cpu")
    film, st = render(scene, cam, s, prng_key(2), mesh=m, return_stats=True)
    np.testing.assert_array_equal(film.numpy(), render(scene, cam, s, prng_key(2),
                                                       device="cpu").numpy())
    assert st["rays_cast_per_shard"].tolist() == [int(st["rays_cast"])]
    with pytest.raises(ValueError, match="not the mesh's"):
        render(scene, cam, s, prng_key(2), mesh=m, axis_name="tiles")


def _write(tmp_path, text, name="scene.toml"):
    path = tmp_path / name
    path.write_text(text)
    return str(path)

