"""PyTorch port, the forward slice: films against the JAX renderer, the
port's own bit-identities, shading helpers, and the import boundary."""

import dataclasses
import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from atray_tpu.accel.shaded import build_shaded_accel as jax_build_shaded_accel  # noqa: E402
from atray_tpu.config import KDTreeConfig as JaxKDTreeConfig  # noqa: E402
from atray_tpu.config import RenderSettings as JaxRenderSettings  # noqa: E402
from atray_tpu.core.camera import camera_rays as jax_camera_rays  # noqa: E402
from atray_tpu.core.camera import look_at_camera as jax_look_at_camera  # noqa: E402
from atray_tpu.native import available as jax_native_available  # noqa: E402
from atray_tpu.render import film as jax_film  # noqa: E402
from atray_tpu.render import wavefront as jw  # noqa: E402
from atray_tpu.scene import build_scene as jax_build_scene  # noqa: E402
from atray_tpu.scene import procedural as jax_procedural  # noqa: E402
from atray_tpu.scene.data import Planes as JaxPlanes  # noqa: E402
from atray_tpu.scene.data import Spheres as JaxSpheres  # noqa: E402
from atray_tpu.scene.data import make_materials as jax_make_materials  # noqa: E402
from atray_tpu.scene.transforms import translate as jax_translate  # noqa: E402

from atray_tpu_torch.accel import wide as port_wide  # noqa: E402
from atray_tpu_torch.accel.bvh import build_bvh as port_build_bvh  # noqa: E402
from atray_tpu_torch.accel.shaded import build_shaded_accel  # noqa: E402
from atray_tpu_torch.config import KDTreeConfig, RenderSettings  # noqa: E402
from atray_tpu_torch.core.camera import camera_rays, look_at_camera  # noqa: E402
from atray_tpu_torch.interop import scene_from_numpy, shaded_accel_from_numpy  # noqa: E402
from atray_tpu_torch.render import film  # noqa: E402
from atray_tpu_torch.render import wavefront as tw  # noqa: E402
from atray_tpu_torch.render.rng import prng_key  # noqa: E402


def _tree(scene):
    return {k: {f.name: np.asarray(getattr(getattr(scene, k), f.name))
                for f in dataclasses.fields(getattr(scene, k))}
            for k in ("mesh", "spheres", "planes", "materials")}


def _accel_fields(accel):
    return {f.name: getattr(accel, f.name) for f in dataclasses.fields(accel)}


def jax_builder() -> str:
    """The BVH builder the JAX package's ``backend="auto"`` takes in this
    process: "native" once its library has loaded, else "numpy". Its loader
    does not retry a failed load, and under parallel test workers one worker
    can load the library while another is still writing it, so that worker's
    JAX builds stay on numpy. The two builders order triangles inside leaves
    differently; a test that compares tables (or hits) from the two packages'
    own builds pins the port to this builder."""
    return "native" if jax_native_available() else "numpy"


def pin_port_builder(monkeypatch) -> str:
    """Pin the builder of the port's ``make_accel``, ``wide_from_mesh`` and
    ``hybrid_from_mesh`` (which, as in the JAX package, take no backend
    argument) to ``jax_builder()`` for one test; returns that builder."""
    backend = jax_builder()
    monkeypatch.setattr(port_wide, "build_bvh", functools.partial(port_build_bvh, backend=backend))
    return backend


def _mixed_scene():
    """Sphere, plane and a smooth uv_sphere(12, 12): the scene of the
    reference's fused-vs-standard render test."""
    mats = jax_make_materials([
        ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.8, 0.5, 0.3), 0.2),
        ((2.0, 1.5, 1.0), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.5, 0.6, 0.7), 0.0),
    ])
    mesh = jax_translate(jax_procedural.uv_sphere(12, 12, material=1, smooth=True),
                         (0, 0, -4))
    spheres = JaxSpheres(centers=np.asarray([[1.5, 1.0, -3.5]], np.float32),
                         radii=np.asarray([0.5], np.float32),
                         material_id=np.asarray([2], np.int32))
    planes = JaxPlanes(normals=np.asarray([[0.0, 1.0, 0.0]], np.float32),
                       offsets=np.asarray([-1.4], np.float32),
                       material_id=np.asarray([3], np.int32))
    return jax_build_scene([mesh], spheres=spheres, planes=planes, materials=mats)


def _pack_scene():
    """The reference's lane-pack test scene (uv_sphere(10, 10) and a floor)."""
    mats = jax_make_materials([
        ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.75, 0.55, 0.35), 0.15),
        ((0.0, 0.0, 0.0), (0.6, 0.6, 0.65), 0.0),
    ])
    m = jax_translate(jax_procedural.uv_sphere(10, 10, material=1, smooth=True), (0, 0, -4))
    planes = JaxPlanes(normals=np.asarray([[0.0, 1.0, 0.0]], np.float32),
                       offsets=np.asarray([-1.4], np.float32),
                       material_id=np.asarray([2], np.int32))
    return jax_build_scene([m], planes=planes, materials=mats)


def test_fused_render_matches_jax_fused_render():
    # (a) the port's plain walk against the JAX Pallas kernel (interpret
    # mode) on identical tables. The JAX side renders unsorted, which the
    # reference guarantees is the same film as sorted, at a third of the
    # interpret-mode cost; the port renders with its default compaction.
    scene = _mixed_scene()
    ja = jax_build_shaded_accel(scene, JaxKDTreeConfig(leaf_size=8))
    jcam = jax_look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.0)
    ref, ref_stats = jw.render(
        scene, jcam, JaxRenderSettings(resolution=(24, 24), samples_per_pixel=2,
                                       bounce_limit=3, sort_bounces=False),
        jax.random.PRNGKey(5), accel=ja, return_stats=True)
    cam = look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.0)
    got, stats = tw.render(
        scene_from_numpy(_tree(scene)).to("cpu"), cam,
        RenderSettings(resolution=(24, 24), samples_per_pixel=2, bounce_limit=3),
        prng_key(5), accel=shaded_accel_from_numpy(_accel_fields(ja)).to("cpu"),
        return_stats=True, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5)
    assert int(stats["rays_cast"]) == int(ref_stats["rays_cast"])
    assert float(np.asarray(ref).std()) > 0.05


def test_sorted_packed_render_matches_jax_brute_force():
    # (b) sort + lane pack on (8192 rays) with the port's own accel,
    # against the JAX brute-force film. A grazing hit decided by one ulp
    # between XLA's CPU code and torch's eager ops can fork a path, hence
    # the 0.2% allowance.
    scene = _pack_scene()
    jcam = jax_look_at_camera((0, 0.6, 0.7), (0, 0, -4), h_fov=0.9, aspect=2.0)
    js = JaxRenderSettings(resolution=(128, 64), samples_per_pixel=1, bounce_limit=4)
    ref = np.asarray(jw.render(scene, jcam, js, jax.random.PRNGKey(0)))
    port_scene = scene_from_numpy(_tree(scene))
    accel = build_shaded_accel(port_scene, KDTreeConfig(leaf_size=8)).to("cpu")
    cam = look_at_camera((0, 0.6, 0.7), (0, 0, -4), h_fov=0.9, aspect=2.0)
    s = RenderSettings(resolution=(128, 64), samples_per_pixel=1, bounce_limit=4)
    got = tw.render(port_scene.to("cpu"), cam, s, prng_key(0), accel=accel, device="cpu").numpy()
    bad = np.abs(got - ref) > 1e-4
    assert bad.mean() <= 0.002, f"{int(bad.sum())} of {bad.size} values differ by > 1e-4"
    assert ref.std() > 0.01


@pytest.mark.parametrize("variant", ["compaction", "chunking"])
def test_port_film_bit_identities(variant):
    # (c) sorted + packed == unsorted, and chunked == whole, within the port
    scene = scene_from_numpy(_tree(_pack_scene())).to("cpu")
    accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=8)).to("cpu")
    cam = look_at_camera((0, 0.6, 0.7), (0, 0, -4), h_fov=0.9, aspect=2.0)
    base = dict(resolution=(128, 64), samples_per_pixel=1, bounce_limit=4)
    ref = tw.render(scene, cam, RenderSettings(**base), prng_key(1), accel=accel, device="cpu")
    if variant == "compaction":
        other = RenderSettings(**base, sort_bounces=False, lane_pack=False)
    else:
        other = RenderSettings(**base, ray_chunk=3000)     # ragged last chunk
    got = tw.render(scene, cam, other, prng_key(1), accel=accel, device="cpu")
    assert torch.equal(ref, got)
    assert float(ref.std()) > 0.01


def test_shading_helpers_match_jax(rng):
    n = 2000
    comp = [rng.normal(size=n).astype(np.float32) for _ in range(10)]
    u = [rng.uniform(-1, 1, n).astype(np.float32) for _ in range(3)]
    t_ = [torch.from_numpy(c) for c in comp]
    j_ = [jnp.asarray(c) for c in comp]
    want = jw._bounce_dir_soa(*j_[:6], jnp.abs(j_[6]) % 1.0, *[jnp.asarray(x) for x in u])
    got = tw._bounce_dir_soa(*t_[:6], torch.abs(t_[6]) % 1.0, *[torch.from_numpy(x) for x in u])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    cen = np.asarray([[0.0, 0.0, -1.0], [0.5, 0.2, 0.3]], np.float32)
    rad = np.asarray([0.7, 0.4], np.float32)
    ts, sid = tw._sphere_hits_soa(*t_[:6], torch.from_numpy(cen), torch.from_numpy(rad))
    jts, jsid = jw._sphere_hits_soa(*j_[:6], jnp.asarray(cen), jnp.asarray(rad))
    np.testing.assert_array_equal(sid.numpy(), np.asarray(jsid))
    # the disc = b*b - c cancellation moves t by an ulp between XLA and torch
    np.testing.assert_allclose(ts.numpy(), np.asarray(jts), rtol=1e-5)
    pn = np.asarray([[0.0, 1.0, 0.0], [0.6, 0.0, 0.8]], np.float32)
    po = np.asarray([-1.0, 0.5], np.float32)
    tp, pid = tw._plane_hits_soa(*t_[:6], torch.from_numpy(pn), torch.from_numpy(po))
    jtp, jpid = jw._plane_hits_soa(*j_[:6], jnp.asarray(pn), jnp.asarray(po))
    np.testing.assert_array_equal(pid.numpy(), np.asarray(jpid))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jtp), rtol=1e-5)
    mat = rng.integers(-1, 4, n).astype(np.int32)
    table = rng.normal(size=4).astype(np.float32)
    np.testing.assert_array_equal(
        tw.onehot_rows(torch.from_numpy(mat), torch.from_numpy(table)).numpy(),
        np.asarray(jw.onehot_rows(jnp.asarray(mat), jnp.asarray(table))))


def test_face_table_camera_tiles_and_film_match_jax():
    scene = _mixed_scene()
    port = scene_from_numpy(_tree(scene)).to("cpu")
    np.testing.assert_allclose(tw.build_face_table(port).numpy(),
                               np.asarray(jw.build_face_table(scene)), atol=1e-6)
    jcam = jax_look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.6)
    cam = look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.6)
    jo, jd = jax_camera_rays(jcam, 40, 25, 2)
    o, d = camera_rays(cam, 40, 25, 2, device="cpu")
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-6)
    x = np.arange(2 * 25 * 40 * 3, dtype=np.float32).reshape(-1, 3)
    tiled = tw.to_tile_order(torch.from_numpy(x), 40, 25, 2)
    np.testing.assert_array_equal(tiled.numpy(), np.asarray(jw.to_tile_order(jnp.asarray(x), 40, 25, 2)))
    np.testing.assert_array_equal(tw.from_tile_order(tiled, 40, 25, 2).numpy(), x)
    img = np.random.default_rng(2).uniform(-0.1, 1.1, (9, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(film.linear_to_srgb(torch.from_numpy(img)).numpy(),
                               np.asarray(jax_film.linear_to_srgb(jnp.asarray(img))), atol=1e-6)
    np.testing.assert_array_equal(film.to_uint8(torch.from_numpy(img)), jax_film.to_uint8(img))
    u8 = jax_film.to_uint8(img)
    assert film.encode_png(u8) == jax_film.encode_png(u8)


def test_unported_options_raise():
    # textures were the last render option to port, and no option raises
    # now: a textured scene renders from render() and trace_radiance(),
    # with and without an accel, and a texture of ones gives the
    # untextured film (through the gather path, not the fused hit)
    plain = scene_from_numpy(_tree(_pack_scene())).to("cpu")
    scene = dataclasses.replace(plain, texture=torch.ones((4, 4, 3)))
    accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=8)).to("cpu")
    cam = look_at_camera((0, 0.6, 0.7), (0, 0, -4), h_fov=0.9, aspect=2.0)
    s = RenderSettings(resolution=(16, 8), samples_per_pixel=1)
    for acc in (accel, None):
        got = tw.render(scene, cam, s, prng_key(0), accel=acc, device="cpu")
        want = tw.render(plain, cam, s, prng_key(0), accel=acc, device="cpu")
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    o, d = camera_rays(cam, 16, 8, 1, device="cpu")
    got = tw.trace_radiance(scene, o, d, 2, prng_key(0), accel=accel)
    want = tw.trace_radiance(plain, o, d, 2, prng_key(0), accel=accel)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "import atray_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(atray_tpu_torch.__path__, 'atray_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "assert not any(k == 'atray_tpu' or k.startswith('atray_tpu.') for k in sys.modules)\n"
        "print(' '.join(names))\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=root)
    assert out.returncode == 0, out.stderr
    # the package's 55 modules, dist.train, kernels.wide_exact, the seven
    # of probes/, scene.objio, and the host surfaces among them; and
    # chip_smoke.py
    names = set(out.stdout.split())
    assert len(names) >= 55
    assert {"atray_tpu_torch.cli", "atray_tpu_torch.utils.debugviz",
            "atray_tpu_torch.examples.render_demo", "atray_tpu_torch.native.bindings",
            "atray_tpu_torch.scene.objio"} <= names
