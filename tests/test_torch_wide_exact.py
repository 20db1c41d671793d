"""PyTorch port, the trainer's accel: ``pack_bvh`` and ``make_accel``
tables, ``refit_wide`` and ``refit_shaded``, the ``wide_exact`` walk
(``kernels/wide_exact.py``) against the JAX Pallas kernel (interpret mode),
the intersection helpers, and the gather path (``nearest_hit_ids`` +
``resolve_hit``) against the JAX package."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from atray_tpu.accel.bvh import build_bvh as jax_build_bvh  # noqa: E402
from atray_tpu.accel.shaded import build_shaded_accel as jax_build_shaded_accel  # noqa: E402
from atray_tpu.accel.shaded import refit_shaded as jax_refit_shaded  # noqa: E402
from atray_tpu.accel.wide import make_accel as jax_make_accel  # noqa: E402
from atray_tpu.accel.wide import refit_wide as jax_refit_wide  # noqa: E402
from atray_tpu.config import KDTreeConfig as JaxKDTreeConfig  # noqa: E402
from atray_tpu.core import intersect as jax_intersect  # noqa: E402
from atray_tpu.kernels.traverse_pallas import pack_bvh as jax_pack_bvh  # noqa: E402
from atray_tpu.kernels.wide_exact import wide_exact_first_hit as jax_wide_exact  # noqa: E402
from atray_tpu.render import wavefront as jw  # noqa: E402
from atray_tpu.scene import build_scene as jax_build_scene  # noqa: E402
from atray_tpu.scene import procedural as jax_procedural  # noqa: E402
from atray_tpu.scene.data import make_materials as jax_make_materials  # noqa: E402
from test_torch_render import _mixed_scene, _tree, jax_builder, pin_port_builder  # noqa: E402

from atray_tpu_torch.accel.bvh import build_bvh  # noqa: E402
from atray_tpu_torch.accel.pack import pack_bvh  # noqa: E402
from atray_tpu_torch.accel.shaded import build_shaded_accel, refit_shaded  # noqa: E402
from atray_tpu_torch.accel.wide import make_accel, refit_wide  # noqa: E402
from atray_tpu_torch.config import KDTreeConfig, RenderSettings  # noqa: E402
from atray_tpu_torch.core import intersect  # noqa: E402
from atray_tpu_torch.core.camera import camera_rays, look_at_camera  # noqa: E402
from atray_tpu_torch.interop import scene_from_numpy, wide_accel_from_numpy  # noqa: E402
from atray_tpu_torch.kernels import _build  # noqa: E402
from atray_tpu_torch.kernels.wide_exact import (  # noqa: E402
    wide_exact2_first_hit,
    wide_exact_first_hit,
    wide_exact_ref,
)
from atray_tpu_torch.render import wavefront as tw  # noqa: E402
from atray_tpu_torch.render.rng import prng_key  # noqa: E402
from atray_tpu_torch.scene import procedural  # noqa: E402

MESHES = [("cube", ()), ("uv_sphere", (10, 10)), ("dragon_proxy", (2000,))]
WIDE_FIELDS = ("cboxes", "clinks", "caxis", "tris", "slot_face", "build_vertices")


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name,args", MESHES)
def test_pack_and_make_accel_tables_bit_equal(name, args, monkeypatch):
    backend = pin_port_builder(monkeypatch)
    ref_mesh = getattr(jax_procedural, name)(*args)
    mesh = getattr(procedural, name)(*args)
    for leaf_size in (8, 16):
        ref = jax_make_accel(ref_mesh.vertices, ref_mesh.faces, JaxKDTreeConfig(leaf_size=leaf_size))
        got = make_accel(mesh.vertices, mesh.faces, KDTreeConfig(leaf_size=leaf_size))
        for f in WIDE_FIELDS:
            a, b = np.asarray(getattr(ref, f)), getattr(got, f)
            assert a.shape == b.shape and a.dtype == b.dtype, f
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f)
        for f in ("leaf_size", "num_nodes", "max_depth"):
            assert getattr(ref, f) == getattr(got, f), f
    cfg = dict(leaf_size=8)
    jp = jax_pack_bvh(jax_build_bvh(ref_mesh.vertices, ref_mesh.faces, JaxKDTreeConfig(**cfg)))
    tp = pack_bvh(build_bvh(mesh.vertices, mesh.faces, KDTreeConfig(**cfg), backend=backend))
    assert tp.tris.dtype == np.float32
    np.testing.assert_array_equal(_bits(jp.tris), _bits(tp.tris))


def _random_rays(rng, n):
    # the rays of the reference's wide_exact test
    orig = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return orig, d.astype(np.float32)


def test_plain_walk_matches_jax_wide_exact(rng):
    mesh = jax_procedural.uv_sphere(rows=16, cols=16)
    ja = jax_make_accel(mesh.vertices, mesh.faces, JaxKDTreeConfig(leaf_size=8))
    orig, dirn = _random_rays(rng, 1500)
    t1, u1, v1, i1 = (np.asarray(x) for x in jax_wide_exact(ja, jnp.asarray(orig),
                                                            jnp.asarray(dirn), interpret=True))
    accel = wide_accel_from_numpy({f.name: getattr(ja, f.name)
                                   for f in dataclasses.fields(ja)}).to("cpu")
    before = _build.COUNTERS["wide_exact"].plain_calls
    t2, u2, v2, i2 = (x.numpy() for x in wide_exact_first_hit(
        accel, torch.from_numpy(orig), torch.from_numpy(dirn)))
    assert _build.COUNTERS["wide_exact"].plain_calls == before + 1
    assert i2.dtype == np.int32
    np.testing.assert_array_equal(i2, i1)
    np.testing.assert_allclose(t2, t1, rtol=1e-5)
    hit = i1 >= 0
    assert hit.sum() > 30
    np.testing.assert_allclose(u2[hit], u1[hit], atol=1e-5)
    np.testing.assert_allclose(v2[hit], v1[hit], atol=1e-5)
    assert np.all(u2[~hit] == 0) and np.all(v2[~hit] == 0)
    assert wide_exact2_first_hit is wide_exact_first_hit


def _moved(rng, mesh):
    return (np.asarray(mesh.vertices)
            + rng.normal(0.0, 0.02, np.shape(mesh.vertices)).astype(np.float32))


def test_refit_wide_matches_jax_and_brute_force(rng, monkeypatch):
    pin_port_builder(monkeypatch)
    mesh = jax_procedural.uv_sphere(rows=12, cols=12)
    cfg = KDTreeConfig(leaf_size=8)
    v_new = _moved(rng, mesh)
    ref = jax_refit_wide(jax_make_accel(mesh.vertices, mesh.faces, JaxKDTreeConfig(leaf_size=8)),
                         jnp.asarray(v_new), jnp.asarray(mesh.faces))
    port = make_accel(np.asarray(mesh.vertices), np.asarray(mesh.faces), cfg).to("cpu")
    got = refit_wide(port, torch.from_numpy(v_new), torch.from_numpy(np.asarray(mesh.faces)))
    tri_r = np.asarray(ref.tris).reshape(-1, 16)
    tri_g = got.tris.numpy().reshape(-1, 16)
    np.testing.assert_array_equal(tri_g.view(np.int32)[:, 9], tri_r.view(np.int32)[:, 9])
    np.testing.assert_allclose(tri_g[:, :9], tri_r[:, :9], atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got.cboxes.numpy(), np.asarray(ref.cboxes), rtol=1e-6)
    np.testing.assert_array_equal(got.clinks.numpy(), np.asarray(ref.clinks))
    assert not got.tris.requires_grad
    # the walk over the refitted tables finds the brute-force nearest hit
    n = 256
    o = rng.normal(0, 3.0, (n, 3)).astype(np.float32)
    d = (o / np.linalg.norm(o, axis=1, keepdims=True)).astype(np.float32)
    o = (-3.0 * d).astype(np.float32)
    t_k, _, _, id_k = wide_exact_first_hit(got, torch.from_numpy(o), torch.from_numpy(d))
    f = np.asarray(mesh.faces)
    p0 = v_new[f[:, 0]]
    t_b, _, _, hit_b = intersect.moller_trumbore(
        torch.from_numpy(o)[:, None], torch.from_numpy(d)[:, None], torch.from_numpy(p0)[None],
        torch.from_numpy(v_new[f[:, 1]] - p0)[None], torch.from_numpy(v_new[f[:, 2]] - p0)[None])
    id_b = torch.where(hit_b.any(1), torch.argmin(t_b, dim=1), -1)
    np.testing.assert_array_equal(id_k.numpy(), id_b.numpy())
    np.testing.assert_allclose(t_k.numpy(), t_b.min(dim=1).values.numpy(), rtol=1e-5)
    assert int((id_b >= 0).sum()) > 100


def test_refit_shaded_matches_jax(rng):
    backend = jax_builder()
    mesh = jax_procedural.uv_sphere(rows=12, cols=12)
    mats = jax_make_materials([((0.1, 0.1, 0.1), (0.0, 0.0, 0.0), 0.0),
                               ((0.0, 0.0, 0.0), (0.5, 0.5, 0.5), 0.0)])
    scene = jax_build_scene([mesh], materials=mats)
    cfg = dict(leaf_size=8, leaves_per_treelet=2)
    ja = jax_build_shaded_accel(scene, JaxKDTreeConfig(**cfg))
    v_new = _moved(rng, mesh)
    scene2 = scene.with_params(dataclasses.replace(scene.params(), vertices=jnp.asarray(v_new)))
    ref = jax_refit_shaded(ja, scene2)
    port_scene = scene_from_numpy(_tree(scene)).to("cpu")
    port = build_shaded_accel(port_scene, KDTreeConfig(**cfg), backend=backend).to("cpu")
    moved = port_scene.with_params(dataclasses.replace(port_scene.params(),
                                                       vertices=torch.from_numpy(v_new)))
    got = refit_shaded(port, moved)
    tri_r = np.asarray(ref.tris).reshape(-1, 32)
    tri_g = got.tris.numpy().reshape(-1, 32)
    np.testing.assert_array_equal(tri_g.view(np.int32)[:, 9], tri_r.view(np.int32)[:, 9])
    np.testing.assert_array_equal(tri_g[:, 19], tri_r[:, 19])          # material ids
    np.testing.assert_allclose(np.delete(tri_g, 9, axis=1), np.delete(tri_r, 9, axis=1),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(got.cboxes.numpy(), np.asarray(ref.cboxes), rtol=1e-6)
    np.testing.assert_allclose(got.tboxes.numpy(), np.asarray(ref.tboxes), rtol=1e-6)
    assert np.isnan(got.tboxes.numpy()).sum() == np.isnan(np.asarray(ref.tboxes)).sum()


def test_intersect_helpers_match_jax(rng):
    r, t = 300, 40
    o = rng.normal(size=(r, 3)).astype(np.float32)
    d = rng.normal(size=(r, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    p0 = rng.normal(size=(t, 3)).astype(np.float32)
    e1 = rng.normal(size=(t, 3)).astype(np.float32)
    e2 = rng.normal(size=(t, 3)).astype(np.float32)
    for cull in (True, False):
        want = jax_intersect.moller_trumbore(
            jnp.asarray(o)[:, None], jnp.asarray(d)[:, None], jnp.asarray(p0)[None],
            jnp.asarray(e1)[None], jnp.asarray(e2)[None], backface_cull=cull)
        got = intersect.moller_trumbore(
            torch.from_numpy(o)[:, None], torch.from_numpy(d)[:, None], torch.from_numpy(p0)[None],
            torch.from_numpy(e1)[None], torch.from_numpy(e2)[None], backface_cull=cull)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        for a, b in zip(got[:3], want[:3]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
        assert got[3].any()
    cen = rng.normal(size=(3, 3)).astype(np.float32)
    rad = np.float32([0.5, 0.8, 0.3])
    ts, sid = intersect.sphere_hits(torch.from_numpy(o), torch.from_numpy(d),
                                    torch.from_numpy(cen), torch.from_numpy(rad))
    jts, jsid = jax_intersect.sphere_hits(jnp.asarray(o), jnp.asarray(d), jnp.asarray(cen),
                                          jnp.asarray(rad))
    np.testing.assert_array_equal(sid.numpy(), np.asarray(jsid))
    np.testing.assert_allclose(ts.numpy(), np.asarray(jts), rtol=1e-5)
    pn = np.float32([[0.0, 1.0, 0.0], [0.6, 0.0, 0.8]])
    po = np.float32([-1.0, 0.5])
    tp, pid = intersect.plane_hits(torch.from_numpy(o), torch.from_numpy(d),
                                   torch.from_numpy(pn), torch.from_numpy(po))
    jtp, jpid = jax_intersect.plane_hits(jnp.asarray(o), jnp.asarray(d), jnp.asarray(pn),
                                         jnp.asarray(po))
    np.testing.assert_array_equal(pid.numpy(), np.asarray(jpid))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jtp), rtol=1e-5)
    assert (sid >= 0).any() and (pid >= 0).any()


def test_gather_path_matches_jax():
    # nearest_hit_ids over every primitive class (the port's make_accel
    # walk vs the reference's brute force), then resolve_hit on the SAME
    # ids in both packages
    scene = _mixed_scene()
    port = scene_from_numpy(_tree(scene)).to("cpu")
    accel = make_accel(port.mesh.vertices, port.mesh.faces, KDTreeConfig(leaf_size=8)).to("cpu")
    cam = look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=1.2, aspect=1.0)
    o, d = (x.numpy() for x in camera_rays(cam, 48, 48, 1, device="cpu"))
    ref = jw.nearest_hit_ids(scene, jnp.asarray(o), jnp.asarray(d))
    got = tw.nearest_hit_ids(port, torch.from_numpy(o), torch.from_numpy(d), accel)
    kinds = np.asarray(ref.prim_type)
    assert all((kinds == k).sum() > 20 for k in (0, 1, 2, 3))
    differ = (got.prim_id.numpy() != np.asarray(ref.prim_id)) | (got.prim_type.numpy() != kinds)
    assert differ.sum() <= 2, f"{differ.sum()} hit ids differ (equal-t ties may)"
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), rtol=1e-5)

    ids = tw.HitIds(*(torch.from_numpy(np.array(x)) for x in ref))
    want = jw.resolve_hit(scene, jnp.asarray(o), jnp.asarray(d), ref,
                          face_table=jw.build_face_table(scene))
    have = tw.resolve_hit(port, torch.from_numpy(o), torch.from_numpy(d), ids,
                          face_table=tw.build_face_table(port))
    hit = np.asarray(want[3])
    np.testing.assert_array_equal(have[3].numpy(), hit)
    np.testing.assert_array_equal(have[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(have[0].numpy()[hit], np.asarray(want[0])[hit], rtol=1e-5)
    np.testing.assert_allclose(have[1].numpy(), np.asarray(want[1]), atol=1e-5)


def test_gather_path_render_matches_fused_render():
    # the port's two hit paths render the same film (the reference's
    # fused-vs-standard test, within the port)
    scene = scene_from_numpy(_tree(_mixed_scene())).to("cpu")
    cfg = KDTreeConfig(leaf_size=8)
    cam = look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.0)
    s = RenderSettings(resolution=(24, 24), samples_per_pixel=2, bounce_limit=3)
    std = tw.render(scene, cam, s, prng_key(5), device="cpu",
                    accel=make_accel(scene.mesh.vertices, scene.mesh.faces, cfg))
    fused = tw.render(scene, cam, s, prng_key(5), device="cpu",
                      accel=build_shaded_accel(scene, cfg))
    np.testing.assert_allclose(std.numpy(), fused.numpy(), atol=5e-5)
    assert float(std.std()) > 0.05


def test_wrapper_checks_inputs_and_builds_nothing_on_cpu(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the CUDA kernels")

    monkeypatch.setattr(_build, "load", no_build)
    host = make_accel(*(np.asarray(getattr(procedural.cube(), k)) for k in ("vertices", "faces")))
    accel = host.to("cpu")
    o = torch.tensor([[0.0, 0.0, 3.0]]).repeat(4, 1)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)
    t, _, _, fid = wide_exact_first_hit(accel, o, d)
    assert fid.dtype == torch.int32 and torch.all(fid >= 0)
    np.testing.assert_allclose(t.numpy(), 2.0)
    with pytest.raises(TypeError):
        wide_exact_first_hit(host, o, d)                       # not uploaded
    with pytest.raises(TypeError):
        wide_exact_first_hit(accel, o.double(), d)
    with pytest.raises(TypeError):
        wide_exact_first_hit(accel, o[:, :2].contiguous(), d)
    with pytest.raises(ValueError):
        wide_exact_first_hit(accel, torch.zeros((3, 4)).t(), d)
    with pytest.raises(ValueError, match="STACK_CAP"):
        wide_exact_first_hit(dataclasses.replace(accel, max_depth=40), o, d)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    mesh = procedural.dragon_proxy(target_tris=20000)
    accel = make_accel(mesh.vertices, mesh.faces, KDTreeConfig(leaf_size=16)).to(dev)
    o, d = _random_rays(np.random.default_rng(5), 20000)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    got = wide_exact_first_hit(accel, o, d)
    want = wide_exact_ref(accel, o, d)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
