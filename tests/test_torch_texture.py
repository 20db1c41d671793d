"""PyTorch port, textures: the tex-coord table and the texel lookup against
the JAX package's functions, the oracle's textured quad (twin of
``tests/test_render_oracle.py``'s textured cases) against the JAX render
and the numpy oracle, the shaded accel's textured film against brute
force, the texel gradient against ``jax.grad``, the backward's walk count,
and the compaction and chunking identities. The JAX side renders by brute
force only: no Pallas kernel, no interpret mode."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(2)

import oracle  # noqa: E402
from atray_tpu.config import RenderSettings as JaxRenderSettings  # noqa: E402
from atray_tpu.core.camera import look_at_camera as jax_look_at_camera  # noqa: E402
from atray_tpu.render import wavefront as jw  # noqa: E402
from atray_tpu.render.wavefront import draw_bounce_uniforms as jax_draw_uniforms  # noqa: E402
from atray_tpu.scene import build_scene as jax_build_scene  # noqa: E402
from atray_tpu.scene import procedural as jax_procedural  # noqa: E402
from atray_tpu.scene.data import Planes as JaxPlanes  # noqa: E402
from atray_tpu.scene.objio import load_obj as jax_load_obj  # noqa: E402
from atray_tpu.scene.transforms import translate as jax_translate  # noqa: E402
from test_render_oracle import _textured_scene  # noqa: E402

from test_torch_render import _tree  # noqa: E402

from atray_tpu_torch.accel.shaded import build_shaded_accel  # noqa: E402
from atray_tpu_torch.config import KDTreeConfig, RenderSettings  # noqa: E402
from atray_tpu_torch.core.camera import camera_rays, look_at_camera  # noqa: E402
from atray_tpu_torch.interop import scene_from_numpy  # noqa: E402
from atray_tpu_torch.kernels import _build  # noqa: E402
from atray_tpu_torch.render import wavefront as tw  # noqa: E402
from atray_tpu_torch.render.rng import prng_key  # noqa: E402

ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "assets")
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def port_scene(jscene):
    """The port's scene of a JAX scene, texture included, on the CPU."""
    tex = None if jscene.texture is None else np.asarray(jscene.texture, np.float32)
    return scene_from_numpy({**_tree(jscene), "texture": tex}).to("cpu")


def textured_mix():
    """The oracle's textured quad, ``Cube.obj`` with its tex coords, a
    cube without any, and a floor: faces with and without UVs, and a
    plane."""
    quad = _textured_scene()
    cube_uv = jax_translate(jax_load_obj(os.path.join(ASSET_DIR, "Cube.obj"), backend="python"),
                            (0.8, -0.2, -4.2))
    cube_plain = jax_translate(jax_procedural.cube(size=0.8, material=1), (-1.0, -0.4, -3.6))
    floor = JaxPlanes(normals=np.asarray([[0.0, 1.0, 0.0]], np.float32),
                      offsets=np.asarray([-1.2], np.float32),
                      material_id=np.asarray([1], np.int32))
    return jax_build_scene([quad.mesh, cube_uv, cube_plain], planes=floor,
                           materials=quad.materials, texture=quad.texture)


def test_build_face_uv_matches_jax():
    # Cube.obj's faces carry tex coords; procedural.cube's carry none
    jscene = textured_mix()
    got = tw.build_face_uv(port_scene(jscene)).numpy()
    want = np.asarray(jw.build_face_uv(jscene))
    np.testing.assert_array_equal(got, want)
    has = got[:, 6]
    assert has.min() == 0.0 and has.max() == 1.0


def test_texture_mod_matches_jax_below_and_above_the_unit_square():
    # UVs from -1.3 to 2.7 wrap several times; channel 0 of the texture is
    # the texel's flat index, so equal planes mean equal indices
    jscene = _textured_scene()
    uv = np.asarray([[-1.3, -1.1], [2.7, -1.1], [2.7, 2.6], [-1.3, 2.6]], np.float32)
    rng = np.random.default_rng(3)
    th, tw_ = 7, 9
    tex = rng.uniform(0.0, 1.0, (th, tw_, 3)).astype(np.float32)
    tex[..., 0] = np.arange(th * tw_, dtype=np.float32).reshape(th, tw_)
    jscene = dataclasses.replace(
        jscene, mesh=dataclasses.replace(jscene.mesh, tex_coords=uv), texture=tex)
    scene = port_scene(jscene)
    n = 4096
    o = np.stack([rng.uniform(-2.4, 2.4, n), np.full(n, 1.5), rng.uniform(-7.0, -2.0, n)], 1)
    d = np.stack([rng.normal(0, 0.05, n), -np.ones(n), rng.normal(0, 0.05, n)], 1)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = o.astype(np.float32)
    ids = tw.nearest_hit_ids(scene, torch.from_numpy(o), torch.from_numpy(d))
    tri_hit = ids.prim_type == tw.PRIM_TRI
    assert 0.3 < float(tri_hit.double().mean()) < 0.95
    planes = [torch.from_numpy(np.ascontiguousarray(x[:, k])) for x in (o, d) for k in range(3)]
    got = tw._texture_mod_soa(scene.texture, tw.build_face_table(scene), tw.build_face_uv(scene),
                              ids.prim_id, tri_hit, *planes)
    want = jw._texture_mod_soa(jnp.asarray(tex), jw.build_face_table(jscene),
                               jw.build_face_uv(jscene), jnp.asarray(ids.prim_id.numpy()),
                               jnp.asarray(tri_hit.numpy()), *(jnp.asarray(p.numpy()) for p in planes))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6)
    # every texel column and row is reached, misses keep 1.0
    idx = got[0].numpy()[tri_hit.numpy()].astype(np.int64)
    assert len(set(idx % tw_)) == tw_ and len(set(idx // tw_)) == th
    assert (got[1].numpy()[~tri_hit.numpy()] == 1.0).all()


def test_textured_quad_matches_jax_and_oracle():
    # the oracle suite's textured case (48x36, 2 spp, 2 bounces, explicit
    # uniforms), brute force on both sides
    jscene = _textured_scene()
    w, h, spp, bounces = 48, 36, 2, 2
    jcam = jax_look_at_camera((0.0, 0.5, 1.0), (0.0, 0.0, -4.0), h_fov=0.9, aspect=w / h)
    cam = look_at_camera((0.0, 0.5, 1.0), (0.0, 0.0, -4.0), h_fov=0.9, aspect=w / h)
    uni = jax_draw_uniforms(jax.random.PRNGKey(7), bounces, spp * h * w)
    js = JaxRenderSettings(resolution=(w, h), samples_per_pixel=spp, bounce_limit=bounces)
    want = np.asarray(jax.jit(lambda s: jw.render(s, jcam, js, jax.random.PRNGKey(42),
                                                  uniforms=uni))(jscene))
    s = RenderSettings(resolution=(w, h), samples_per_pixel=spp, bounce_limit=bounces)
    got = tw.render(port_scene(jscene), cam, s, prng_key(42),
                    uniforms=torch.from_numpy(np.array(uni)), device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    o, d = camera_rays(cam, w, h, spp, device="cpu")
    ref = oracle.render_film(jscene, o.numpy(), d.numpy(), bounces, np.asarray(uni), spp, h, w)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert got.std() > 0.05


def test_shaded_accel_textured_film_matches_brute_force():
    # the textured scene keeps the fast walk (wide_shade through
    # nearest_hit_ids) and shades through the gather path
    scene = port_scene(textured_mix())
    accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=4)).to("cpu")
    cam = look_at_camera((0.0, 0.5, 1.0), (0.0, -0.4, -4.0), h_fov=0.9, aspect=4 / 3)
    s = RenderSettings(resolution=(48, 36), samples_per_pixel=2, bounce_limit=3)
    brute = tw.render(scene, cam, s, prng_key(3), device="cpu")
    before = _build.COUNTERS["wide_shade"].plain_calls
    fast = tw.render(scene, cam, s, prng_key(3), accel=accel, device="cpu")
    assert _build.COUNTERS["wide_shade"].plain_calls - before == s.bounce_limit
    np.testing.assert_allclose(fast.numpy(), brute.numpy(), atol=1e-6)
    assert brute.std() > 0.05


@functools.lru_cache(maxsize=None)
def _jax_texel_grad(w, h):
    jscene = _textured_scene()
    jcam = jax_look_at_camera((0.0, 0.5, 1.0), (0.0, 0.0, -4.0), h_fov=0.9, aspect=w / h)
    js = JaxRenderSettings(resolution=(w, h), samples_per_pixel=1, bounce_limit=2)

    def loss(tex):
        return jnp.sum(jw.render(dataclasses.replace(jscene, texture=tex), jcam, js,
                                 jax.random.PRNGKey(0)))

    fn = jax.jit(jax.grad(loss)).lower(jnp.asarray(jscene.texture)).compile(FAST_COMPILE)
    return np.asarray(fn(jnp.asarray(jscene.texture)))


def test_texel_gradient_matches_jax():
    # the reference's texture-gradient case (24x24, 1 spp, 2 bounces)
    jscene = _textured_scene()
    w = h = 24
    want = _jax_texel_grad(w, h)
    scene = port_scene(jscene)
    cam = look_at_camera((0.0, 0.5, 1.0), (0.0, 0.0, -4.0), h_fov=0.9, aspect=1.0)
    s = RenderSettings(resolution=(w, h), samples_per_pixel=1, bounce_limit=2)
    tex = scene.texture.clone().requires_grad_()
    loss = tw.render(dataclasses.replace(scene, texture=tex), cam, s, prng_key(0),
                     device="cpu").sum()
    got, = torch.autograd.grad(loss, [tex])
    assert np.abs(want).max() > 1e-4
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())


def test_textured_backward_walks_no_bvh():
    # the hit ids are taken outside the checkpoint; the backward recomputes
    # the texel gather from them and walks nothing
    scene = port_scene(textured_mix())
    accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=4)).to("cpu")
    cam = look_at_camera((0.0, 0.5, 1.0), (0.0, -0.4, -4.0), h_fov=0.9, aspect=1.0)
    s = RenderSettings(resolution=(24, 24), samples_per_pixel=1, bounce_limit=3)
    tex = scene.texture.clone().requires_grad_()
    verts = scene.mesh.vertices.clone().requires_grad_()
    sc = dataclasses.replace(scene, texture=tex,
                             mesh=dataclasses.replace(scene.mesh, vertices=verts))
    counter = _build.COUNTERS["wide_shade"]
    c0 = counter.plain_calls
    loss = tw.render(sc, cam, s, prng_key(1), accel=accel, device="cpu").sum()
    c1 = counter.plain_calls
    g_tex, g_v = torch.autograd.grad(loss, [tex, verts])
    assert c1 - c0 == s.bounce_limit and counter.plain_calls == c1
    assert torch.isfinite(g_tex).all() and g_tex.abs().max() > 0
    assert torch.isfinite(g_v).all() and g_v.abs().max() > 0


def test_textured_sorted_packed_chunked_film_is_the_plain_film():
    scene = port_scene(textured_mix())
    accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=4)).to("cpu")
    cam = look_at_camera((0.0, 0.5, 1.0), (0.0, -0.4, -4.0), h_fov=0.9, aspect=4 / 3)
    base = RenderSettings(resolution=(32, 24), samples_per_pixel=2, bounce_limit=4,
                          sort_bounces=False, lane_pack=False)
    plain = tw.render(scene, cam, base, prng_key(6), accel=accel, device="cpu")
    for kw in ({"sort_bounces": True, "lane_pack": True},
               {"sort_bounces": True, "lane_pack": True, "ray_chunk": 500},
               {"pair_bounces": True}):
        film = tw.render(scene, cam, dataclasses.replace(base, **kw), prng_key(6),
                         accel=accel, device="cpu")
        assert torch.equal(film, plain), kw
