"""PyTorch port, next-event estimation: sphere and area lights against the
numpy oracle (twins of ``tests/test_render_oracle.py``'s NEE cases, with
their outlier rule), against the JAX package's brute-force NEE render
(films and ``jax.grad`` gradients), with the port's shaded accel, the
variance tests, and the backward's walk count. The JAX side renders by
brute force only: no Pallas kernel, no interpret mode."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import oracle  # noqa: E402
from atray_tpu.config import RenderSettings as JaxRenderSettings  # noqa: E402
from atray_tpu.core.camera import camera_rays as jax_camera_rays  # noqa: E402
from atray_tpu.core.camera import look_at_camera as jax_look_at_camera  # noqa: E402
from atray_tpu.render import wavefront as jw  # noqa: E402
from atray_tpu.scene import build_scene as jax_build_scene  # noqa: E402
from atray_tpu.scene import procedural as jax_procedural  # noqa: E402
from atray_tpu.scene.data import Planes as JaxPlanes  # noqa: E402
from atray_tpu.scene.data import Spheres as JaxSpheres  # noqa: E402
from atray_tpu.scene.data import make_materials as jax_make_materials  # noqa: E402
from atray_tpu.scene.transforms import translate as jax_translate  # noqa: E402

from test_torch_render import _tree  # noqa: E402

from atray_tpu_torch.accel.shaded import build_shaded_accel  # noqa: E402
from atray_tpu_torch.config import KDTreeConfig, RenderSettings  # noqa: E402
from atray_tpu_torch.core.camera import camera_rays, look_at_camera  # noqa: E402
from atray_tpu_torch.interop import scene_from_numpy  # noqa: E402
from atray_tpu_torch.kernels import _build  # noqa: E402
from atray_tpu_torch.render import wavefront as tw  # noqa: E402
from atray_tpu_torch.render.rng import draw_bounce_uniforms, prng_key  # noqa: E402
from atray_tpu_torch.scene.data import SceneParams  # noqa: E402

FIELDS = ("vertices", "normals", "emission", "albedo", "scatter")
# the JAX references compile without LLVM's optimizations: the same
# float32 ops (gradients within 2e-7 of the optimized build), a fifth
# less compile time, which is most of this file's cost
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def _floor(offset, material):
    return JaxPlanes(normals=np.asarray([[0.0, 1.0, 0.0]], np.float32),
                     offsets=np.asarray([offset], np.float32),
                     material_id=np.asarray([material], np.int32))


def sphere_scene():
    """``tests/test_render_oracle.py``'s full scene: a glossy cube, a
    mirror sphere, a light sphere and a floor."""
    mats = jax_make_materials([
        ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.7, 0.7, 0.7), 0.0),
        ((0.0, 0.0, 0.0), (0.8, 0.2, 0.2), 0.7),
        ((4.0, 3.5, 3.0), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.95, 0.95, 0.95), 1.0),
    ])
    cube = jax_translate(jax_procedural.cube(size=1.5, material=2), (0.0, -0.5, -4.0))
    spheres = JaxSpheres(centers=np.asarray([[1.6, 0.2, -5.0], [-1.5, 2.0, -4.0]], np.float32),
                         radii=np.asarray([0.8, 0.6], np.float32),
                         material_id=np.asarray([4, 3], np.int32))
    return jax_build_scene([cube], spheres=spheres, planes=_floor(-1.5, 1), materials=mats)


def area_scene():
    """``tests/test_render_oracle.py``'s area-light scene: a cube on a
    floor under an emissive quad (two triangle lights)."""
    mats = jax_make_materials([
        ((0.02, 0.02, 0.03), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.7, 0.6, 0.5), 0.1),
        ((0.0, 0.0, 0.0), (0.6, 0.6, 0.6), 0.0),
        ((25.0, 22.0, 18.0), (0.0, 0.0, 0.0), 0.0),
    ])
    cube = jax_translate(jax_procedural.cube(size=1.2, material=1), (0.0, -0.4, -4.0))
    panel = jax_procedural.quad((-0.6, 1.6, -4.6), (0.6, 1.6, -4.6), (0.6, 1.6, -3.4),
                                (-0.6, 1.6, -3.4), material=3)
    return jax_build_scene([cube, panel], planes=_floor(-1.0, 2), materials=mats)


# light -> (scene, camera eye, camera target, uniform seed, max |diff|)
NEE = {
    "sphere": (sphere_scene, (0.0, 0.5, 1.0), (0.0, 0.0, -4.0), 7, 1e-2),
    "area": (area_scene, (0.0, 0.6, 0.2), (0.0, -0.2, -4.0), 9, 2e-2),
}


def _nee_case(light, w=32, h=24, spp=2, bounces=3):
    make, eye, target, useed, _ = NEE[light]
    jscene = make()
    cam = look_at_camera(eye, target, h_fov=0.9, aspect=w / h)
    jcam = jax_look_at_camera(eye, target, h_fov=0.9, aspect=w / h)
    s = RenderSettings(resolution=(w, h), samples_per_pixel=spp, bounce_limit=bounces, nee=True)
    return jscene, scene_from_numpy(_tree(jscene)).to("cpu"), cam, jcam, s, useed


@pytest.mark.parametrize("light", list(NEE))
def test_nee_matches_oracle(light):
    # the oracle test's rule: at most 15 channel values beyond 2e-4 (a
    # discrete flip where the oracle's numpy rounds the other way)
    jscene, scene, cam, _, s, useed = _nee_case(light)
    (w, h), spp, bounces = s.resolution, s.samples_per_pixel, s.bounce_limit
    uni = draw_bounce_uniforms(prng_key(useed), bounces, spp * h * w, channels=6, device="cpu")
    film = tw.render(scene, cam, s, prng_key(1), uniforms=uni, device="cpu").numpy()
    o, d = camera_rays(cam, w, h, spp, device="cpu")
    ref = oracle.render_film(jscene, o.numpy(), d.numpy(), bounces, uni.numpy(), spp, h, w,
                             nee=True)
    diff = np.abs(film - ref)
    assert (diff > 2e-4).sum() <= 3 * 5, f"{(diff > 2e-4).sum()} values beyond 2e-4"
    assert diff.max() <= NEE[light][4]
    if light == "area":
        assert film.max() > 0.05          # the panel lights the scene


def both_scene():
    """The sphere scene with an emissive quad over the cube: a light
    sphere and two triangle lights."""
    base = sphere_scene()
    cube = jax_translate(jax_procedural.cube(size=1.5, material=2), (0.0, -0.5, -4.0))
    panel = jax_procedural.quad((-0.5, 1.4, -4.5), (0.5, 1.4, -4.5), (0.5, 1.4, -3.5),
                                (-0.5, 1.4, -3.5), material=3)
    return jax_build_scene([cube, panel], spheres=base.spheres, planes=base.planes,
                           materials=base.materials)


BOTH_EYE, BOTH_TARGET, BOTH_RES = (0.0, 0.5, 1.0), (0.0, 0.0, -4.0), (64, 32)


@functools.lru_cache(maxsize=1)
def _jax_both_film():
    """The JAX brute-force NEE film of ``both_scene`` (64x32 x 2 spp x 3
    bounces, key 3), rendered once for the tests that hold the port to it."""
    w, h = BOTH_RES
    js = JaxRenderSettings(resolution=(w, h), samples_per_pixel=2, bounce_limit=3, nee=True)
    jcam = jax_look_at_camera(BOTH_EYE, BOTH_TARGET, h_fov=0.9, aspect=w / h)
    scene = both_scene()
    return np.asarray(jax.jit(lambda k: jw.render(scene, jcam, js, k),
                              compiler_options=FAST_COMPILE)(jax.random.PRNGKey(3)))


@pytest.mark.parametrize("accel", ["brute force", "shaded accel"])
def test_nee_film_matches_jax_brute_force(accel):
    # the port's keyed NEE film (sort + pack on), by brute force or through
    # its shaded accel (the plain wide_shade for the hits and the shadow
    # rays), against the JAX brute-force film of the same key: at most 0.2%
    # of values beyond 1e-4
    ref = _jax_both_film()
    w, h = BOTH_RES
    scene = scene_from_numpy(_tree(both_scene())).to("cpu")
    cam = look_at_camera(BOTH_EYE, BOTH_TARGET, h_fov=0.9, aspect=w / h)
    s = RenderSettings(resolution=(w, h), samples_per_pixel=2, bounce_limit=3, nee=True)
    acc = None
    if accel == "shaded accel":
        acc = build_shaded_accel(scene, KDTreeConfig(leaf_size=8)).to("cpu")
    before = _build.COUNTERS["wide_shade"].plain_calls
    got = tw.render(scene, cam, s, prng_key(3), accel=acc, device="cpu").numpy()
    if acc is not None:
        assert _build.COUNTERS["wide_shade"].plain_calls == before + 2 * 3   # hits, shadow rays
    bad = np.abs(got - ref) > 1e-4
    assert bad.mean() <= 0.002, f"{int(bad.sum())} of {bad.size} values beyond 1e-4"
    assert ref.std() > 0.01


def _variance_scene(light):
    mats = jax_make_materials([
        ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.7, 0.7, 0.7), 0.0),
        ((60.0, 60.0, 60.0) if light == "sphere" else (400.0, 400.0, 400.0),
         (0.0, 0.0, 0.0), 0.0),
    ])
    if light == "sphere":
        spheres = JaxSpheres(centers=np.asarray([[0.0, 2.5, -4.0]], np.float32),
                             radii=np.asarray([0.15], np.float32),
                             material_id=np.asarray([2], np.int32))
        return jax_build_scene([], spheres=spheres, planes=_floor(-1.0, 1), materials=mats), 16
    panel = jax_procedural.quad((-0.15, 2.5, -4.15), (0.15, 2.5, -4.15), (0.15, 2.5, -3.85),
                                (-0.15, 2.5, -3.85), material=2)
    return jax_build_scene([panel], planes=_floor(-1.0, 1), materials=mats), 24


@pytest.mark.parametrize("light", ["sphere", "area"])
def test_nee_reduces_variance_of_small_light(light):
    # shadow rays to a small bright light: NEE films over four keys agree
    # far better than path-traced ones
    jscene, res = _variance_scene(light)
    scene = scene_from_numpy(_tree(jscene)).to("cpu")
    cam = look_at_camera((0.0, 0.5, 0.0), (0.0, -0.2, -4.0), h_fov=0.8, aspect=1.0)
    spp = 4 if light == "sphere" else 2

    def films(nee):
        s = RenderSettings(resolution=(res, res), samples_per_pixel=spp, bounce_limit=3, nee=nee)
        return np.stack([tw.render(scene, cam, s, prng_key(k), device="cpu").numpy()
                         for k in range(4)])

    f_nee, f_pt = films(True), films(False)
    assert np.var(f_nee, axis=0).mean() < np.var(f_pt, axis=0).mean() * 0.5
    if light == "area":
        assert f_nee.mean() > 1e-3


def test_nee_grads_match_jax_brute_force():
    # autograd of the port's NEE trace, by brute force and through its
    # shaded accel (the plain wide_shade for the hits and the shadow rays,
    # the fused hit's replay, the checkpointed shading), against jax.grad of
    # the JAX brute-force one, same uniforms, on a scene with a sphere light
    # and two triangle lights; the JAX side gets the area lights' ids
    # explicitly, since its own detection sees tracers under jax.grad
    # (remat off: the same gradient, compiled faster)
    jscene = both_scene()
    scene = scene_from_numpy(_tree(jscene)).to("cpu")
    bounces = 3
    cam = look_at_camera(BOTH_EYE, BOTH_TARGET, h_fov=0.9, aspect=1.0)
    jcam = jax_look_at_camera(BOTH_EYE, BOTH_TARGET, h_fov=0.9, aspect=1.0)
    o, d = camera_rays(cam, 12, 12, 1, device="cpu")
    uni = draw_bounce_uniforms(prng_key(7), bounces, o.shape[0], channels=6, device="cpu")
    jo, jd = jax_camera_rays(jcam, 12, 12, 1)
    tl = jw._static_tri_lights(jscene)

    def loss(p):
        return jnp.sum(jw.trace_radiance(jscene.with_params(p), jo, jd, bounces,
                                         uniforms=jnp.asarray(uni.numpy()), nee=True,
                                         tri_light_ids=tl, remat=False))

    ref = jax.jit(jax.grad(loss), compiler_options=FAST_COMPILE)(jscene.params())
    for accel in (None, build_shaded_accel(scene, KDTreeConfig(leaf_size=8)).to("cpu")):
        p = SceneParams(*(x.detach().clone().requires_grad_() for x in scene.params().leaves()))
        col = tw.trace_radiance(scene.with_params(p), o, d, bounces, uniforms=uni,
                                accel=accel, nee=True)
        got = dict(zip(FIELDS, torch.autograd.grad(col.sum(), p.leaves())))
        name = "brute force" if accel is None else "shaded accel"
        for f in FIELDS:
            want = np.asarray(getattr(ref, f))
            scale = float(np.abs(want).max())
            if f != "normals":                  # the scene has no smooth normals
                assert scale > 0, f
            np.testing.assert_allclose(got[f].numpy(), want, rtol=0,
                                       atol=1e-4 * max(scale, 1e-30), err_msg=f"{name}: {f}")
        # the panel's vertices (after the cube's 8) and the sphere light's
        # emission (material 3, shared with the panel) move the film
        assert float(got["vertices"][8:].abs().max()) > 0, name
        assert float(got["emission"][3].abs().max()) > 0, name


def test_nee_backward_never_walks_the_bvh_again():
    # hits and shadow rays each launch wide_shade once a bounce in the
    # forward; the backward replays the shading from the saved hit and the
    # kept occlusion and launches none
    _, scene, cam, _, _, _ = _nee_case("area")
    accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=8)).to("cpu")
    bounces = 3
    s = RenderSettings(resolution=(32, 16), samples_per_pixel=1, bounce_limit=bounces, nee=True)
    p = SceneParams(*(x.detach().clone().requires_grad_() for x in scene.params().leaves()))
    counter = _build.COUNTERS["wide_shade"]
    before = counter.plain_calls
    film = tw.render(scene.with_params(p), cam, s, prng_key(2), accel=accel, device="cpu")
    after_forward = counter.plain_calls
    assert after_forward == before + 2 * bounces
    grads = torch.autograd.grad(film.sum(), p.leaves())
    assert counter.plain_calls == after_forward
    g = dict(zip(FIELDS, grads))
    assert float(g["emission"].abs().max()) > 0 and float(g["vertices"].abs().max()) > 0
    with torch.no_grad():
        plain = tw.render(scene, cam, s, prng_key(2), accel=accel, device="cpu")
    assert torch.equal(film.detach(), plain)
