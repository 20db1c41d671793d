"""PyTorch port, the brute-force path against the numpy oracle: films of
every primitive class with explicit uniforms (twins of
``tests/test_render_oracle.py``'s non-NEE cases, at their films and
tolerances) and the oracle gradient parity (twins of ``tests/test_grad.py``'s
``TestOracleGradientParity``). Everything renders with ``accel=None``, the
brute-force triangle path, so no test here walks a BVH or needs JAX."""

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

import oracle  # noqa: E402

from atray_tpu_torch.config import RenderSettings  # noqa: E402
from atray_tpu_torch.core.camera import camera_rays, look_at_camera  # noqa: E402
from atray_tpu_torch.render import wavefront as tw  # noqa: E402
from atray_tpu_torch.render.rng import draw_bounce_uniforms, prng_key  # noqa: E402
from atray_tpu_torch.scene import build_scene, procedural  # noqa: E402
from atray_tpu_torch.scene.data import Planes, Spheres, make_materials  # noqa: E402
from atray_tpu_torch.scene.transforms import translate  # noqa: E402

MATS = make_materials([
    ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),   # sky
    ((0.0, 0.0, 0.0), (0.7, 0.7, 0.7), 0.0),      # grey diffuse
    ((0.0, 0.0, 0.0), (0.8, 0.2, 0.2), 0.7),      # red glossy
    ((4.0, 3.5, 3.0), (0.0, 0.0, 0.0), 0.0),      # warm light
    ((0.0, 0.0, 0.0), (0.95, 0.95, 0.95), 1.0),   # mirror
])


def _floor(offset, material):
    return Planes(normals=np.asarray([[0.0, 1.0, 0.0]], np.float32),
                  offsets=np.asarray([offset], np.float32),
                  material_id=np.asarray([material], np.int32))


def scene_full():
    """``tests/test_render_oracle.py``'s full scene: a glossy cube, a
    mirror and a light sphere, a floor."""
    cube = translate(procedural.cube(size=1.5, material=2), (0.0, -0.5, -4.0))
    spheres = Spheres(centers=np.asarray([[1.6, 0.2, -5.0], [-1.5, 2.0, -4.0]], np.float32),
                      radii=np.asarray([0.8, 0.6], np.float32),
                      material_id=np.asarray([4, 3], np.int32))
    return build_scene([cube], spheres=spheres, planes=_floor(-1.5, 1), materials=MATS)


def _scenes():
    return {
        "full": scene_full,
        "mesh_flat": lambda: build_scene(
            [translate(procedural.cube(size=1.5, material=1), (0.0, 0.0, -4.0))],
            materials=MATS),
        "mesh_smooth": lambda: build_scene(
            [translate(procedural.uv_sphere(rows=12, cols=12, material=2, smooth=True),
                       (0.0, 0.0, -4.0))], materials=MATS),
        "sky": lambda: build_scene([], materials=MATS),
    }


# scene -> (bounces, tolerance): the full scene's wider one is the
# reference's (a few f32 ulps grow through 3 stochastic bounces)
CASES = {"full": (3, 1e-3), "mesh_flat": (3, 2e-5), "mesh_smooth": (3, 2e-5), "sky": (2, 2e-5)}


@pytest.mark.parametrize("name", list(CASES))
def test_brute_force_film_matches_oracle(name):
    scene = _scenes()[name]()
    w, h, spp = 48, 36, 2
    bounces, tol = CASES[name]
    cam = look_at_camera((0.0, 0.5, 1.0), (0.0, 0.0, -4.0), h_fov=0.9, aspect=w / h)
    s = RenderSettings(resolution=(w, h), samples_per_pixel=spp, bounce_limit=bounces,
                       use_accel=False)
    uni = draw_bounce_uniforms(prng_key(7), bounces, spp * h * w, device="cpu")
    film = tw.render(scene, cam, s, prng_key(42), uniforms=uni, device="cpu").numpy()
    o, d = camera_rays(cam, w, h, spp, device="cpu")
    ref = oracle.render_film(scene, o.numpy(), d.numpy(), bounces, uni.numpy(), spp, h, w)
    np.testing.assert_allclose(film, ref, atol=tol)
    if name == "full":
        assert film.std() > 0.01
    if name == "sky":
        np.testing.assert_allclose(film[0, 0], [0.35, 0.45, 0.65], atol=1e-6)


def test_single_bounce_deterministic():
    # one bounce: no jitter reaches the film, so two keys agree
    cam = look_at_camera((0.0, 0.5, 1.0), (0.0, 0.0, -4.0), h_fov=0.9, aspect=4 / 3)
    s = RenderSettings(resolution=(32, 24), samples_per_pixel=1, bounce_limit=1)
    f1 = tw.render(scene_full(), cam, s, prng_key(0), device="cpu")
    f2 = tw.render(scene_full(), cam, s, prng_key(99), device="cpu")
    np.testing.assert_allclose(f1.numpy(), f2.numpy(), atol=1e-7)


def test_spp_averaging_reduces_variance():
    scene = scene_full()
    cam = look_at_camera((0.0, 0.5, 1.0), (0.0, 0.0, -4.0), h_fov=0.9, aspect=1.0)

    def spread(spp):
        s = RenderSettings(resolution=(24, 24), samples_per_pixel=spp, bounce_limit=4)
        films = [tw.render(scene, cam, s, prng_key(k), device="cpu").numpy() for k in range(4)]
        return np.var(np.stack(films), axis=0).mean()

    assert spread(32) < spread(2)


# -- oracle gradient parity (tests/test_grad.py, TestOracleGradientParity) --

GRAD_MATS = make_materials([
    ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),
    ((0.1, 0.05, 0.0), (0.7, 0.5, 0.3), 0.2),
    ((0.0, 0.0, 0.0), (0.5, 0.6, 0.7), 0.0),
])


def _grad_setup(w=8, h=8, bounces=3):
    body = translate(procedural.uv_sphere(rows=10, cols=10, material=1), (0, 0, -4))
    scene = build_scene([body], planes=_floor(-1.5, 2), materials=GRAD_MATS)
    cam = look_at_camera((0, 0.3, 0.5), (0, 0, -4), h_fov=0.8, aspect=w / h)
    orig, dirn = camera_rays(cam, w, h, 1, device="cpu")
    uni = draw_bounce_uniforms(prng_key(7), bounces, orig.shape[0], device="cpu")
    return scene, orig, dirn, uni, bounces


def _with(scene, field, value):
    """The host scene with one parameter leaf replaced by a numpy array."""
    p = scene.params()
    return scene.with_params(dataclasses.replace(p, **{field: np.asarray(value, np.float32)}))


@pytest.mark.parametrize("field", ["albedo", "vertices", "normals"])
def test_fd_matches_numpy_oracle_fd(field):
    # the port and the oracle agree on the film's sensitivity: a central
    # difference of both with the same eps and uniforms, to 1e-4 per pixel
    scene, orig, dirn, uni, bounces = _grad_setup()

    def port(sc):
        return tw.trace_radiance(sc.to("cpu"), orig, dirn, bounces, uniforms=uni).numpy()

    def orc(sc):
        return oracle.trace(orig.numpy(), dirn.numpy(), oracle.scene_to_numpy(sc), bounces,
                            uni.numpy())

    x = np.asarray(getattr(scene.params(), field), np.float64)
    if field == "albedo":
        probes, eps = [(1, 0)], 1e-2
    else:
        # the coordinates the film depends on most (largest analytic gradient)
        p = scene.to("cpu").params()
        p = dataclasses.replace(p, **{field: getattr(p, field).clone().requires_grad_()})
        loss = tw.trace_radiance(scene.to("cpu").with_params(p), orig, dirn, bounces,
                                 uniforms=uni).sum()
        (g,) = torch.autograd.grad(loss, [getattr(p, field)])
        top = np.argsort(np.abs(g.numpy()).sum(axis=1))[-3:]
        probes, eps = [(int(top[0]), 0), (int(top[1]), 1), (int(top[2]), 2)], 2e-3
    peak = 0.0
    for idx in probes:
        xp, xm = x.copy(), x.copy()
        xp[idx] += eps
        xm[idx] -= eps
        fd_port = (port(_with(scene, field, xp)).astype(np.float64)
                   - port(_with(scene, field, xm))) / (2 * eps)
        fd_orc = (orc(_with(scene, field, xp)).astype(np.float64)
                  - orc(_with(scene, field, xm))) / (2 * eps)
        np.testing.assert_allclose(fd_port, fd_orc, atol=1e-4)
        peak = max(peak, float(np.abs(fd_port).max()))
    assert peak > 1e-3
    if field == "albedo":
        # autograd against the oracle's central difference, to FD accuracy
        p = scene.to("cpu").params()
        p = dataclasses.replace(p, albedo=p.albedo.clone().requires_grad_())
        loss = tw.trace_radiance(scene.to("cpu").with_params(p), orig, dirn, bounces,
                                 uniforms=uni).sum()
        (g,) = torch.autograd.grad(loss, [p.albedo])
        for idx in [(1, 0), (1, 2), (2, 1)]:
            e = 2e-2
            ap, am = x.copy(), x.copy()
            ap[idx] += e
            am[idx] -= e
            fd = (float(orc(_with(scene, field, ap)).sum())
                  - float(orc(_with(scene, field, am)).sum())) / (2 * e)
            np.testing.assert_allclose(float(g[idx]), fd, atol=1e-2, rtol=1e-2)
