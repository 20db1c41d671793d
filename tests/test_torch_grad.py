"""PyTorch port, the render gradient: grads against ``jax.grad`` of the JAX
fused render (Pallas kernel in interpret mode), packed against unpacked
within the port, finite differences, the no-second-walk rule, the film
clamp's tie rule, and the entry points' device rule."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from atray_tpu.accel.shaded import build_shaded_accel as jax_build_shaded_accel  # noqa: E402
from atray_tpu.config import KDTreeConfig as JaxKDTreeConfig  # noqa: E402
from atray_tpu.config import RenderSettings as JaxRenderSettings  # noqa: E402
from atray_tpu.core.camera import look_at_camera as jax_look_at_camera  # noqa: E402
from atray_tpu.render import wavefront as jw  # noqa: E402
from test_torch_render import _accel_fields, _mixed_scene, _pack_scene, _tree  # noqa: E402

from atray_tpu_torch.accel.shaded import build_shaded_accel, refit_shaded  # noqa: E402
from atray_tpu_torch.accel.wide import make_accel, refit_wide  # noqa: E402
from atray_tpu_torch.config import KDTreeConfig, RenderSettings  # noqa: E402
from atray_tpu_torch.core.camera import camera_rays, look_at_camera  # noqa: E402
from atray_tpu_torch.dist.train import make_loss_and_grad  # noqa: E402
from atray_tpu_torch.interop import scene_from_numpy, shaded_accel_from_numpy  # noqa: E402
from atray_tpu_torch.kernels import _build  # noqa: E402
from atray_tpu_torch.render import wavefront as tw  # noqa: E402
from atray_tpu_torch.render.rng import prng_key  # noqa: E402
from atray_tpu_torch.scene import build_scene, procedural  # noqa: E402
from atray_tpu_torch.scene.data import Planes, SceneParams, TriMesh, make_materials  # noqa: E402
from atray_tpu_torch.scene.transforms import translate  # noqa: E402

FIELDS = ("vertices", "normals", "emission", "albedo", "scatter")


def _leaves(scene):
    """The scene's params as fresh leaf tensors that require grad."""
    return SceneParams(*(x.detach().clone().requires_grad_() for x in scene.params().leaves()))


def _render_grads(scene, accel, cam, settings, key):
    p = _leaves(scene)
    film = tw.render(scene.with_params(p), cam, settings, key, accel=accel, device="cpu")
    return dict(zip(FIELDS, torch.autograd.grad(film.sum(), p.leaves())))


def test_render_grads_match_jax_fused_render():
    # the port (sort + lane pack on, so the backward runs lane_scatter)
    # against jax.grad of the JAX fused render (unsorted: the same film,
    # and the interpret-mode kernel costs a third as much); 12x12 x 2 spp
    # x 3 bounces, a smaller film than the forward test's because the JAX
    # side's cost is the interpret-mode walk, not the ray count
    scene = _mixed_scene()
    ja = jax_build_shaded_accel(scene, JaxKDTreeConfig(leaf_size=8))
    jcam = jax_look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.0)
    js = JaxRenderSettings(resolution=(12, 12), samples_per_pixel=2, bounce_limit=3,
                           sort_bounces=False)
    ref = jax.grad(lambda p: jnp.sum(jw.render(scene.with_params(p), jcam, js,
                                               jax.random.PRNGKey(5), accel=ja)))(scene.params())
    port = scene_from_numpy(_tree(scene)).to("cpu")
    accel = shaded_accel_from_numpy(_accel_fields(ja)).to("cpu")
    cam = look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.0)
    got = _render_grads(port, accel, cam, RenderSettings(resolution=(12, 12),
                                                         samples_per_pixel=2, bounce_limit=3),
                        prng_key(5))
    for f in FIELDS:
        want = np.asarray(getattr(ref, f))
        scale = float(np.abs(want).max())
        assert scale > 0, f
        np.testing.assert_allclose(got[f].numpy(), want, rtol=0, atol=1e-4 * scale, err_msg=f)


def test_lane_packed_grads_match_unpacked():
    # the twin of the reference's test: gradients flow through the pack
    # (lane_take_p, whose backward is lane_scatter) unchanged
    scene = scene_from_numpy(_tree(_pack_scene())).to("cpu")
    accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=8)).to("cpu")
    cam = look_at_camera((0, 0.6, 0.7), (0, 0, -4), h_fov=0.9, aspect=2.0)

    def grads(pack):
        s = RenderSettings(resolution=(128, 64), samples_per_pixel=1, bounce_limit=4,
                           sort_bounces=True, lane_pack=pack)
        return _render_grads(scene, accel, cam, s, prng_key(1))

    before = _build.COUNTERS["lane_scatter"].plain_calls
    g1 = grads(True)
    assert _build.COUNTERS["lane_scatter"].plain_calls == before + 2   # state + restore
    g2 = grads(False)
    for f in FIELDS:
        np.testing.assert_allclose(g1[f].numpy(), g2[f].numpy(), atol=1e-5, rtol=1e-4,
                                   err_msg=f)
    assert float(g1["albedo"].abs().max()) > 1e-4


MATS = make_materials([
    ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),
    ((0.1, 0.05, 0.0), (0.7, 0.5, 0.3), 0.2),
    ((0.0, 0.0, 0.0), (0.5, 0.6, 0.7), 0.0),
])


def _fd(f, x, eps):
    """Central finite difference of scalar f at every element of x."""
    x = np.asarray(x, np.float64)
    g = np.zeros_like(x)
    for idx in np.ndindex(x.shape):
        xp = x.copy()
        xp[idx] += eps
        xm = x.copy()
        xm[idx] -= eps
        g[idx] = (f(xp) - f(xm)) / (2 * eps)
    return g


def _weighted_loss(scene, accel, orig, dirn, bounces, refit=None):
    """The reference's FD loss: sum(color * cos(arange)) over traced rays,
    with the accel refitted to the live vertices when ``refit`` is given."""
    def loss(p):
        sc = scene.with_params(p)
        acc = accel if refit is None else refit(accel, sc)
        color = tw.trace_radiance(sc, orig, dirn, bounces, prng_key(7), accel=acc)
        w = torch.cos(torch.arange(color.numel(), dtype=torch.float32).reshape(color.shape))
        return torch.sum(color * w)
    return loss


def test_albedo_grad_matches_fd():
    body = translate(procedural.uv_sphere(rows=10, cols=10, material=1), (0, 0, -4))
    planes = Planes(normals=np.asarray([[0.0, 1.0, 0.0]], np.float32),
                    offsets=np.asarray([-1.5], np.float32), material_id=np.asarray([2], np.int32))
    scene = build_scene([body], planes=planes, materials=MATS).to("cpu")
    accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=8)).to("cpu")
    cam = look_at_camera((0, 0.3, 0.5), (0, 0, -4), h_fov=0.8, aspect=1.0)
    orig, dirn = camera_rays(cam, 12, 12, 1, device="cpu")
    loss = _weighted_loss(scene, accel, orig, dirn, 3)
    p0 = _leaves(scene)
    (g,) = torch.autograd.grad(loss(p0), [p0.albedo])

    def f_alb(alb):
        p = dataclasses.replace(p0, albedo=torch.tensor(alb, dtype=torch.float32))
        with torch.no_grad():
            return float(loss(p))

    fd = _fd(f_alb, p0.albedo.detach().numpy(), 2e-3)
    np.testing.assert_allclose(g.numpy(), fd, atol=3e-2, rtol=5e-2)
    assert np.abs(fd).max() > 1e-2


@pytest.mark.parametrize("kind", ["shaded", "wide"])
def test_vertex_grad_matches_fd_single_triangle(kind):
    # one big triangle in front of the camera: every hit is interior, so no
    # FD step flips visibility; the accel is refitted to the moved vertices
    # at every evaluation, as the trainer does
    tri = TriMesh(
        vertices=np.float32([[-2.0, -2.0, -3.0], [2.0, -2.0, -3.0], [0.0, 2.0, -3.0]]),
        faces=np.int32([[0, 1, 2]]), normals=np.float32([[0.0, 0.0, 1.0]]),
        face_normal_idx=np.int32([[-1, -1, -1]]), tex_coords=np.float32([[0.0, 0.0]]),
        face_tex_idx=np.int32([[-1, -1, -1]]), material_id=np.int32([1]))
    scene = build_scene([tri], materials=MATS).to("cpu")
    if kind == "shaded":
        accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=4)).to("cpu")
        refit = refit_shaded
    else:
        accel = make_accel(scene.mesh.vertices, scene.mesh.faces, KDTreeConfig(leaf_size=8))
        accel = accel.to("cpu")

        def refit(acc, sc):
            return refit_wide(acc, sc.mesh.vertices, sc.mesh.faces)
    cam = look_at_camera((0, 0, 1), (0, 0, -3), h_fov=0.3, aspect=1.0)
    orig, dirn = camera_rays(cam, 8, 8, 1, device="cpu")
    loss = _weighted_loss(scene, accel, orig, dirn, 2, refit)
    p0 = _leaves(scene)
    (g,) = torch.autograd.grad(loss(p0), [p0.vertices])

    def f_v(v):
        p = dataclasses.replace(p0, vertices=torch.tensor(v, dtype=torch.float32))
        with torch.no_grad():
            return float(loss(p))

    fd = _fd(f_v, p0.vertices.detach().numpy(), 1e-3)
    np.testing.assert_allclose(g.numpy(), fd, atol=5e-2, rtol=5e-2)
    assert np.abs(fd).max() > 1e-3


@pytest.mark.parametrize("kind", ["shaded", "wide"])
def test_backward_never_walks_the_bvh_again(kind):
    # the hit call sits outside the checkpointed shading: after backward,
    # the walk's call count equals the forward's
    scene = scene_from_numpy(_tree(_pack_scene())).to("cpu")
    if kind == "shaded":
        accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=8)).to("cpu")
        counter = _build.COUNTERS["wide_shade"]
    else:
        accel = make_accel(scene.mesh.vertices, scene.mesh.faces,
                           KDTreeConfig(leaf_size=8)).to("cpu")
        counter = _build.COUNTERS["wide_exact"]
    cam = look_at_camera((0, 0.6, 0.7), (0, 0, -4), h_fov=0.9, aspect=2.0)
    p = _leaves(scene)
    before = counter.plain_calls
    film = tw.render(scene.with_params(p), cam,
                     RenderSettings(resolution=(32, 16), samples_per_pixel=1, bounce_limit=3),
                     prng_key(2), accel=accel, device="cpu")
    after_forward = counter.plain_calls
    assert after_forward == before + 3
    grads = torch.autograd.grad(film.sum(), p.leaves())
    assert counter.plain_calls == after_forward
    assert float(grads[0].abs().max()) > 0 and float(grads[3].abs().max()) > 0


def test_film_clamp_splits_the_gradient_at_exact_bounds():
    x = np.float32([0.0, 0.5, 1.0, -0.25, 1.5])
    want = np.asarray(jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0)))(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_()
    (got,) = torch.autograd.grad(tw.clip01(t).sum(), t)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), [0.5, 1.0, 0.5, 0.0, 0.0])


def test_entry_points_need_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("this box has a CUDA device: device=None means it")
    scene = build_scene([procedural.cube()])
    accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=8))
    cam = look_at_camera((0, 0, 3), (0, 0, 0), h_fov=0.5, aspect=1.0)
    s = RenderSettings(resolution=(8, 8), samples_per_pixel=1, bounce_limit=1)
    for call in (lambda: tw.render(scene, cam, s, prng_key(0), accel=accel),
                 lambda: camera_rays(cam, 8, 8, 1),
                 lambda: make_loss_and_grad(scene, 1, accel=accel),
                 lambda: scene.to(),
                 lambda: accel.to()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    film = tw.render(scene, cam, s, prng_key(0), accel=accel, device="cpu")
    assert film.device == torch.device("cpu") and film.shape == (8, 8, 3)
