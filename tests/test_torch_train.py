"""PyTorch port, the one-device trainer (``dist/train.py``): three steps
against JAX ``make_train_step`` with optax Adam from the same start
weights, Adam state carried over from optax, the train-state checkpoint,
and kill-and-resume bit-exactness within the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

torch.set_num_threads(2)

from atray_tpu.core.camera import camera_rays as jax_camera_rays  # noqa: E402
from atray_tpu.core.camera import look_at_camera as jax_look_at_camera  # noqa: E402
from atray_tpu.dist.train import make_train_step as jax_make_train_step  # noqa: E402
from atray_tpu.render.wavefront import trace_radiance as jax_trace_radiance  # noqa: E402
from atray_tpu.scene import build_scene as jax_build_scene  # noqa: E402
from atray_tpu.scene import procedural as jax_procedural  # noqa: E402
from atray_tpu.scene.data import SceneParams as JaxSceneParams  # noqa: E402
from atray_tpu.scene.data import make_materials as jax_make_materials  # noqa: E402
from atray_tpu.scene.transforms import translate as jax_translate  # noqa: E402
from test_torch_render import _tree  # noqa: E402

from atray_tpu_torch.accel.shaded import build_shaded_accel  # noqa: E402
from atray_tpu_torch.accel.wide import make_accel  # noqa: E402
from atray_tpu_torch.config import KDTreeConfig  # noqa: E402
from atray_tpu_torch.core.camera import camera_rays, look_at_camera  # noqa: E402
from atray_tpu_torch.dist.train import (  # noqa: E402
    load_train_state,
    make_loss_and_grad,
    make_train_step,
    run_training,
    save_train_state,
)
from atray_tpu_torch.interop import (  # noqa: E402
    adam_state_from_optax,
    params_from_numpy,
    scene_from_numpy,
)
from atray_tpu_torch.render.rng import fold_in, prng_key  # noqa: E402
from atray_tpu_torch.render.wavefront import trace_radiance  # noqa: E402
from atray_tpu_torch.scene import build_scene, procedural  # noqa: E402
from atray_tpu_torch.scene.data import make_materials  # noqa: E402
from atray_tpu_torch.scene.transforms import translate  # noqa: E402

FIELDS = ("vertices", "normals", "emission", "albedo", "scatter")
LR = {"albedo": 3e-2, "vertices": 5e-4}


def _np(tree):
    return {f: np.array(getattr(tree, f)) for f in FIELDS}


@pytest.fixture(scope="module")
def jax_run():
    """The reference's problem: 2 orbit views x 16x16, 2 bounces,
    uv_sphere(10, 10), albedo and vertices corrupted, Adam on albedo and
    vertices, the rest frozen with set_to_zero; 3 steps of the JAX trainer
    on one CPU device, brute-force hits."""
    mats = jax_make_materials([((0.35, 0.45, 0.65), (0, 0, 0), 0.0),
                               ((0, 0, 0), (0.8, 0.45, 0.25), 0.2)])
    scene = jax_build_scene([jax_translate(jax_procedural.uv_sphere(10, 10, material=1),
                                           (0, 0, -4))], materials=mats)
    origs, dirns = [], []
    for v in range(2):
        ang = 2 * np.pi * v / 2
        cam = jax_look_at_camera((2.5 * np.sin(ang), 0.8, -4 + 2.5 * np.cos(ang)), (0, 0, -4),
                                 h_fov=0.8, aspect=1.0)
        o, d = jax_camera_rays(cam, 16, 16, spp=1)
        origs.append(np.asarray(o))
        dirns.append(np.asarray(d))
    orig, dirn = np.concatenate(origs), np.concatenate(dirns)
    target = np.array(jax_trace_radiance(scene, jnp.asarray(orig), jnp.asarray(dirn), 2,
                                         key=jax.random.PRNGKey(0)))
    true = scene.params()
    noise = np.random.default_rng(3).normal(0, 0.004, np.shape(true.vertices))
    p0 = dataclasses.replace(true, albedo=true.albedo * 0.4 + 0.2,
                             vertices=true.vertices + noise.astype(np.float32))
    labels = JaxSceneParams(vertices="geo", normals="frozen", emission="frozen",
                            albedo="mat", scatter="frozen")
    opt = optax.multi_transform({"mat": optax.adam(LR["albedo"]), "geo": optax.adam(LR["vertices"]),
                                 "frozen": optax.set_to_zero()}, labels)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]), ("rays",))
    step = jax.jit(jax_make_train_step(scene, 2, opt, mesh, accel=None))
    p, s = jax.tree_util.tree_map(jnp.asarray, p0), opt.init(p0)
    history = []
    for i in range(3):
        p, s, loss = step(p, s, jnp.asarray(orig), jnp.asarray(dirn), jnp.asarray(target),
                          jax.random.fold_in(jax.random.PRNGKey(0), i))
        history.append((_np(p), s, float(loss)))
    return dict(scene=scene, orig=orig, dirn=dirn, target=target, p0=_np(p0), history=history)


def _port(jr):
    scene = scene_from_numpy(_tree(jr["scene"]))
    accel = make_accel(scene.mesh.vertices, scene.mesh.faces, KDTreeConfig(leaf_size=8))
    return scene, accel, [torch.from_numpy(jr[k]) for k in ("orig", "dirn", "target")]


def _params(fields):
    p = params_from_numpy(fields, device="cpu")
    p.albedo.requires_grad_()
    p.vertices.requires_grad_()
    return p


def _adam(p):
    return torch.optim.Adam([{"params": [p.albedo], "lr": LR["albedo"]},
                             {"params": [p.vertices], "lr": LR["vertices"]}])


def _assert_params_close(p, want):
    # both packages take the same hits (the port's BVH walk vs the
    # reference's brute force) except where a grazing hit is decided by
    # one ulp, which forks a path; on this problem none does, so the
    # parameters agree to float32 round-off
    for f in FIELDS:
        np.testing.assert_allclose(getattr(p, f).detach().numpy(), want[f], atol=1e-4,
                                   rtol=1e-4, err_msg=f)


def test_three_steps_match_jax_trainer(jax_run):
    scene, accel, (orig, dirn, target) = _port(jax_run)
    p = _params(jax_run["p0"])
    opt = _adam(p)
    step = make_train_step(scene, 2, opt, accel=accel, refit=True, device="cpu")
    for i, (want, _, want_loss) in enumerate(jax_run["history"]):
        loss = float(step(p, orig, dirn, target, fold_in(prng_key(0), i)))
        np.testing.assert_allclose(loss, want_loss, rtol=1e-4, atol=1e-7)
        _assert_params_close(p, want)
    # frozen leaves stay as they started
    for f in ("normals", "emission", "scatter"):
        np.testing.assert_array_equal(getattr(p, f).numpy(), jax_run["p0"][f])


def test_resume_from_optax_state(jax_run):
    # step 1's params and optax Adam moments carried into the port, then
    # the port's steps 2 and 3 follow the reference's
    scene, accel, (orig, dirn, target) = _port(jax_run)
    p1, s1, _ = jax_run["history"][0]
    p = _params(p1)
    opt = _adam(p)
    mat, geo = (s1.inner_states[lbl].inner_state[0] for lbl in ("mat", "geo"))
    assert int(mat.count) == int(geo.count) == 1
    adam_state_from_optax(
        opt, p, mat.count,
        {"albedo": np.array(mat.mu.albedo), "vertices": np.array(geo.mu.vertices)},
        {"albedo": np.array(mat.nu.albedo), "vertices": np.array(geo.nu.vertices)})
    step = make_train_step(scene, 2, opt, accel=accel, refit=True, device="cpu")
    for i in (1, 2):
        want, _, want_loss = jax_run["history"][i]
        loss = float(step(p, orig, dirn, target, fold_in(prng_key(0), i)))
        np.testing.assert_allclose(loss, want_loss, rtol=1e-4, atol=1e-7)
        _assert_params_close(p, want)


def _small_problem():
    mats = make_materials([((0.3, 0.4, 0.6), (0.0, 0.0, 0.0), 0.0),
                           ((0.0, 0.0, 0.0), (0.8, 0.45, 0.25), 0.2)])
    scene = build_scene([translate(procedural.uv_sphere(rows=6, cols=6, material=1),
                                   (0, 0, -4))], materials=mats)
    cam = look_at_camera((0, 0.3, 0.5), (0, 0, -4), h_fov=0.9, aspect=1.0)
    orig, dirn = camera_rays(cam, 8, 8, 1, device="cpu")
    return scene, orig, dirn, torch.zeros_like(orig)


def _fresh(scene):
    p = scene.to("cpu").params()
    p = dataclasses.replace(p, albedo=p.albedo.clone().requires_grad_(),
                            vertices=p.vertices.clone().requires_grad_())
    return p, _adam(p)


def test_save_load_roundtrip(tmp_path):
    scene, orig, dirn, target = _small_problem()
    accel = make_accel(scene.mesh.vertices, scene.mesh.faces)
    p, opt = _fresh(scene)
    step = make_train_step(scene, 2, opt, accel=accel, device="cpu")
    step(p, orig, dirn, target, prng_key(1))
    path = str(tmp_path / "train.npz")
    save_train_state(path, p, opt, step=7, seed=42)
    q, opt2 = _fresh(scene)
    assert load_train_state(path, q, opt2) == (7, 42)
    for a, b in zip(p.leaves(), q.leaves()):
        assert torch.equal(a, b)
    for a, b in zip(opt.state.values(), opt2.state.values()):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[k], b[k])
    assert load_train_state(str(tmp_path / "none.npz"), q, opt2) is None
    wrong = dataclasses.replace(q, albedo=torch.zeros(5, 3))
    with pytest.raises(ValueError, match="shape"):
        load_train_state(path, wrong, opt2)


def test_kill_resume_reproduces_uninterrupted_run(tmp_path):
    # 6 steps straight through vs 3 steps, "kill", and a resume from the
    # checkpoint for the rest: bit-exact within the port
    scene, orig, dirn, target = _small_problem()
    accel = make_accel(scene.mesh.vertices, scene.mesh.faces)

    def run(num_steps, path=None):
        p, opt = _fresh(scene)
        step = make_train_step(scene, 2, opt, accel=accel, refit=True, device="cpu")
        _, losses = run_training(step, opt, p, orig, dirn, target, num_steps=num_steps, seed=9,
                                 checkpoint_path=path, checkpoint_every=3)
        return p, opt, losses

    p_full, opt_full, losses_full = run(6)
    path = str(tmp_path / "ckpt.npz")
    run(3, path)
    p_res, opt_res, losses_res = run(6, path)
    assert len(losses_res) == 3
    assert losses_res == losses_full[3:]
    for a, b in zip(p_full.leaves(), p_res.leaves()):
        assert torch.equal(a, b)
    for a, b in zip(opt_full.state.values(), opt_res.state.values()):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a[k], b[k])
    assert losses_full[-1] < losses_full[0]


def test_shaded_accel_refit_gives_the_wide_accel_gradient():
    # the trainer on the production accel (refit_shaded, fused hit with the
    # replay backward) and on make_accel (refit_wide, gather path) compute
    # the same loss and gradients
    scene, orig, dirn, _ = _small_problem()
    target = torch.full_like(orig, 0.2)
    p, _ = _fresh(scene)
    with torch.no_grad():
        p.vertices.add_(torch.from_numpy(np.random.default_rng(5).normal(
            0, 0.01, tuple(p.vertices.shape)).astype(np.float32)))
    out = []
    for accel in (make_accel(scene.mesh.vertices, scene.mesh.faces),
                  build_shaded_accel(scene, KDTreeConfig(leaf_size=8))):
        f = make_loss_and_grad(scene, 2, accel=accel, refit=True, device="cpu")
        out.append(f(p, orig, dirn, target, prng_key(3)))
    (l1, g1), (l2, g2) = out
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    for a, b in ((g1.albedo, g2.albedo), (g1.vertices, g2.vertices)):
        scale = float(a.abs().max())
        assert scale > 0
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-5 * scale)
    assert g1.normals is None and g2.scatter is None
    with torch.no_grad():
        colour = trace_radiance(scene.to("cpu"), orig, dirn, 2, prng_key(3),
                                accel=make_accel(scene.mesh.vertices, scene.mesh.faces))
    assert colour.shape == orig.shape and torch.isfinite(colour).all()
