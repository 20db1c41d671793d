"""PyTorch port: the sharded trainer (``dist/train.py`` with ``mesh=``,
``reduce_grads``, the rank-0 checkpoint, ``dist/mesh.py::gather_rows_grad``
and ``atray_tpu_torch/examples/inverse_render.py`` under ranks): twins of
``tests/test_sharding.py``'s psum'd gradient, train step and example tests.

As in ``tests/test_torch_dist.py`` (whose ``spawn_ranks`` it uses), one
spawn of 3 gloo ranks runs every case's rank side and the cases assert in
the parent. The ranks import this file, so it imports nothing of JAX at
module level; the JAX reference (``make_loss_and_grad`` on a mesh of 3 of
the conftest's 8 virtual CPU devices, ``build_bvh``, no Pallas kernel) is
jitted in the case that needs it."""

import contextlib
import dataclasses
import io
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

torch.set_num_threads(2)

from test_torch_dist import spawn_ranks  # noqa: E402

from atray_tpu_torch.accel.bvh import build_bvh  # noqa: E402
from atray_tpu_torch.accel.shaded import build_shaded_accel  # noqa: E402
from atray_tpu_torch.config import KDTreeConfig  # noqa: E402
from atray_tpu_torch.core.camera import camera_rays, look_at_camera  # noqa: E402
from atray_tpu_torch.dist.mesh import gather_rows_grad, make_device_mesh, trace_sharded  # noqa: E402
from atray_tpu_torch.dist.train import (  # noqa: E402
    make_loss_and_grad,
    make_train_step,
    reduce_grads,
    run_training,
)
from atray_tpu_torch.examples import inverse_render  # noqa: E402
from atray_tpu_torch.interop import scene_from_numpy  # noqa: E402
from atray_tpu_torch.render.rng import prng_key  # noqa: E402

WORLD = 3
EYE, TARGET = (0.0, 0.4, 0.6), (0.0, 0.0, -4.0)
GRAD_RES, TRAIN_RES = 12, 9          # 144 and 81 rays: 48 and 27 a rank
TRAIN_STEPS = 60
RESUME = (6, 3, 2)                   # steps, the kill after step 3, a checkpoint every 2
EXAMPLE = ["--views", "2", "--res", "12", "--tris", "500", "--steps", "30"]


class _Killed(Exception):
    pass


def _all_params(scene):
    return type(scene.params())(*(x.clone().requires_grad_() for x in scene.params().leaves()))


def _albedo_run(scene, mesh, extra_vertices=False):
    """(params, optimizer, step) of the albedo recovery: albedo x 0.3 +
    0.1, Adam 5e-2 (``tests/test_sharding.py``'s); with ``extra_vertices``
    the vertices train too (Adam 1e-3)."""
    p0 = scene.params()
    p = dataclasses.replace(p0, albedo=(p0.albedo * 0.3 + 0.1).requires_grad_())
    groups = [{"params": [p.albedo], "lr": 5e-2}]
    if extra_vertices:
        p = dataclasses.replace(p, vertices=p0.vertices.clone().requires_grad_())
        groups.append({"params": [p.vertices], "lr": 1e-3})
    opt = torch.optim.Adam(groups)
    return p, opt, make_train_step(scene, 2, opt, device="cpu", mesh=mesh)


def _train_rank(rank, job, out):
    """The rank side of every case."""
    mesh = make_device_mesh(WORLD, device="cpu")
    scene = scene_from_numpy(job["scene"]).to("cpu")
    res = {}
    # the psum'd gradient: build_bvh, zero target, all five leaves
    o, d = (torch.from_numpy(x) for x in job["grad_rays"])
    zeros = torch.zeros_like(o)
    bvh = build_bvh(job["scene"]["mesh"]["vertices"], job["scene"]["mesh"]["faces"],
                    KDTreeConfig(), backend=job["builder"])
    loss, g = make_loss_and_grad(scene, 2, accel=bvh, device="cpu", mesh=mesh)(
        _all_params(scene), o, d, zeros, prng_key(0))
    res["bvh_loss"] = loss.numpy()
    res.update({f"bvh_g{i}": x.numpy() for i, x in enumerate(g.leaves())})
    # the shaded accel refit from the live vertices
    shaded = build_shaded_accel(scene, KDTreeConfig(leaf_size=8))
    loss, g = make_loss_and_grad(scene, 2, accel=shaded, refit=True, device="cpu", mesh=mesh)(
        _all_params(scene), o, d, zeros, prng_key(2))
    res["shaded_loss"] = loss.numpy()
    res.update({f"shaded_g{i}": x.numpy() for i, x in enumerate(g.leaves())})
    # 60 albedo steps on a target from the same sharded trace
    o9, d9 = (torch.from_numpy(x) for x in job["train_rays"])
    target = trace_sharded(scene, o9, d9, 2, prng_key(0), mesh)
    p, _, step = _albedo_run(scene, mesh)
    losses, albedo = [], []
    for _ in range(TRAIN_STEPS):
        losses.append(float(step(p, o9, d9, target, prng_key(0))))
        albedo.append(p.albedo.detach().numpy().copy())
    res["train_losses"], res["train_albedo"] = np.asarray(losses), np.stack(albedo)
    # a run killed after step 3 and resumed from rank 0's checkpoint
    steps, kill, every = RESUME
    p, opt, step = _albedo_run(scene, mesh, extra_vertices=True)
    _, res["full_losses"] = run_training(step, opt, p, o9, d9, target, steps)
    res["full_params"] = np.concatenate([x.detach().numpy().ravel() for x in p.leaves()])
    ck = os.path.join(out, "train.npz")

    def kill_after(s, _loss):
        if s == kill - 1:
            raise _Killed

    p, opt, step = _albedo_run(scene, mesh, extra_vertices=True)
    with contextlib.suppress(_Killed):
        run_training(step, opt, p, o9, d9, target, steps, checkpoint_path=ck,
                     checkpoint_every=every, on_step=kill_after)
    res["ck_step"] = int(np.load(ck)["step"])
    p, opt, step = _albedo_run(scene, mesh, extra_vertices=True)
    _, res["resumed_losses"] = run_training(step, opt, p, o9, d9, target, steps,
                                            checkpoint_path=ck, checkpoint_every=every)
    res["resumed_params"] = np.concatenate([x.detach().numpy().ravel() for x in p.leaves()])
    # reduce_grads and the gather's backward
    x = torch.full((4,), float(rank + 1), requires_grad=True)
    (gx,) = torch.autograd.grad((gather_rows_grad(x, mesh) * torch.arange(12.0)).sum(), x)
    res["gather_grad"] = gx.numpy()
    red = reduce_grads([torch.tensor([rank + 1.0]), None, torch.full((2, 2), 1.0 * rank)], mesh)
    res["reduced"] = np.concatenate([red[0].numpy(), red[2].numpy().ravel()])
    res["reduced_none"] = red[1] is None
    # the example, as its command line runs it
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert inverse_render.main(EXAMPLE + ["--device", "cpu", "--dist-backend", "gloo"]) == 0
    with open(os.path.join(out, f"example_rank{rank}.txt"), "w") as fh:
        fh.write(buf.getvalue())
    assert dist.is_initialized()          # the example leaves the caller's group
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)


def _jax_scene():
    """``tests/test_sharding.py``'s scene: a 10x10 uv sphere at (0, 0, -4)."""
    from atray_tpu.scene import build_scene, procedural
    from atray_tpu.scene.data import make_materials
    from atray_tpu.scene.transforms import translate

    mats = make_materials([((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),
                           ((0.0, 0.0, 0.0), (0.8, 0.5, 0.3), 0.2)])
    mesh = translate(procedural.uv_sphere(rows=10, cols=10, material=1), (0, 0, -4))
    return build_scene([mesh], materials=mats)


def _rays(res):
    cam = look_at_camera(EYE, TARGET, h_fov=0.9, aspect=1.0)
    o, d = camera_rays(cam, res, res, 1, device="cpu")
    return o.numpy(), d.numpy()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(job, {rank: results}, out dir) of the one spawn of 3 ranks."""
    from test_torch_render import _tree, jax_builder

    out = str(tmp_path_factory.mktemp("train_ranks"))
    job = {"scene": _tree(_jax_scene()), "builder": jax_builder(),
           "grad_rays": _rays(GRAD_RES), "train_rays": _rays(TRAIN_RES)}
    spawn_ranks(_train_rank, job, out)
    res = {r: dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(WORLD)}
    return job, res, out


def _one_rank(job, accel, key, refit=False):
    scene = scene_from_numpy(job["scene"]).to("cpu")
    o, d = (torch.from_numpy(x) for x in job["grad_rays"])
    loss, g = make_loss_and_grad(scene, 2, accel=accel, refit=refit, device="cpu")(
        _all_params(scene), o, d, torch.zeros_like(o), prng_key(key))
    return float(loss), [x.numpy() for x in g.leaves()]


def test_sharded_loss_and_grad_match_one_rank_and_jax(ranks, devices):
    # the loss and the five gradients summed over 3 ranks equal one rank's
    # and the reference's make_loss_and_grad on a mesh of 3 devices (its
    # psum), at test_psum_grads_match_local_grads' tolerance; every rank
    # holds the same sums
    import jax
    import jax.numpy as jnp

    from atray_tpu.accel.bvh import build_bvh as jax_build_bvh
    from atray_tpu.config import KDTreeConfig as JaxKDTreeConfig
    from atray_tpu.dist.mesh import make_device_mesh as jax_make_device_mesh
    from atray_tpu.dist.train import make_loss_and_grad as jax_make_loss_and_grad

    job, res, _ = ranks
    scene = scene_from_numpy(job["scene"]).to("cpu")
    bvh = build_bvh(job["scene"]["mesh"]["vertices"], job["scene"]["mesh"]["faces"],
                    KDTreeConfig(), backend=job["builder"])
    loss1, g1 = _one_rank(job, bvh, 0)
    jscene = _jax_scene()
    jbvh = jax_build_bvh(jscene.mesh.vertices, jscene.mesh.faces, JaxKDTreeConfig())
    lg = jax_make_loss_and_grad(jscene, bounce_limit=2, mesh=jax_make_device_mesh(WORLD),
                                accel=jbvh)
    o, d = (jnp.asarray(x) for x in job["grad_rays"])
    jloss, jg = jax.jit(lg, compiler_options={"xla_backend_optimization_level": 0})(
        jscene.params(), o, d, jnp.zeros_like(o), jax.random.PRNGKey(0))
    jg = jax.tree_util.tree_leaves(jg)
    assert scene.mesh.num_faces > 100 and len(jg) == 5
    for r in range(WORLD):
        np.testing.assert_allclose(float(res[r]["bvh_loss"]), loss1, rtol=1e-5)
        np.testing.assert_allclose(float(res[r]["bvh_loss"]), float(jloss), rtol=1e-5)
        for i in range(5):
            np.testing.assert_array_equal(res[r][f"bvh_g{i}"], res[0][f"bvh_g{i}"])
            np.testing.assert_allclose(res[r][f"bvh_g{i}"], g1[i], atol=1e-5)
            np.testing.assert_allclose(res[r][f"bvh_g{i}"], np.asarray(jg[i]), atol=1e-5)
    assert max(np.abs(x).max() for x in g1) > 1e-3


def test_shaded_refit_sharded_grad_matches_one_rank(ranks):
    # a ShadedWideBVH refit from the live vertices at every evaluation
    # (the plain wide_shade here): the sharded gradient equals one rank's
    job, res, _ = ranks
    scene = scene_from_numpy(job["scene"]).to("cpu")
    loss1, g1 = _one_rank(job, build_shaded_accel(scene, KDTreeConfig(leaf_size=8)), 2,
                          refit=True)
    for r in range(WORLD):
        np.testing.assert_allclose(float(res[r]["shaded_loss"]), loss1, rtol=1e-5)
        for i in range(5):
            np.testing.assert_allclose(res[r][f"shaded_g{i}"], g1[i], atol=1e-5)
    assert np.abs(g1[0]).max() > 1e-4


def test_sharded_train_step_reduces_loss(ranks):
    # 60 albedo steps (Adam 5e-2, 2 bounces) on the sharded trace's own
    # target: the loss falls below a quarter of its first value, as
    # test_train_step_reduces_loss asserts
    _, res, _ = ranks
    losses = res[0]["train_losses"]
    assert losses.shape == (TRAIN_STEPS,)
    assert losses[-1] < losses[0] * 0.25, losses


def test_replicated_params_bit_equal_across_ranks(ranks):
    # every rank steps on the same summed gradient: the albedo after each
    # of the 60 steps, and the losses, are bit-equal on the 3 ranks
    _, res, _ = ranks
    for r in range(1, WORLD):
        np.testing.assert_array_equal(res[r]["train_albedo"], res[0]["train_albedo"])
        np.testing.assert_array_equal(res[r]["train_losses"], res[0]["train_losses"])
    assert not np.array_equal(res[0]["train_albedo"][0], res[0]["train_albedo"][-1])


def test_kill_and_resume_reproduce_the_sharded_run(ranks):
    # a run killed after step 3 resumes from rank 0's step-2 checkpoint
    # (rank 0 writes, every rank reads) and ends bit-equal to the
    # uninterrupted run, its losses those of the steps it reran
    _, res, _ = ranks
    steps, kill, every = RESUME
    for r in range(WORLD):
        assert int(res[r]["ck_step"]) == kill - kill % every
        np.testing.assert_array_equal(res[r]["resumed_params"], res[r]["full_params"])
        np.testing.assert_array_equal(res[r]["resumed_losses"],
                                      res[r]["full_losses"][kill - kill % every:])
        np.testing.assert_array_equal(res[r]["full_params"], res[0]["full_params"])


def test_reduce_grads_and_gather_backward(ranks):
    # reduce_grads sums over the ranks and passes None through; the film
    # gather's backward is this rank's own block of the cotangent, not a
    # sum over ranks; without a mesh both are the identity
    _, res, _ = ranks
    for r in range(WORLD):
        np.testing.assert_array_equal(res[r]["reduced"], [6.0] + [3.0] * 4)
        assert bool(res[r]["reduced_none"])
        np.testing.assert_array_equal(res[r]["gather_grad"], np.arange(4.0 * r, 4.0 * r + 4))
    x = [torch.ones(2), None]
    assert reduce_grads(x, None) == x
    one = make_device_mesh(device="cpu")
    assert reduce_grads(x, one) == x
    t = torch.ones(3)
    assert gather_rows_grad(t, one) is t


def test_inverse_render_example_converges_under_ranks(ranks):
    # the example on 3 ranks (--device cpu --dist-backend gloo): rank 0
    # prints the reference's lines, the last loss under half the first
    # (test_inverse_render_example_converges); the other ranks print nothing
    _, _, out = ranks
    text = open(os.path.join(out, "example_rank0.txt")).read()
    assert "288 rays over 3 device(s); 480 tris" in text
    lines = [line for line in text.splitlines() if line.startswith("step")]
    first = float(lines[0].split("loss")[1].split()[0])
    last = float(lines[-1].split("loss")[1].split()[0])
    assert len(lines) == 4 and last < first * 0.5, text
    assert "Mray-steps/s incl. backward" in text
    for r in range(1, WORLD):
        assert open(os.path.join(out, f"example_rank{r}.txt")).read() == ""
