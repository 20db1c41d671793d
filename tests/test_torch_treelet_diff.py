"""PyTorch port: the differentiable treelet backends (``dist/treelet.py``'s
``TreeletParts`` and ``TreeletShards``, ``diff_row_pickup`` and its reverse
ring, ``reduce_grads``): twins of ``tests/test_treelet.py``'s
differentiable cases.

As in ``tests/test_torch_dist.py`` (whose ``spawn_ranks`` it uses), one
spawn of 3 gloo ranks runs every case's rank side and the cases assert in
the parent. The ranks import this file, so it imports nothing of JAX at
module level; the JAX references render by brute force on a mesh of 3 of
the conftest's 8 virtual CPU devices, jitted without LLVM's optimizations
(as ``tests/test_torch_treelet.py``'s), one compile for the replicated
film and gradients and one for each treelet film."""

import dataclasses
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from test_torch_dist import spawn_ranks  # noqa: E402

from atray_tpu_torch.config import RenderSettings  # noqa: E402
from atray_tpu_torch.core.camera import look_at_camera  # noqa: E402
from atray_tpu_torch.dist.mesh import gather_rows, make_device_mesh  # noqa: E402
from atray_tpu_torch.dist.train import reduce_grads  # noqa: E402
from atray_tpu_torch.dist.treelet import (  # noqa: E402
    build_treelet_parts,
    build_treelet_shards,
    diff_row_pickup,
    merge_normal_grads,
    merge_vertex_grads,
    render_treelet,
    shard_records,
    treelet_records,
)
from atray_tpu_torch.interop import scene_from_numpy  # noqa: E402
from atray_tpu_torch.render.rng import prng_key  # noqa: E402
from atray_tpu_torch.scene.data import SceneParams  # noqa: E402

WORLD = 3
EYE, TARGET = (0.0, 0.4, 0.6), (0.0, 0.0, -4.0)
FILM = RenderSettings(resolution=(16, 16), samples_per_pixel=1, bounce_limit=2,
                      sort_bounces=False)
PICK_RAYS, PICK_FACES = 10, 40        # the pickup case: rays a rank, faces of the table
STEPS = 40


def _cam():
    return look_at_camera(EYE, TARGET, h_fov=0.9, aspect=1.0)


def _grads(loss, leaves):
    g = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if y is None else y for x, y in zip(leaves, g)]


def _diff_rank(rank, job, out):
    """The rank side of every case."""
    mesh = make_device_mesh(WORLD, device="cpu")
    scene = scene_from_numpy(job["scene"]).to("cpu")
    cam = _cam()
    res = {}
    # the pickup ring on a random global table; rank 0's fids are all -1
    owner, lrow = (torch.from_numpy(job["pick"][k]) for k in ("owner", "lrow"))
    table = job["pick"]["table"]
    mine = np.flatnonzero(job["pick"]["owner"] == rank)
    recs = torch.from_numpy(table[mine]).requires_grad_()
    fid = torch.from_numpy(job["pick"]["fids"][rank])
    hops = []
    row = diff_row_pickup(recs, owner, lrow, fid, mesh, hops)
    (d_recs,) = torch.autograd.grad((row * torch.from_numpy(job["pick"]["w"][rank])).sum(), recs)
    res.update(pick_row=row.detach().numpy(), pick_grad=d_recs.numpy(),
               pick_hops=np.asarray([[h["reverse"], h["bytes"]] for h in hops]))
    # TreeletParts: the film and the five gradients, summed over the ranks
    parts = build_treelet_parts(scene, WORLD)
    p = SceneParams(*(x.clone().requires_grad_() for x in scene.params().leaves()))
    hops = []
    film = render_treelet(scene.with_params(p), cam, FILM, prng_key(0), mesh, treelets=parts,
                          hop_log=hops)
    n_fwd = len(hops)
    g = reduce_grads(_grads(film.sum(), p.leaves()), mesh)
    res.update(parts_film=film.detach().numpy(),
               parts_rings=np.asarray([h["ring"] for h in hops]),
               parts_reverse=np.asarray([h["reverse"] for h in hops]), parts_n_fwd=n_fwd,
               **{f"parts_g{i}": x.numpy() for i, x in enumerate(g)})
    # TreeletShards: this rank's part only; its gradients gathered in rank order
    shard = build_treelet_shards(scene, WORLD).local(rank, "cpu")
    v, n = shard.vertices.requires_grad_(), shard.normals.requires_grad_()
    film = render_treelet(scene, cam, FILM, prng_key(0), mesh, treelets=shard)
    gv, gn = _grads(film.sum(), [v, n])
    res.update(shards_film=film.detach().numpy(), shards_v_shape=np.asarray(v.shape),
               shards_gv=gather_rows(gv[None], mesh).numpy(),
               shards_gn=gather_rows(gn[None], mesh).numpy())
    # the inverse albedo recovery through TreeletParts (Adam 0.05)
    p0 = scene.params()
    target = render_treelet(scene, cam, FILM, prng_key(7), mesh, treelets=parts)
    a1 = torch.tensor([0.2, 0.7, 0.6], requires_grad=True)
    opt = torch.optim.Adam([a1], lr=0.05)
    losses = []
    for _ in range(STEPS):
        alb = torch.cat([p0.albedo[:1], a1[None], p0.albedo[2:]])
        f = render_treelet(scene.with_params(dataclasses.replace(p0, albedo=alb)), cam, FILM,
                           prng_key(7), mesh, treelets=parts)
        lv = torch.mean((f - target) ** 2)
        (a1.grad,) = reduce_grads(_grads(lv, [a1]), mesh)
        opt.step()
        losses.append(float(lv))
    res.update(inv_losses=np.asarray(losses), inv_albedo=a1.detach().numpy(),
               inv_true=p0.albedo[1].numpy())
    np.savez(os.path.join(out, f"rank{rank}.npz"), **res)


def _jax_scene():
    """``tests/test_treelet.py``'s scene: a smooth 8x8 uv sphere."""
    from atray_tpu.scene import build_scene, procedural
    from atray_tpu.scene.data import make_materials
    from atray_tpu.scene.transforms import translate

    mats = make_materials([((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),
                           ((0.0, 0.0, 0.0), (0.8, 0.5, 0.3), 0.2)])
    mesh = translate(procedural.uv_sphere(rows=8, cols=8, material=1, smooth=True), (0, 0, -4))
    return build_scene([mesh], materials=mats)


def _pick_job():
    """A random (T, 20) table split over the ranks, per rank fids (rank 0's
    all -1, the others' with some -1) and cotangent weights."""
    rng = np.random.default_rng(5)
    owner = rng.integers(0, WORLD, PICK_FACES).astype(np.int32)
    lrow = np.zeros(PICK_FACES, np.int32)
    for r in range(WORLD):
        lrow[owner == r] = np.arange((owner == r).sum())
    fids = rng.integers(-1, PICK_FACES, (WORLD, PICK_RAYS)).astype(np.int32)
    fids[0] = -1
    return {"table": rng.normal(size=(PICK_FACES, 20)).astype(np.float32), "owner": owner,
            "lrow": lrow, "fids": fids,
            "w": rng.normal(size=(WORLD, PICK_RAYS, 20)).astype(np.float32)}


@pytest.fixture(scope="module")
def jscene():
    return _jax_scene()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jscene):
    """(job, {rank: results}) of the one spawn of 3 ranks."""
    from test_torch_render import _tree

    out = str(tmp_path_factory.mktemp("treelet_diff_ranks"))
    job = {"scene": _tree(jscene), "pick": _pick_job()}
    spawn_ranks(_diff_rank, job, out)
    return job, {r: dict(np.load(os.path.join(out, f"rank{r}.npz"))) for r in range(WORLD)}


@pytest.fixture(scope="module")
def jax_ref(jscene, devices):
    """The reference's replicated film and gradients (jax.value_and_grad of
    sum(render)), its render_treelet films with TreeletParts and
    TreeletShards, and its shards."""
    import jax
    import jax.numpy as jnp

    from atray_tpu.config import RenderSettings as JaxRenderSettings
    from atray_tpu.core.camera import look_at_camera as jax_look_at_camera
    from atray_tpu.dist.mesh import make_device_mesh as jax_make_device_mesh
    from atray_tpu.dist.treelet import build_treelet_parts as jax_build_treelet_parts
    from atray_tpu.dist.treelet import build_treelet_shards as jax_build_treelet_shards
    from atray_tpu.dist.treelet import render_treelet as jax_render_treelet
    from atray_tpu.render.wavefront import render as jax_render

    s = JaxRenderSettings(resolution=FILM.resolution, samples_per_pixel=1, bounce_limit=2,
                          sort_bounces=False)
    cam = jax_look_at_camera(EYE, TARGET, h_fov=0.9, aspect=1.0)
    mesh = jax_make_device_mesh(WORLD)
    key = jax.random.PRNGKey(0)
    opts = {"xla_backend_optimization_level": 0}

    def loss_rep(p):
        film = jax_render(jscene.with_params(p), cam, s, key)
        return jnp.sum(film), film

    (_, film), g = jax.jit(jax.value_and_grad(loss_rep, has_aux=True),
                           compiler_options=opts)(jscene.params())
    parts = jax_build_treelet_parts(jscene, WORLD)
    shards = jax_build_treelet_shards(jscene, WORLD)
    films = {name: np.asarray(jax.jit(
        lambda k, t=t: jax_render_treelet(jscene, cam, s, k, mesh, treelets=t),
        compiler_options=opts)(key)) for name, t in (("parts", parts), ("shards", shards))}
    return {"film": np.asarray(film), "grads": [np.asarray(x) for x in
                                                jax.tree_util.tree_leaves(g)],
            "films": films, "parts": parts, "shards": shards}


def test_tables_equal_reference(jscene):
    # build_treelet_parts and build_treelet_shards exact; treelet_records and
    # shard_records (each part from its own slices) allclose, ids exact;
    # merge_*_grads equal the reference's on random per-copy gradients
    import jax.numpy as jnp

    from atray_tpu.dist import treelet as jt

    from test_torch_render import _tree

    scene = scene_from_numpy(_tree(jscene)).to("cpu")
    got_p, want_p = build_treelet_parts(scene, WORLD), jt.build_treelet_parts(jscene, WORLD)
    for k in ("idx", "owner", "lrow"):
        np.testing.assert_array_equal(getattr(got_p, k), np.asarray(getattr(want_p, k)))
    recs = treelet_records(scene, got_p).numpy()
    want = np.asarray(jt.treelet_records(jscene, want_p))
    np.testing.assert_array_equal(recs[..., 18:], want[..., 18:])
    np.testing.assert_allclose(recs, want, atol=1e-6)
    got_s, want_s = build_treelet_shards(scene, WORLD), jt.build_treelet_shards(jscene, WORLD)
    for f in dataclasses.fields(got_s):
        a, b = getattr(got_s, f.name), np.asarray(getattr(want_s, f.name))
        assert a.dtype == b.dtype, f.name
        np.testing.assert_array_equal(a, b)
    for r in range(WORLD):
        sh = got_s.local(r, "cpu")
        got = shard_records(sh.vertices, sh.normals, sh.faces, sh.fnidx, sh.matid, sh.fid)
        ref = jt.shard_records(*(jnp.asarray(getattr(want_s, k))[r] for k in
                                 ("vertices", "normals", "faces", "fnidx", "matid", "fid")))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
        np.testing.assert_allclose(got.numpy(), recs[r], atol=1e-6)
    rng = np.random.default_rng(2)
    gv = rng.normal(size=got_s.vertices.shape).astype(np.float32)
    gn = rng.normal(size=got_s.normals.shape).astype(np.float32)
    nv, nn = int(jscene.mesh.num_vertices), jscene.mesh.normals.shape[0]
    np.testing.assert_allclose(merge_vertex_grads(got_s, torch.from_numpy(gv), nv).numpy(),
                               np.asarray(jt.merge_vertex_grads(want_s, jnp.asarray(gv), nv)),
                               atol=1e-6)
    np.testing.assert_allclose(merge_normal_grads(got_s, torch.from_numpy(gn), nn).numpy(),
                               np.asarray(jt.merge_normal_grads(want_s, jnp.asarray(gn), nn)),
                               atol=1e-6)


def test_diff_row_pickup_forward_is_a_plain_gather(ranks):
    # after 3 hops every ray holds its face's row from the owning rank;
    # fid -1 keeps a zero row (rank 0's rays are all -1)
    job, res = ranks
    pick = job["pick"]
    for r in range(WORLD):
        fid = pick["fids"][r]
        want = np.where((fid >= 0)[:, None], pick["table"][np.maximum(fid, 0)], 0.0)
        np.testing.assert_array_equal(res[r]["pick_row"], want)
    assert not res[0]["pick_row"].any()


def test_diff_row_pickup_backward_is_index_add_on_the_owner(ranks):
    # the reverse ring brings each lane's cotangent to the owner's row:
    # every rank's records' gradient equals index_add_ of all the ranks'
    # cotangents into its rows (rank 0, whose rays pick up nothing, still
    # receives the others'); the backward carries 20 words a ray, 3 hops
    job, res = ranks
    pick = job["pick"]
    for r in range(WORLD):
        mine = np.flatnonzero(pick["owner"] == r)
        want = np.zeros((len(mine), 20), np.float32)
        for q in range(WORLD):
            for lane, f in enumerate(pick["fids"][q]):
                if f >= 0 and pick["owner"][f] == r:
                    want[pick["lrow"][f]] += pick["w"][q][lane]
        np.testing.assert_allclose(res[r]["pick_grad"], want, atol=1e-6)
        log = res[r]["pick_hops"]
        assert log.tolist() == [[0, 21 * 4 * PICK_RAYS]] * WORLD + [[1, 20 * 4 * PICK_RAYS]] * WORLD
    assert np.abs(res[0]["pick_grad"]).max() > 0


def test_treelet_parts_film_matches_jax(ranks, jax_ref):
    # every rank's film equals the reference's render_treelet(TreeletParts)
    # and its replicated render
    _, res = ranks
    for r in range(WORLD):
        np.testing.assert_allclose(res[r]["parts_film"], jax_ref["films"]["parts"], atol=1e-5)
        np.testing.assert_allclose(res[r]["parts_film"], jax_ref["film"], atol=1e-5)
    assert jax_ref["film"].std() > 0.01


def test_treelet_parts_grads_match_replicated_jax(ranks, jax_ref):
    # the five gradients, summed over the ranks by reduce_grads, equal the
    # reference's replicated render gradients (test_treelet_diff_grads_
    # match_replicated's tolerance); the forward ran first_fid and pickup
    # rings, the backward pickup hops only, on the reverse ring
    _, res = ranks
    for r in range(WORLD):
        for i, want in enumerate(jax_ref["grads"]):
            np.testing.assert_allclose(res[r][f"parts_g{i}"], want, atol=1e-4, rtol=1e-3)
    assert max(np.abs(x).max() for x in jax_ref["grads"]) > 1e-4
    n_fwd = int(res[0]["parts_n_fwd"])
    rings, rev = res[0]["parts_rings"], res[0]["parts_reverse"]
    assert rings[:n_fwd].tolist() == (["first_fid"] * WORLD + ["pickup"] * WORLD) * 2
    assert n_fwd < len(rings) and not rev[:n_fwd].any()
    assert set(rings[n_fwd:]) == {"pickup"} and rev[n_fwd:].all()


def test_treelet_shards_film_and_merged_grads(ranks, jax_ref, jscene):
    # each rank holds only its part's vertex slots; the film equals the
    # reference's render_treelet(TreeletShards), and the per-copy
    # gradients, gathered and merged, equal the replicated vertex and
    # normal gradients
    _, res = ranks
    shards = jax_ref["shards"]
    nv, nn = jax_ref["grads"][0].shape[0], jax_ref["grads"][1].shape[0]
    for r in range(WORLD):
        np.testing.assert_allclose(res[r]["shards_film"], jax_ref["films"]["shards"], atol=1e-5)
        assert tuple(res[r]["shards_v_shape"]) == shards.vertices.shape[1:]
        assert shards.vertices.shape[1] < nv
    from test_torch_render import _tree

    host = build_treelet_shards(scene_from_numpy(_tree(jscene)), WORLD)
    gv = merge_vertex_grads(host, torch.from_numpy(res[0]["shards_gv"]), nv).numpy()
    gn = merge_normal_grads(host, torch.from_numpy(res[0]["shards_gn"]), nn).numpy()
    np.testing.assert_allclose(gv, jax_ref["grads"][0], atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(gn, jax_ref["grads"][1], atol=1e-4, rtol=1e-3)
    assert np.abs(gv).max() > 1e-4


def test_treelet_inverse_albedo_recovers(ranks):
    # 40 Adam steps on the albedo through the geometry-sharded render: the
    # loss falls under 0.2 of its first, the albedo within 0.15 of the
    # truth (test_treelet_inverse_albedo_recovers), equal on every rank
    _, res = ranks
    losses = res[0]["inv_losses"]
    assert losses.shape == (STEPS,) and losses[-1] < losses[0] * 0.2, losses
    assert np.abs(res[0]["inv_albedo"] - res[0]["inv_true"]).max() < 0.15
    for r in range(1, WORLD):
        np.testing.assert_array_equal(res[r]["inv_albedo"], res[0]["inv_albedo"])
