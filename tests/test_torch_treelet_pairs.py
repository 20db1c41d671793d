"""PyTorch port, the pair-binned bounce traversal
(``kernels/treelet_pairs.py``): Phase A and Phase B plain versions against
the JAX Pallas kernels (interpret mode) on identical tables, the port's
``treelet_pair_hit`` against its own ``wide_shade`` walk (bit-for-bit) and
against the JAX one, a refit, and the ``pair_bounces`` film and gradient
against the default path within the port."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from atray_tpu.accel.shaded import build_shaded_accel as jax_build_shaded_accel  # noqa: E402
from atray_tpu.config import KDTreeConfig as JaxKDTreeConfig  # noqa: E402
from atray_tpu.kernels import treelet_pairs as jtp  # noqa: E402
from atray_tpu.scene import build_scene as jax_build_scene  # noqa: E402
from atray_tpu.scene import procedural as jax_procedural  # noqa: E402
from atray_tpu.scene.data import make_materials as jax_make_materials  # noqa: E402
from atray_tpu.scene.transforms import translate as jax_translate  # noqa: E402
from test_torch_render import _accel_fields, _tree  # noqa: E402

from atray_tpu_torch.accel.shaded import build_shaded_accel, refit_shaded  # noqa: E402
from atray_tpu_torch.config import KDTreeConfig, RenderSettings  # noqa: E402
from atray_tpu_torch.core.camera import look_at_camera  # noqa: E402
from atray_tpu_torch.core.intersect import INF, moller_trumbore  # noqa: E402
from atray_tpu_torch.interop import scene_from_numpy, shaded_accel_from_numpy  # noqa: E402
from atray_tpu_torch.kernels import _build  # noqa: E402
from atray_tpu_torch.kernels.treelet_pairs import (  # noqa: E402
    PAIR_K,
    pair_cap,
    treelet_candidates,
    treelet_candidates_ref,
    treelet_pair_hit,
    treelet_pair_walk,
    treelet_pair_walk_ref,
)
from atray_tpu_torch.kernels.wide_shade import wide_shade_planes, wide_shade_planes_ref  # noqa: E402
from atray_tpu_torch.render import wavefront as tw  # noqa: E402
from atray_tpu_torch.render.rng import prng_key  # noqa: E402
from atray_tpu_torch.scene.data import SceneParams  # noqa: E402

OUT = ("t", "id", "nx", "ny", "nz", "mat")


def _jax_scene(tris):
    mats = jax_make_materials([((0.3, 0.4, 0.6), (0.0, 0.0, 0.0), 0.0),
                               ((0.0, 0.0, 0.0), (0.7, 0.6, 0.5), 0.1)])
    mesh = jax_translate(jax_procedural.dragon_proxy(target_tris=tris, material=1),
                         (0.0, 0.0, -4.0))
    return jax_build_scene([mesh], materials=mats)


def _accels(tris=1200, lpt=2, leaf=16):
    """The reference's test accel (dragon_proxy, leaf 16) in both packages,
    the port's built from the reference's tables."""
    ja = jax_build_shaded_accel(_jax_scene(tris),
                                JaxKDTreeConfig(leaf_size=leaf, leaves_per_treelet=lpt))
    return ja, shaded_accel_from_numpy(_accel_fields(ja)).to("cpu")


def _rays(n, kind, rng):
    """The reference's test rays: bounce-like (origins near the mesh shell,
    random directions) or camera-like (one origin, directions at the mesh)."""
    if kind == "hemisphere":
        o = rng.normal(size=(n, 3)) * 0.8 + [0, 0, -4]
        d = rng.normal(size=(n, 3))
    else:
        o = np.tile([0.0, 0.5, 0.5], (n, 1)) + rng.normal(size=(n, 3)) * 0.02
        d = np.asarray([0, -0.1, -1.0]) + rng.normal(size=(n, 3)) * 0.35
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _planes(o, d):
    return [torch.from_numpy(np.ascontiguousarray(a[:, k])) for a in (o, d) for k in range(3)]


def _jplanes(o, d):
    return [jnp.asarray(a[:, k]) for a in (o, d) for k in range(3)]


def test_phase_a_plain_matches_jax_kernel(rng):
    ja, accel = _accels()
    tb = accel.tboxes.numpy()
    assert accel.num_treelets % 8 != 0 and np.isnan(tb[:, :48]).any()   # NaN row-pad lanes
    o, d = _rays(512, "hemisphere", rng)
    alive = rng.random(512) >= 0.1
    jt, jb = jtp.treelet_candidates(ja, *_jplanes(o, d), jnp.asarray(alive, jnp.float32),
                                    k_slots=3, interpret=True)
    before = _build.COUNTERS["treelet_phase_a"].plain_calls
    tids, bound = treelet_candidates(accel, *_planes(o, d), torch.from_numpy(alive), 3)
    assert _build.COUNTERS["treelet_phase_a"].plain_calls == before + 1
    assert tids.dtype == torch.int32 and tids.shape == (3, 512)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jt).astype(np.int32))
    np.testing.assert_array_equal(bound.numpy().view(np.int32), np.asarray(jb).view(np.int32))
    assert (tids.numpy() >= 0).sum() > 300 and (bound.numpy() < 1e30).sum() > 20
    assert np.all(tids.numpy()[:, ~alive] == -1) and np.all(bound.numpy()[~alive] == np.float32(INF))
    assert tids.max() < accel.num_treelets                 # no pad lane is ever a candidate


def _binned_pairs(tids, n, k, num_treelets, cap):
    """The reference's binning in numpy: k-major keys, stable argsort, cap."""
    bigk = num_treelets + 1
    keys = np.where(tids >= 0, tids, bigk).reshape(-1)
    sel = np.argsort(keys, kind="stable")[:cap]
    ptid = np.where(keys[sel] < bigk, keys[sel], -1).astype(np.int32)
    return sel % n, ptid


def test_phase_b_plain_matches_jax_kernel(rng):
    ja, accel = _accels()
    n, k = 512, 3
    o, d = _rays(n, "hemisphere", rng)
    tids, _ = treelet_candidates_ref(accel, *_planes(o, d), torch.ones(n, dtype=torch.bool), k)
    rid, ptid = _binned_pairs(tids.numpy(), n, k, accel.num_treelets, pair_cap(n, k, 1.0))
    po, pd = o[rid], d[rid]
    ref = jtp.treelet_pair_walk(ja, *_jplanes(po, pd), jnp.asarray(ptid, jnp.float32),
                                interpret=True)
    got = treelet_pair_walk(accel, *_planes(po, pd), torch.from_numpy(ptid))
    assert got["id"].dtype == torch.int32 and got["mat"].dtype == torch.int32
    ref = {key: np.asarray(v) for key, v in ref.items()}
    got = {key: v.numpy() for key, v in got.items()}
    np.testing.assert_array_equal(got["id"], ref["id"])
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)
    for key in ("nx", "ny", "nz"):
        np.testing.assert_allclose(got[key], ref[key], atol=1e-5)
    np.testing.assert_array_equal(got["mat"], ref["mat"])
    assert (got["id"] >= 0).sum() > 40
    dead = ptid < 0
    assert dead.any() and np.all(got["t"][dead] == np.float32(INF))
    assert np.all(got["id"][dead] == -1) and np.all(got["mat"][dead] == 0)


@pytest.mark.parametrize("kind,lpt,k_slots,cap_frac", [
    ("camera", 4, PAIR_K, 0.5), ("hemisphere", 2, PAIR_K, 0.5), ("camera", 2, 2, 0.25)])
def test_pair_hit_equals_wide_shade_walk(kind, lpt, k_slots, cap_frac, rng):
    # within the port the pair path returns the walk's planes bit-for-bit;
    # k_slots=2, cap_frac=0.25 drops pairs, so the fallback must run
    _, accel = _accels(tris=2500, lpt=lpt)
    n = 2048
    o, d = _rays(n, kind, rng)
    alive = torch.from_numpy(rng.random(n) < 0.85)
    planes = _planes(o, d)
    ref = wide_shade_planes_ref(accel, *planes, alive)
    got, unres = treelet_pair_hit(accel, *planes, alive, k_slots=k_slots, cap_frac=cap_frac)
    for key in OUT:
        assert torch.equal(got[key], ref[key]), key
    assert float((ref["id"][alive] >= 0).float().mean()) > 0.08
    assert not unres[~alive].any()
    if cap_frac < 0.5:
        assert unres.any()


def test_pair_hit_matches_jax_pair_hit(rng):
    # the JAX side without its fallback walk (an interpret-mode wide_shade
    # call costs minutes here): its unresolved mask and, on the resolved
    # rays, its planes; the port's fallback is held to its walk above
    ja, accel = _accels()
    n = 256
    o, d = _rays(n, "hemisphere", rng)
    alive = rng.random(n) < 0.85
    ref, ref_unres = jtp.treelet_pair_hit(ja, *_jplanes(o, d), jnp.asarray(alive, jnp.float32),
                                          k_slots=PAIR_K, cap_frac=0.5, interpret=True,
                                          residual=False)
    got, unres = treelet_pair_hit(accel, *_planes(o, d), torch.from_numpy(alive))
    np.testing.assert_array_equal(unres.numpy(), np.asarray(ref_unres))
    ok = ~unres.numpy()
    assert unres.any() and (ok & alive).sum() > 100
    ref = {key: np.asarray(v)[ok] for key, v in ref.items()}
    got = {key: v.numpy()[ok] for key, v in got.items()}
    tie = got["id"] != ref["id"]
    assert tie.sum() <= 2, f"{tie.sum()} id differences"
    assert (got["id"] >= 0).sum() > 20
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)
    for key in ("nx", "ny", "nz"):
        np.testing.assert_allclose(got[key], ref[key], atol=1e-5)
    np.testing.assert_array_equal(got["mat"], ref["mat"])


def test_refit_pair_hit_matches_brute_force(rng):
    # the reference's refit test: move the vertices, refit, and both the
    # walk and the pair path find the brute-force hit on the moved mesh
    mesh = jax_procedural.uv_sphere(rows=12, cols=12)
    mats = jax_make_materials([((0.1, 0.1, 0.1), (0.0, 0.0, 0.0), 0.0),
                               ((0.0, 0.0, 0.0), (0.5, 0.5, 0.5), 0.0)])
    scene = scene_from_numpy(_tree(jax_build_scene([mesh], materials=mats))).to("cpu")
    accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=8, leaves_per_treelet=2)).to("cpu")
    v_new = scene.mesh.vertices + torch.from_numpy(
        rng.normal(0.0, 0.02, tuple(scene.mesh.vertices.shape)).astype(np.float32))
    moved = scene.with_params(dataclasses.replace(scene.params(), vertices=v_new))
    acc = refit_shaded(accel, moved)
    n = 128
    orig = rng.normal(0, 3.0, (n, 3)).astype(np.float32)
    dirn = (orig / np.linalg.norm(orig, axis=1, keepdims=True)).astype(np.float32)
    orig = (-3.0 * dirn).astype(np.float32)
    planes = _planes(orig, dirn)
    alive = torch.ones(n, dtype=torch.bool)
    wide = wide_shade_planes(acc, *planes, alive)
    pair, _ = treelet_pair_hit(acc, *planes, alive, k_slots=3, cap_frac=1.0)
    f = scene.mesh.faces.long()
    p0 = v_new[f[:, 0]]
    t_b, _, _, hit_b = moller_trumbore(torch.from_numpy(orig)[:, None], torch.from_numpy(dirn)[:, None],
                                       p0[None], (v_new[f[:, 1]] - p0)[None],
                                       (v_new[f[:, 2]] - p0)[None])
    id_b = torch.where(hit_b.any(1), torch.argmin(t_b, dim=1), -1)
    for got in (wide, pair):
        np.testing.assert_allclose(got["t"].numpy(), t_b.min(dim=1).values.numpy(), rtol=1e-5)
        np.testing.assert_array_equal(got["id"].numpy(), id_b.numpy())
    assert int((id_b >= 0).sum()) > 50


def _port_scene(tris=1500):
    return scene_from_numpy(_tree(_jax_scene(tris))).to("cpu")


def test_pair_bounces_film_and_gradient_equal_default():
    # the reference's film identity, within the port (64x32, 1 spp, 3
    # bounces, sorted); the backward replays the saved face ids, so the
    # gradients are the default path's too, and no pair kernel runs there
    scene = _port_scene()
    accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=16, leaves_per_treelet=2)).to("cpu")
    cam = look_at_camera((0, 0.7, 0.8), (0, 0, -4), h_fov=0.9, aspect=2.0)
    base = RenderSettings(resolution=(64, 32), samples_per_pixel=1, bounce_limit=3)
    out = {}
    for pair in (False, True):
        p = SceneParams(*(x.detach().clone().requires_grad_() for x in scene.params().leaves()))
        a0 = _build.COUNTERS["treelet_phase_a"].plain_calls
        film = tw.render(scene.with_params(p), cam, dataclasses.replace(base, pair_bounces=pair),
                         prng_key(5), accel=accel, device="cpu")
        calls = _build.COUNTERS["treelet_phase_a"].plain_calls - a0
        grads = torch.autograd.grad(film.sum(), p.leaves())
        assert _build.COUNTERS["treelet_phase_a"].plain_calls - a0 == calls   # forward only
        out[pair] = (film.detach(), grads, calls)
    assert out[False][2] == 0 and out[True][2] == 2        # bounces 1 and 2
    assert torch.equal(out[True][0], out[False][0])
    assert float(out[False][0].std()) > 0.01
    for a, b in zip(out[True][1], out[False][1]):
        assert torch.equal(a, b)
    assert float(out[False][1][0].abs().max()) > 0         # vertices


def test_wrappers_check_inputs_and_build_nothing_on_cpu(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the CUDA kernels")

    monkeypatch.setattr(_build, "load", no_build)
    _, accel = _accels(tris=300)
    o, d = _rays(8, "camera", np.random.default_rng(0))
    planes = _planes(o, d)
    alive = torch.ones(8, dtype=torch.bool)
    treelet_pair_hit(accel, *planes, alive)
    with pytest.raises(TypeError):
        treelet_candidates(accel, *planes, alive.float())
    with pytest.raises(ValueError, match="k_slots"):
        treelet_candidates(accel, *planes, alive, k_slots=9)
    with pytest.raises(ValueError, match="treelet view"):
        treelet_candidates(dataclasses.replace(accel, num_treelets=0), *planes, alive)
    with pytest.raises(TypeError):
        treelet_pair_walk(accel, *planes, torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError):
        treelet_pair_walk(accel, torch.zeros(16)[::2], *planes[1:], torch.zeros(8, dtype=torch.int32))
    host = shaded_accel_from_numpy(_accel_fields(_accels(tris=300)[0]))
    with pytest.raises(TypeError):
        treelet_candidates(host, *planes, alive)                  # not uploaded


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    _, accel = _accels(tris=20000, lpt=4)
    accel = accel.to(dev)
    rng = np.random.default_rng(5)
    o, d = _rays(20000, "hemisphere", rng)
    planes = [p.to(dev) for p in _planes(o, d)]
    alive = torch.from_numpy(rng.random(20000) >= 0.1).to(dev)
    got = treelet_candidates(accel, *planes, alive)
    want = treelet_candidates_ref(accel, *planes, alive)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    ptid = got[0][0].contiguous()
    got = treelet_pair_walk(accel, *planes, ptid)
    want = treelet_pair_walk_ref(accel, *planes, ptid)
    for key in OUT:
        assert torch.equal(got[key], want[key]), key
    pair, _ = treelet_pair_hit(accel, *planes, alive)
    walk = wide_shade_planes(accel, *planes, alive)
    torch.cuda.synchronize()
    for key in OUT:
        assert torch.equal(pair[key], walk[key]), key
