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

from atray_tpu_torch.accel.shaded import build_shaded_accel, leaf_planes, refit_shaded  # noqa: E402
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


def _axis_rays(tboxes, num_treelets, n, rng):
    """Axis-aligned rays: directions with two or one zero components (their
    inverse is the 1e30 stand-in), origins inside treelet boxes with one
    coordinate on a box plane, so some slab distances are exactly 0."""
    t = rng.integers(0, num_treelets, n)
    row, c = t // 8, t % 8
    lo = np.stack([tboxes[row, 8 * a + c] for a in range(3)], 1).astype(np.float64)
    hi = np.stack([tboxes[row, 24 + 8 * a + c] for a in range(3)], 1).astype(np.float64)
    o = lo + rng.random((n, 3)) * (hi - lo)
    ax = rng.integers(0, 3, n)
    on = np.arange(n)
    o[on, ax] = np.where(rng.random(n) < 0.5, lo[on, ax], hi[on, ax])
    d = np.where(rng.random((n, 3)) < 0.5, -1.0, 1.0) * (rng.random((n, 3)) < 0.3)
    zero = rng.integers(0, 3, n)
    d[on, zero] = 0.0
    d[on, (zero + rng.integers(1, 3, n)) % 3] = np.where(rng.random(n) < 0.5, -1.0, 1.0)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("kind", ["hemisphere", "axis"])
def test_phase_a_plain_matches_jax_kernel(kind, rng):
    ja, accel = _accels()
    tb = accel.tboxes.numpy()
    assert accel.num_treelets % 8 != 0 and np.isnan(tb[:, :48]).any()   # NaN row-pad lanes
    if kind == "hemisphere":
        o, d = _rays(512, "hemisphere", rng)
    else:
        o, d = _axis_rays(tb, accel.num_treelets, 512, rng)
        assert (d == 0).any(axis=1).all() and (d == 0).all(axis=0).sum() == 0
    alive = rng.random(512) >= 0.1
    jt, jb = jtp.treelet_candidates(ja, *_jplanes(o, d), jnp.asarray(alive, jnp.float32),
                                    k_slots=3, interpret=True)
    before = _build.COUNTERS["treelet_phase_a"].plain_calls
    tids, bound = treelet_candidates(accel, *_planes(o, d), torch.from_numpy(alive), 3)
    assert _build.COUNTERS["treelet_phase_a"].plain_calls == before + 1
    assert tids.dtype == torch.int32 and tids.shape == (3, 512)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jt).astype(np.int32))
    np.testing.assert_array_equal(bound.numpy().view(np.int32), np.asarray(jb).view(np.int32))
    if kind == "hemisphere":
        assert (tids.numpy() >= 0).sum() > 300 and (bound.numpy() < 1e30).sum() > 20
    else:   # a live ray starts in or on a box, so most have a candidate
        assert (tids.numpy()[0, alive] >= 0).mean() > 0.8 and (bound.numpy() < 1e30).sum() > 100
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


def _swapped_boxes(accel, rng):
    """``accel`` with the lo and hi planes of about a third of its (row,
    axis, lane) box entries swapped, NaN pads included."""
    tb = accel.tboxes.clone()
    swap = torch.from_numpy(rng.random((tb.shape[0], 24)) < 0.33).to(tb.device)
    lo, hi = tb[:, 0:24].clone(), tb[:, 24:48].clone()
    tb[:, 0:24] = torch.where(swap, hi, lo)
    tb[:, 24:48] = torch.where(swap, lo, hi)
    return dataclasses.replace(accel, tboxes=tb.contiguous())


def test_phase_a_is_the_same_for_swapped_box_planes(rng):
    # Phase A takes each axis's min and max plane distance, so a box with
    # lo and hi swapped gives the same candidates and bound; the kernel
    # keeps this for any tboxes by reading tboxes_ordered
    _, accel = _accels()
    o, d = _rays(512, "hemisphere", rng)
    alive = torch.from_numpy(rng.random(512) >= 0.1)
    swapped = _swapped_boxes(accel, rng)
    assert not torch.equal(swapped.tboxes.nan_to_num(), accel.tboxes.nan_to_num())
    want = treelet_candidates(accel, *_planes(o, d), alive, 3)
    got = treelet_candidates(swapped, *_planes(o, d), alive, 3)
    assert (want[0] >= 0).sum() > 300
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # the kernel reads only tboxes_ordered, which the swap leaves as it was
    a, b = accel.tboxes_ordered, swapped.tboxes_ordered
    assert torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num())


def test_tboxes_ordered_is_min_max_of_tboxes_and_refit_rebuilds_it(rng):
    # Phase A's derived table: each axis's lo and hi plane as their
    # NaN-propagating min and max, floats 48-127 as they were; built once
    # per accel object, so a refit (a new object) gets its own. The
    # builder's and the refit's boxes are already NaN on every axis or
    # ordered on every axis, so for them the table equals tboxes
    scene = _port_scene(tris=1200)
    accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=16, leaves_per_treelet=2)).to("cpu")
    v_new = scene.mesh.vertices + torch.from_numpy(
        rng.normal(0.0, 0.05, tuple(scene.mesh.vertices.shape)).astype(np.float32))
    moved = refit_shaded(accel, scene.with_params(
        dataclasses.replace(scene.params(), vertices=v_new)))
    for acc in (accel, moved, _swapped_boxes(accel, rng)):
        tb, got = acc.tboxes.numpy(), acc.tboxes_ordered.numpy()
        assert acc.tboxes_ordered is acc.tboxes_ordered and got.shape == tb.shape
        assert acc.tboxes_ordered.is_contiguous()
        nan = np.isnan(tb[:, 0:24]) | np.isnan(tb[:, 24:48])
        with np.errstate(invalid="ignore"):
            lo = np.where(nan, np.nan, np.minimum(tb[:, 0:24], tb[:, 24:48]))
            hi = np.where(nan, np.nan, np.maximum(tb[:, 0:24], tb[:, 24:48]))
        np.testing.assert_array_equal(got[:, 0:24], lo)
        np.testing.assert_array_equal(got[:, 24:48], hi)
        np.testing.assert_array_equal(got[:, 48:], tb[:, 48:])
        assert nan.any() and not np.isnan(got[:, 0:48][~np.concatenate([nan, nan], 1)]).any()
    assert not np.array_equal(np.nan_to_num(moved.tboxes_ordered.numpy()),
                              np.nan_to_num(accel.tboxes_ordered.numpy()))
    for acc in (accel, moved):
        np.testing.assert_array_equal(acc.tboxes_ordered.numpy(), acc.tboxes.numpy())
        nan = np.isnan(acc.tboxes.numpy()[:, 0:48]).reshape(-1, 6, 8)
        assert np.all(nan.all(axis=1) == nan.any(axis=1))


def test_phase_b_visit_counts(rng):
    # the counts chip_smoke.py's Phase B bound reads: every record of a
    # live pair's treelet, those facing the ray (det > 1e-12) and those of
    # them with u in [0, 1], counted here in numpy from the leaf planes
    _, accel = _accels()
    n, k = 256, 3
    o, d = _rays(n, "hemisphere", rng)
    tids, _ = treelet_candidates_ref(accel, *_planes(o, d), torch.ones(n, dtype=torch.bool), k)
    rid, ptid = _binned_pairs(tids.numpy(), n, k, accel.num_treelets, pair_cap(n, k, 1.0))
    visits = {}
    got = treelet_pair_walk_ref(accel, *_planes(o[rid], d[rid]), torch.from_numpy(ptid),
                                visits=visits)
    live = ptid >= 0
    lpt = accel.leaves_per_treelet
    slots = ptid[live, None].astype(np.int64) * lpt + np.arange(lpt)       # (m, lpt)
    pl = accel.cleaves.numpy()[slots]                                      # (m, lpt, 9, 16)
    ro, rd = o[rid][live][:, None, :, None], d[rid][live][:, None, :, None]
    p0, e1, e2 = pl[:, :, 0:3], pl[:, :, 3:6], pl[:, :, 6:9]
    pv = np.stack([rd[:, :, 1] * e2[:, :, 2] - rd[:, :, 2] * e2[:, :, 1],
                   rd[:, :, 2] * e2[:, :, 0] - rd[:, :, 0] * e2[:, :, 2],
                   rd[:, :, 0] * e2[:, :, 1] - rd[:, :, 1] * e2[:, :, 0]], 2)
    det = e1[:, :, 0] * pv[:, :, 0] + e1[:, :, 1] * pv[:, :, 1] + e1[:, :, 2] * pv[:, :, 2]
    front = det > np.float32(1e-12)
    tv = ro - p0
    with np.errstate(divide="ignore", invalid="ignore"):
        uu = (tv[:, :, 0] * pv[:, :, 0] + tv[:, :, 1] * pv[:, :, 1]
              + tv[:, :, 2] * pv[:, :, 2]) * (np.float32(1) / det)
    assert visits["records"] == live.sum() * lpt * accel.leaf_size
    assert visits["front"] == front.sum() > 0
    assert visits["u_in"] == (front & (uu >= 0) & (uu <= 1)).sum()
    assert visits["u_in"] >= int((got["id"] >= 0).sum()) > 20


def test_phase_b_leaf_planes_hold_each_treelets_records(rng):
    # the Phase B kernel reads a treelet's p0, e1, e2 from accel.cleaves:
    # slot tid * leaves_per_treelet + leaf, record k in lane k; the plain
    # version reads the same floats from the stride-32 records. A refit
    # makes a new accel whose planes come from its moved records.
    mesh = jax_procedural.uv_sphere(rows=12, cols=12)
    mats = jax_make_materials([((0.1, 0.1, 0.1), (0.0, 0.0, 0.0), 0.0),
                               ((0.0, 0.0, 0.0), (0.5, 0.5, 0.5), 0.0)])
    scene = scene_from_numpy(_tree(jax_build_scene([mesh], materials=mats))).to("cpu")
    for leaf, lpt in ((8, 2), (16, 3), (4, 1)):
        accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=leaf,
                                                       leaves_per_treelet=lpt)).to("cpu")
        recs = accel.tris.reshape(-1, 32)
        rpl = accel.rows_per_leaf
        planes = accel.cleaves
        for tid in range(accel.num_treelets):
            for lf in range(lpt):
                first = (tid * lpt + lf) * rpl * 4            # the plain version's record
                want = recs[first:first + leaf, 0:9].T
                assert torch.equal(planes[tid * lpt + lf][:, :leaf], want)
        v_new = scene.mesh.vertices + torch.from_numpy(
            rng.normal(0.0, 0.02, tuple(scene.mesh.vertices.shape)).astype(np.float32))
        moved = refit_shaded(accel, scene.with_params(
            dataclasses.replace(scene.params(), vertices=v_new)))
        assert torch.equal(moved.cleaves, leaf_planes(moved.tris, leaf, 32))
        assert not torch.equal(moved.cleaves, planes)


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
    n = 20000
    o, d = _rays(n, "hemisphere", rng)
    planes = [p.to(dev) for p in _planes(o, d)]
    alive = torch.from_numpy(rng.random(n) >= 0.1).to(dev)
    swapped = _swapped_boxes(accel, rng)               # lo and hi planes swapped
    for acc, k in ((accel, 1), (accel, PAIR_K), (accel, 8), (swapped, PAIR_K)):
        got = treelet_candidates(acc, *planes, alive, k)
        want = treelet_candidates_ref(acc, *planes, alive, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), k
    tids = treelet_candidates(accel, *planes, alive)[0]
    keys = torch.where(tids >= 0, tids, accel.num_treelets + 1).reshape(-1)
    perm = torch.argsort(keys, stable=True)[:pair_cap(n)]
    sorted_tid = torch.where(keys[perm] <= accel.num_treelets, keys[perm], -1).to(torch.int32)
    shuffle = torch.from_numpy(rng.permutation(perm.shape[0])).to(dev)
    for label, idx, ptid in (("first candidates", None, tids[0].contiguous()),
                             ("sorted pairs", perm, sorted_tid),
                             ("shuffled pairs", perm[shuffle], sorted_tid[shuffle].contiguous())):
        pp = planes if idx is None else [p[idx % n].contiguous() for p in planes]
        got = treelet_pair_walk(accel, *pp, ptid)
        want = treelet_pair_walk_ref(accel, *pp, ptid)
        for key in OUT:
            assert torch.equal(got[key], want[key]), (label, key)
    pair, _ = treelet_pair_hit(accel, *planes, alive)
    walk = wide_shade_planes(accel, *planes, alive)
    torch.cuda.synchronize()
    for key in OUT:
        assert torch.equal(pair[key], walk[key]), key
