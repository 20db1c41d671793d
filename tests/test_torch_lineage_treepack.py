"""PyTorch port, the lineage walks over a ``TreePack``: ``packet_walk``
(``traverse_pallas.py::_traverse_kernel``) and ``frustum_walk``
(``frustum_pallas.py::_frustum_kernel``). Their plain versions against the
JAX kernels in interpret mode and against the port's per-ray walks, the
pad-slot and axis-aligned-bundle cases, the counters, and on a card the
kernels against their plain versions."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from atray_tpu.accel.bvh import build_bvh as jax_build_bvh  # noqa: E402
from atray_tpu.config import KDTreeConfig as JaxKDTreeConfig  # noqa: E402
from atray_tpu.kernels.frustum_pallas import frustum_first_hit as jax_frustum  # noqa: E402
from atray_tpu.kernels.traverse_pallas import pack_bvh as jax_pack_bvh  # noqa: E402
from atray_tpu.kernels.traverse_pallas import pallas_first_hit as jax_packet  # noqa: E402
from test_torch_render import jax_builder  # noqa: E402

from atray_tpu_torch.accel.bvh import build_bvh  # noqa: E402
from atray_tpu_torch.accel.pack import TreePack, pack_bvh  # noqa: E402
from atray_tpu_torch.accel.traverse import bvh_first_hit  # noqa: E402
from atray_tpu_torch.config import KDTreeConfig  # noqa: E402
from atray_tpu_torch.core.camera import camera_rays, look_at_camera  # noqa: E402
from atray_tpu_torch.kernels import _build, _plain  # noqa: E402
from atray_tpu_torch.kernels import frustum_walk, packet_walk  # noqa: E402
from atray_tpu_torch.kernels.frustum_walk import frustum_first_hit, frustum_ref  # noqa: E402
from atray_tpu_torch.kernels.packet_walk import packet_first_hit, packet_ref  # noqa: E402
from atray_tpu_torch.kernels.persistent_packet import ppacket_ref  # noqa: E402
from atray_tpu_torch.scene import procedural  # noqa: E402
from atray_tpu_torch.scene.transforms import translate  # noqa: E402

WALKS = {"packet": (packet_first_hit, packet_ref, jax_packet, "packet_walk"),
         "frustum": (frustum_first_hit, frustum_ref, jax_frustum, "frustum_walk")}
# the entry points with the walk's own visit counts (diagnostics)
COUNTED = {"packet": packet_walk._first_hit, "frustum": frustum_walk._first_hit}
N_RAYS = 1000     # not a multiple of the 32-ray bundle


def _mesh():
    return translate(procedural.uv_sphere(rows=12, cols=12), (0.0, 0.0, -4.0))


def lineage_rays(n=N_RAYS, seed=7):
    """Coherent camera rays (a 20x20 film in film order) followed by random
    rays around the sphere, most of them aimed at it."""
    rng = np.random.default_rng(seed)
    cam = look_at_camera((0.0, 0.4, 0.6), (0.0, 0.0, -4.0), h_fov=0.45, aspect=1.0)
    co, cd = (x.numpy() for x in camera_rays(cam, 20, 20, 1, device="cpu"))
    m = max(n - co.shape[0], 0)
    ro = rng.normal(size=(m, 3)) * 1.6 + [0.0, 0.0, -4.0]
    rd = rng.normal(size=(m, 3)) * 0.4 + ([0.0, 0.0, -4.0] - ro)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    o = np.concatenate([co, ro]).astype(np.float32)[:n]
    d = np.concatenate([cd, rd]).astype(np.float32)[:n]
    return o, d


def _assert_like_reference(got, ref, tie_ok=0):
    """Ids equal but at ``tie_ok`` ties, t within rtol 1e-5, u and v within
    1e-5 on hits, misses exactly (3e38, 0, 0, -1)."""
    t, u, v, i = got
    rt, ru, rv, ri = ref
    assert i.dtype == np.int32
    assert int((i != ri).sum()) <= tie_ok
    np.testing.assert_allclose(t, rt, rtol=1e-5)
    hit = ri >= 0
    same = hit & (i == ri)
    np.testing.assert_allclose(u[same], ru[same], atol=1e-5)
    np.testing.assert_allclose(v[same], rv[same], atol=1e-5)
    miss = i < 0
    assert np.all(t[miss] == np.float32(3.0e38)) and np.all(u[miss] == 0) and np.all(v[miss] == 0)
    return int(hit.sum())


def _tables(leaf_size):
    mesh = _mesh()
    bvh = build_bvh(mesh.vertices, mesh.faces, KDTreeConfig(leaf_size=leaf_size),
                    backend=jax_builder())
    jpack = jax_pack_bvh(jax_build_bvh(mesh.vertices, mesh.faces,
                                       JaxKDTreeConfig(leaf_size=leaf_size)))
    return bvh, pack_bvh(bvh).to("cpu"), jpack


@pytest.mark.parametrize("walk,leaf_size", [("packet", 8), ("frustum", 8), ("frustum", 16)])
def test_plain_matches_jax_kernel(walk, leaf_size):
    entry, _, jax_fn, _ = WALKS[walk]
    _, pack, jpack = _tables(leaf_size)
    o, d = lineage_rays()
    ref = [np.asarray(x) for x in jax_fn(jpack, jnp.asarray(o), jnp.asarray(d), interpret=True)]
    got = [x.numpy() for x in entry(pack, torch.from_numpy(o), torch.from_numpy(d))]
    assert _assert_like_reference(got, ref) > 300


@pytest.mark.parametrize("walk", ["packet", "frustum"])
def test_plain_matches_per_ray_walks(walk):
    # the per-ray walks find the same nearest hits; ppacket_ref shares the
    # kernels' Moller-Trumbore op order (t, u, v bit-equal), bvh_first_hit
    # is the reference's jnp formulation (t within 1e-5)
    _, ref_fn, _, _ = WALKS[walk]
    bvh, pack, _ = _tables(8)
    o, d = (torch.from_numpy(x) for x in lineage_rays(1531, seed=3))
    got = [x.numpy() for x in ref_fn(pack, o, d)]
    per_ray = [x.numpy() for x in ppacket_ref(pack, o, d)]
    walk_ref = [x.numpy() for x in bvh_first_hit(bvh, None, o, d)]
    np.testing.assert_array_equal(got[3], per_ray[3])
    for a, b in zip(got[:3], per_ray[:3]):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert _assert_like_reference(got, walk_ref) > 300


def test_pad_slots_never_hit(rng):
    # leaf_size larger than the triangle count fills the leaf with pads
    v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    f = np.asarray([[0, 1, 2]], np.int32)
    bvh = build_bvh(v, f, KDTreeConfig(leaf_size=8))
    pack = pack_bvh(bvh).to("cpu")
    o = rng.uniform(-3, 3, (1024, 3)).astype(np.float32)
    d = rng.normal(size=(1024, 3)) * 0.3 + ([0.3, 0.3, 0.0] - o)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    want = bvh_first_hit(bvh, None, o, d)[3].numpy()
    assert (want == 0).sum() > 20
    for entry, _, _, _ in WALKS.values():
        ids = entry(pack, o, d)[3].numpy()
        assert set(np.unique(ids)) <= {-1, 0}
        np.testing.assert_array_equal(ids, want)


def _axis_aligned_rays():
    """Two bundles along -z: the first with direction x exactly 0.0 and y
    both 0.0 and -0.0 (zero and -0.0 direction bounds), the second ragged."""
    xs, ys = np.meshgrid(np.linspace(-0.9, 0.9, 8), np.linspace(-0.9, 0.9, 6))
    n = 45
    o = np.stack([xs.ravel()[:n], ys.ravel()[:n], np.full(n, 1.0)], 1).astype(np.float32)
    d = np.zeros((n, 3), np.float32)
    d[:, 2] = -1.0
    d[1::2, 1] = -0.0
    return o, d


def test_axis_aligned_bundle_takes_the_zero_bound_selectors():
    o, d = _axis_aligned_rays()
    setup = _plain.axis_setup(torch.tensor([0.0, -0.0]), torch.tensor([-0.0, 0.0]))
    assert not any(bool(s.any()) for s in (setup[0], setup[1], setup[3], setup[4]))
    assert float(setup[2].abs().sum() + setup[5].abs().sum()) == 0.0
    bvh, pack, jpack = _tables(8)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    want = [x.numpy() for x in bvh_first_hit(bvh, None, to, td)]
    ref = [np.asarray(x) for x in jax_frustum(jpack, jnp.asarray(o), jnp.asarray(d),
                                              interpret=True)]
    assert (want[3] >= 0).sum() > 20
    for entry, _, _, _ in WALKS.values():
        got = [x.numpy() for x in entry(pack, to, td)]
        _assert_like_reference(got, want)
        _assert_like_reference(got, ref)


def test_nan_interval_bound_is_no_constraint():
    # c * (1/d) with c == 0 and 1/d overflowed (a denormal direction bound)
    # is NaN; the reference's jnp.maximum would carry it and cull the box.
    # Here it is no constraint, so the interval still admits the box.
    tiny = torch.tensor([1.0e-40])
    setup = _plain.axis_setup(-tiny, -tiny)
    assert torch.isinf(setup[2]).all()
    lo, hi = _plain.axis_t_bounds(setup, torch.tensor([1.0]), torch.tensor([1.0]),
                                  torch.tensor([0.0]), torch.tensor([1.0]))
    assert not torch.isnan(lo).any() and not torch.isnan(hi).any()
    assert float(lo) <= 0.0 <= float(hi)
    # a bundle whose direction x is a denormal (its reciprocal overflows)
    # still finds the per-ray walk's hits
    o, d = _axis_aligned_rays()
    d[:, 0] = -1.0e-40
    bvh, pack, _ = _tables(8)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    want = bvh_first_hit(bvh, None, to, td)[3].numpy()
    assert (want >= 0).sum() > 20
    for entry, _, _, _ in WALKS.values():
        np.testing.assert_array_equal(entry(pack, to, td)[3].numpy(), want)


@pytest.mark.parametrize("walk", ["packet", "frustum"])
def test_counters_and_visits(walk, monkeypatch):
    _, ref_fn, _, name = WALKS[walk]
    entry = COUNTED[walk]

    def no_build():
        raise AssertionError("the CPU path must not build the CUDA kernels")

    monkeypatch.setattr(_build, "load", no_build)
    _, pack, _ = _tables(8)
    o, d = (torch.from_numpy(x[150:250].copy()) for x in lineage_rays())
    c = _build.COUNTERS[name]
    before = (c.launches, c.plain_calls)
    visits = {}
    entry(pack, o, d, visits=visits)
    assert (c.launches, c.plain_calls) == (before[0], before[1] + 1)
    again = {}
    ref_fn(pack, o, d, visits=again)
    assert visits == again and visits["nodes"] > 0 and visits["records"] > 0
    # records come in whole leaves per live ray; a 4-ray call counts 4 lanes
    assert visits["records"] % pack.leaf_size == 0
    small = {}
    ref_fn(pack, o[:4].contiguous(), d[:4].contiguous(), visits=small)
    assert small["nodes"] % 4 == 0 and small["records"] % (4 * pack.leaf_size) == 0


def _frustum_at(monkeypatch, window, pack, o, d):
    """``frustum_ref``'s hits (numpy) and visits with a window of
    ``window`` skip-link positions a step."""
    monkeypatch.setattr(frustum_walk, "_WINDOW", window)
    visits = {}
    got = frustum_ref(pack, torch.from_numpy(o), torch.from_numpy(d), visits=visits)
    return [x.numpy() for x in got], visits


def _assert_same_walk(got, want):
    (hits, visits), (want_hits, want_visits) = got, want
    for a, b in zip(hits, want_hits):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert visits == want_visits


@pytest.mark.parametrize("window", [1, 32, 128])
@pytest.mark.parametrize("leaf_size", [8, 16])
def test_frustum_window_width_keeps_hits_and_visits(window, leaf_size, monkeypatch):
    # width 1 is the one-node-a-step walk, 32 the kernel's window; every
    # width tests the same leaves with the same tmax, so hits (bit for bit)
    # and visits, "warp_nodes" included, are width 1's, and the hits are the
    # per-ray walk's
    _, pack, _ = _tables(leaf_size)
    o, d = lineage_rays()
    got = _frustum_at(monkeypatch, window, pack, o, d)
    _assert_same_walk(got, _frustum_at(monkeypatch, 1, pack, o, d))
    per_ray = [x.numpy() for x in ppacket_ref(pack, torch.from_numpy(o), torch.from_numpy(d))]
    _assert_same_walk((got[0], {}), (per_ray, {}))
    assert got[1]["warp_nodes"] * 32 >= got[1]["nodes"] > 0


def test_frustum_rollback_after_a_lowering_flush(monkeypatch):
    # a coherent bundle in front of the mesh: a flush inside a window of 32
    # lowers tmax, the window is cut just after the leaf that filled the
    # queue, and the walk resumes there with the new bound
    _, pack, _ = _tables(8)
    xs, ys = np.meshgrid(np.linspace(-0.3, 0.3, 8), np.linspace(-0.3, 0.3, 4))
    o = np.stack([xs.ravel(), ys.ravel(), np.full(32, 1.0)], 1).astype(np.float32)
    d = np.tile(np.float32([0.0, 0.0, -1.0]), (32, 1))
    cuts = []

    def spy(*args):
        has, first, lim = cut(*args)
        cuts.extend(int(x) for x in lim[has])
        return has, first, lim

    cut = frustum_walk._cut
    monkeypatch.setattr(frustum_walk, "_cut", spy)
    got = _frustum_at(monkeypatch, 32, pack, o, d)
    assert any(x < 31 for x in cuts)          # a cut before the window's last position
    assert (got[0][3] >= 0).all()
    _assert_same_walk(got, _frustum_at(monkeypatch, 1, pack, o, d))


def _three_node_pack():
    """A root over two one-triangle leaves (leaf_size 1): the left leaf a
    triangle in z = 0 over [0, 1]^2, the right one in z = -1 over [2, 3] x
    [0, 1]; DFS preorder 0 (root), 1 (left), 2 (right)."""
    nodebox = np.float32([[0, 0, 2], [0, 0, 0], [-1, 0, -1], [3, 1, 3], [1, 1, 1], [0, 0, -1]])
    ctrl = np.int32([[-1, 2, -1], [-1, 0, 1]])
    tris = np.zeros((2, 128), np.float32)
    tris[:, 0::16] = tris[:, 1::16] = tris[:, 2::16] = 1.0e30
    for row, (x0, z) in enumerate(((0.0, 0.0), (2.0, -1.0))):
        tris[row, 0:9] = [x0, 0, z, 1, 0, 0, 0, 1, 0]     # p0, e1, e2 (facing +z)
        tris[row, 9] = np.int32(10 + row).view(np.float32)
    return TreePack(nodebox=torch.from_numpy(nodebox), ctrl=torch.from_numpy(ctrl),
                    tris=torch.from_numpy(tris), leaf_size=1, num_nodes=3)


@pytest.mark.parametrize("window", [1, 32])
def test_frustum_warp_nodes_on_a_three_node_pack(window, monkeypatch):
    # bundle 0 (32 rays down onto both leaves) visits all three nodes and
    # tests both leaves; bundle 1 (8 live rays, aimed up) culls the root, so
    # it visits one node. "warp_nodes" is the bundles' node steps summed,
    # "nodes" each bundle's steps times its live rays.
    pack = _three_node_pack()
    xs = np.where(np.arange(32) % 2 == 0, 0.25, 2.25) + np.arange(32) * 0.01
    o0 = np.stack([xs, np.full(32, 0.2), np.full(32, 2.0)], 1)
    d0 = np.tile([0.0, 0.0, -1.0], (32, 1))
    o1 = np.tile([0.5, 0.5, 2.0], (8, 1))
    d1 = np.tile([0.0, 0.0, 1.0], (8, 1))
    o = np.concatenate([o0, o1]).astype(np.float32)
    d = np.concatenate([d0, d1]).astype(np.float32)
    (t, _, _, fid), visits = _frustum_at(monkeypatch, window, pack, o, d)
    assert visits == {"nodes": 3 * 32 + 1 * 8, "records": 2 * 1 * 32, "warp_nodes": 3 + 1}
    np.testing.assert_array_equal(fid, np.r_[np.where(np.arange(32) % 2 == 0, 10, 11),
                                             np.full(8, -1)])
    np.testing.assert_array_equal(t[:32], np.where(np.arange(32) % 2 == 0, 2.0, 3.0))


def test_wrappers_check_inputs():
    mesh = procedural.cube()
    host = pack_bvh(build_bvh(mesh.vertices, mesh.faces, KDTreeConfig(leaf_size=8)))
    pack = host.to("cpu")
    o = torch.tensor([[0.0, 0.0, 3.0]]).repeat(4, 1)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)
    for entry, _, _, _ in WALKS.values():
        t, _, _, fid = entry(pack, o, d)
        assert fid.dtype == torch.int32 and torch.all(fid >= 0)
        np.testing.assert_allclose(t.numpy(), 2.0)
        with pytest.raises(TypeError):
            entry(host, o, d)                                   # not uploaded
        with pytest.raises(TypeError):
            entry(pack, o.double(), d)
        with pytest.raises(ValueError):
            entry(pack, torch.zeros((3, 4)).t(), d)
        with pytest.raises(ValueError, match="num_nodes"):
            entry(dataclasses.replace(pack, num_nodes=pack.num_nodes + 1), o, d)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    mesh = procedural.dragon_proxy(target_tris=20000)
    rng = np.random.default_rng(5)
    for leaf_size in (8, 16):
        pack = pack_bvh(build_bvh(mesh.vertices, mesh.faces,
                                  KDTreeConfig(leaf_size=leaf_size))).to(dev)
        o = rng.uniform(-3, 3, (4099, 3)).astype(np.float32)
        d = rng.normal(size=(4099, 3))
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
        for walk, (_, ref_fn, _, _) in WALKS.items():
            kv, pv = {}, {}
            got = COUNTED[walk](pack, o, d, visits=kv)
            want = ref_fn(pack, o, d, visits=pv)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            assert kv == pv
