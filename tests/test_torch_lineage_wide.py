"""PyTorch port, the lineage walks over a ``WideBVH``: ``wide_frustum``
(``wide_pallas.py::_wide_kernel``) and ``persistent_wide``
(``persistent_pallas.py::_persistent_kernel``). Their plain versions
against the JAX kernels in interpret mode and against the port's per-ray
walks, pad records and empty wide slots, the axis-aligned bundle, the
queue drains, the counters and the warp's node pops, the wrappers' input
checks, and on a card the kernels against their plain versions."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from atray_tpu.accel.wide import wide_from_mesh as jax_wide_from_mesh  # noqa: E402
from atray_tpu.config import KDTreeConfig as JaxKDTreeConfig  # noqa: E402
from atray_tpu.kernels.persistent_pallas import persistent_first_hit as jax_persistent  # noqa: E402
from atray_tpu.kernels.wide_pallas import wide_first_hit as jax_wide  # noqa: E402
from test_torch_lineage_treepack import (  # noqa: E402
    _assert_like_reference, _axis_aligned_rays, _mesh, lineage_rays)
from test_torch_render import pin_port_builder  # noqa: E402

from atray_tpu_torch.accel.bvh import build_bvh  # noqa: E402
from atray_tpu_torch.accel.traverse import bvh_first_hit  # noqa: E402
from atray_tpu_torch.accel.wide import make_accel  # noqa: E402
from atray_tpu_torch.config import KDTreeConfig  # noqa: E402
from atray_tpu_torch.kernels import _build, persistent_wide, wide_frustum  # noqa: E402
from atray_tpu_torch.kernels.persistent_wide import persistent_first_hit, persistent_ref  # noqa: E402
from atray_tpu_torch.kernels.wide_exact import wide_exact_ref  # noqa: E402
from atray_tpu_torch.kernels._plain import bundles  # noqa: E402
from atray_tpu_torch.kernels.wide_frustum import (  # noqa: E402
    VISIT_KEYS, _child_overlap, launch_wide, wide_first_hit, wide_ref)
from atray_tpu_torch.scene import procedural  # noqa: E402

WALKS = {"wide": (wide_first_hit, wide_ref, jax_wide, "wide_frustum"),
         "persistent": (persistent_first_hit, persistent_ref, jax_persistent, "persistent_wide")}
# the entry points with the walk's own visit counts (diagnostics)
COUNTED = {"wide": wide_frustum._first_hit, "persistent": persistent_wide._first_hit}


def _tables(leaf_size):
    mesh = _mesh()
    cfg = KDTreeConfig(leaf_size=leaf_size)
    with pytest.MonkeyPatch.context() as mp:
        backend = pin_port_builder(mp)
        wide = make_accel(mesh.vertices, mesh.faces, cfg).to("cpu")
    return (build_bvh(mesh.vertices, mesh.faces, cfg, backend=backend), wide,
            jax_wide_from_mesh(mesh.vertices, mesh.faces, JaxKDTreeConfig(leaf_size=leaf_size)))


@pytest.mark.parametrize("walk,leaf_size", [("wide", 8), ("persistent", 8), ("wide", 16)])
def test_plain_matches_jax_kernel(walk, leaf_size):
    entry, _, jax_fn, _ = WALKS[walk]
    _, wide, jwide = _tables(leaf_size)
    o, d = lineage_rays()
    ref = [np.asarray(x) for x in jax_fn(jwide, jnp.asarray(o), jnp.asarray(d), interpret=True)]
    got = [x.numpy() for x in entry(wide, torch.from_numpy(o), torch.from_numpy(d))]
    assert _assert_like_reference(got, ref) > 300


@pytest.mark.parametrize("walk", ["wide", "persistent"])
def test_plain_matches_per_ray_walks(walk):
    # wide_exact_ref shares the kernels' Moller-Trumbore op order (t, u, v
    # bit-equal); bvh_first_hit is the reference's jnp formulation
    _, ref_fn, _, _ = WALKS[walk]
    bvh, wide, _ = _tables(8)
    o, d = (torch.from_numpy(x) for x in lineage_rays(1531, seed=3))
    got = [x.numpy() for x in ref_fn(wide, o, d)]
    per_ray = [x.numpy() for x in wide_exact_ref(wide, o, d)]
    np.testing.assert_array_equal(got[3], per_ray[3])
    for a, b in zip(got[:3], per_ray[:3]):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
    assert _assert_like_reference(got, [x.numpy() for x in bvh_first_hit(bvh, None, o, d)]) > 300


def test_pad_records_and_empty_slots_never_hit(rng):
    # one triangle: a single leaf of 7 pad records under a root whose other
    # 7 slots are empty (INT32_MIN links, inverted boxes)
    v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    f = np.asarray([[0, 1, 2]], np.int32)
    cfg = KDTreeConfig(leaf_size=8)
    bvh = build_bvh(v, f, cfg)
    wide = make_accel(v, f, cfg).to("cpu")
    assert int((wide.clinks == -2147483648).sum()) == 7
    o = rng.uniform(-3, 3, (1024, 3)).astype(np.float32)
    d = rng.normal(size=(1024, 3)) * 0.3 + ([0.3, 0.3, 0.0] - o)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o, d = torch.from_numpy(o), torch.from_numpy(d)
    want = bvh_first_hit(bvh, None, o, d)[3].numpy()
    assert (want == 0).sum() > 20
    for entry, _, _, _ in WALKS.values():
        ids = entry(wide, o, d)[3].numpy()
        assert set(np.unique(ids)) <= {-1, 0}
        np.testing.assert_array_equal(ids, want)


def test_axis_aligned_bundle():
    o, d = _axis_aligned_rays()
    bvh, wide, jwide = _tables(8)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    want = [x.numpy() for x in bvh_first_hit(bvh, None, to, td)]
    ref = [np.asarray(x) for x in jax_wide(jwide, jnp.asarray(o), jnp.asarray(d),
                                           interpret=True)]
    assert (want[3] >= 0).sum() > 20
    for entry, _, _, _ in WALKS.values():
        got = [x.numpy() for x in entry(wide, to, td)]
        _assert_like_reference(got, want)
        _assert_like_reference(got, ref)


def test_queue_drains_do_not_change_hits():
    # a queue of 16 drains after every node that brings it to 8 leaves; the
    # results are the same as with the kernel's 512, bit for bit
    _, wide, _ = _tables(8)
    o, d = (torch.from_numpy(x) for x in lineage_rays(1531, seed=3))
    big, tiny = {}, {}
    a = wide_ref(wide, o, d, visits=big)
    b = wide_ref(wide, o, d, qcap=16, visits=tiny)
    for x, y in zip(a, b):
        assert torch.equal(x.view(torch.int32) if x.is_floating_point() else x,
                           y.view(torch.int32) if y.is_floating_point() else y)
    assert big["drains"] == 0 and tiny["drains"] > tiny["drain_warps"] > 0
    assert {k: big[k] for k in ("nodes", "records")} == {k: tiny[k] for k in ("nodes", "records")}
    with pytest.raises(ValueError, match="qcap"):
        wide_ref(wide, o, d, qcap=8)


@pytest.mark.parametrize("walk", ["wide", "persistent"])
def test_counters_and_visits(walk, monkeypatch):
    _, ref_fn, _, name = WALKS[walk]
    entry = COUNTED[walk]

    def no_build():
        raise AssertionError("the CPU path must not build the CUDA kernels")

    monkeypatch.setattr(_build, "load", no_build)
    _, wide, _ = _tables(8)
    o, d = (torch.from_numpy(x[150:250].copy()) for x in lineage_rays())
    c = _build.COUNTERS[name]
    other = _build.COUNTERS["persistent_wide" if walk == "wide" else "wide_frustum"]
    before = (c.launches, c.plain_calls, other.plain_calls)
    visits = {}
    entry(wide, o, d, visits=visits)
    assert (c.launches, c.plain_calls, other.plain_calls) == (
        before[0], before[1] + 1, before[2])
    again = {}
    ref_fn(wide, o, d, visits=again)
    assert visits == again and visits["nodes"] > 0 and visits["records"] > 0
    assert visits["records"] % wide.leaf_size == 0
    # 100 rays: 3 full warps and one of 4 live lanes; every pop counts once
    # a warp in "warp_nodes" and once a live lane in "nodes"
    assert set(visits) == set(VISIT_KEYS)
    assert 0 < visits["warp_nodes"] * 4 <= visits["nodes"] <= visits["warp_nodes"] * 32


def test_warp_nodes_equal_a_stack_walk():
    # "warp_nodes" (and "nodes") of the plain version against a per-bundle
    # stack walk over the links: pop, push each overlapping interior child
    _, wide, _ = _tables(8)
    o, d = (torch.from_numpy(x) for x in lineage_rays(611, seed=4))
    visits = {}
    wide_ref(wide, o, d, visits=visits)
    bo, bd, live = bundles(o, d)
    ov = _child_overlap(wide, bo, bd, live).numpy()
    links = wide.clinks.numpy()
    pops = np.zeros(bo.shape[0], np.int64)
    for b in range(bo.shape[0]):
        stack = [0]
        while stack:
            node = stack.pop()
            pops[b] += 1
            stack += [int(links[c, node]) for c in range(8) if links[c, node] >= 0 and ov[b, node, c]]
    assert visits["warp_nodes"] == int(pops.sum()) > 2 * bo.shape[0]
    assert visits["nodes"] == int((pops * live.sum(1).numpy()).sum())


def test_wrappers_check_inputs():
    mesh = procedural.cube()
    host = make_accel(mesh.vertices, mesh.faces, KDTreeConfig(leaf_size=8))
    wide = host.to("cpu")
    o = torch.tensor([[0.0, 0.0, 3.0]]).repeat(4, 1)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)
    for entry, _, _, _ in WALKS.values():
        t, _, _, fid = entry(wide, o, d)
        assert fid.dtype == torch.int32 and torch.all(fid >= 0)
        np.testing.assert_allclose(t.numpy(), 2.0)
        with pytest.raises(TypeError):
            entry(host, o, d)                                   # not uploaded
        with pytest.raises(TypeError):
            entry(wide, o.double(), d)
        with pytest.raises(ValueError):
            entry(wide, torch.zeros((3, 4)).t(), d)
        with pytest.raises(ValueError, match="STACK_CAP"):
            entry(dataclasses.replace(wide, max_depth=40), o, d)


def test_launch_rejects_unaligned_tris(monkeypatch):
    # the kernels copy leaf records as 16-byte words: a tris view 4 bytes
    # off a 16-byte boundary is refused before the library is loaded (the
    # wrappers reach this launch only on a CUDA device)
    def no_build():
        raise AssertionError("the alignment check must come first")

    monkeypatch.setattr(_build, "load", no_build)
    _, wide, _ = _tables(8)
    flat = torch.zeros(wide.tris.numel() + 4)
    flat[1:1 + wide.tris.numel()] = wide.tris.reshape(-1)
    bad = dataclasses.replace(wide, tris=flat[1:1 + wide.tris.numel()].view(wide.tris.shape))
    assert bad.tris.is_contiguous() and bad.tris.data_ptr() % 16 == 4
    o, d = (torch.from_numpy(x[:40].copy()) for x in lineage_rays())
    for fn, name, extra in (("atray_wide_frustum", "wide_frustum", ()),
                            ("atray_persistent_wide", "persistent_wide", (0, 1))):
        c = _build.COUNTERS[name]
        before = c.launches
        with pytest.raises(ValueError, match="16-byte aligned"):
            launch_wide(fn, c, name, bad, o, d, None, extra=extra)
        assert c.launches == before
    # the plain versions take the same view and give the same hits
    for a, b in zip(wide_ref(bad, o, d), wide_ref(wide, o, d)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    mesh = procedural.dragon_proxy(target_tris=20000)
    rng = np.random.default_rng(5)
    # leaf 16: a mid-walk drain streams over 500 queued leaves of two rows
    # each through the warp's ring of leaf slots, many times round
    for leaf_size in (8, 16):
        wide = make_accel(mesh.vertices, mesh.faces, KDTreeConfig(leaf_size=leaf_size)).to(dev)
        o = rng.uniform(-3, 3, (4099, 3)).astype(np.float32)
        d = rng.normal(size=(4099, 3))
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
        for walk, (_, ref_fn, _, _) in WALKS.items():
            kv, pv = {}, {}
            got = COUNTED[walk](wide, o, d, visits=kv)
            want = ref_fn(wide, o, d, visits=pv)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a, b)
            assert kv == pv and kv["drain_warps"] > 0 and kv["warp_nodes"] > 0
    # twice as many bundles as the persistent grid has warps, so warps take
    # more bundles and reuse their shared stack and queue: equal, visits
    # included, to the one-bundle-a-warp kernel held to its plain version above
    n = 2 * persistent_wide.grid_warps(dev, wide.leaf_size) * 32 + 17
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    kv, fv = {}, {}
    got = COUNTED["persistent"](wide, o, d, visits=kv)
    want = COUNTED["wide"](wide, o, d, visits=fv)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert kv == fv and kv["warp_nodes"] > 0
    # a tris view off a 16-byte boundary is refused on the card
    flat = torch.zeros(wide.tris.numel() + 4, device=dev)
    bad = dataclasses.replace(wide, tris=flat[1:1 + wide.tris.numel()].view(wide.tris.shape))
    for entry, _, _, _ in WALKS.values():
        with pytest.raises(ValueError, match="16-byte aligned"):
            entry(bad, o, d)
