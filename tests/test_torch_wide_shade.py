"""PyTorch port: the fused hit (``kernels/wide_shade.py``). Its plain
version is held to the JAX Pallas kernel (interpret mode) on identical
tables, its per-ray traversal counts to the kernel's per-pair counts of
pairs with one live ray; the CUDA kernel is held to the plain version on the card, its
per-ray traversal counts (``stats=True``) included. The derived node
records and leaf planes the kernel reads (``accel/wide.py::node_records``,
``leaf_planes``) round-trip to the tables they come from, also after a
refit."""

import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from atray_tpu.accel.shaded import build_shaded_accel as jax_build_shaded_accel  # noqa: E402
from atray_tpu.config import KDTreeConfig as JaxKDTreeConfig  # noqa: E402
from atray_tpu.core.camera import camera_rays as jax_camera_rays  # noqa: E402
from atray_tpu.core.camera import look_at_camera as jax_look_at_camera  # noqa: E402
from atray_tpu.kernels.wide_shade import wide_shade_planes as jax_wide_shade_planes  # noqa: E402
from atray_tpu.scene import build_scene as jax_build_scene  # noqa: E402
from atray_tpu.scene import procedural as jax_procedural  # noqa: E402
from atray_tpu.scene.data import make_materials as jax_make_materials  # noqa: E402
from atray_tpu.scene.transforms import translate as jax_translate  # noqa: E402

from atray_tpu_torch.accel.shaded import (  # noqa: E402
    NODE_WORDS,
    STRIDE32,
    build_shaded_accel,
    leaf_planes,
    node_records,
    refit_shaded,
)
from atray_tpu_torch.config import KDTreeConfig  # noqa: E402
from atray_tpu_torch.core.intersect import INF  # noqa: E402
from atray_tpu_torch.interop import shaded_accel_from_numpy  # noqa: E402
from atray_tpu_torch.kernels import _build  # noqa: E402
from atray_tpu_torch.kernels.wide_shade import (  # noqa: E402
    STATS,
    wide_shade_planes,
    wide_shade_planes_ref,
)
from atray_tpu_torch.scene import build_scene, procedural  # noqa: E402

OUT = ("t", "id", "nx", "ny", "nz", "mat")


def _jax_sphere_accel():
    mats = jax_make_materials([((0.3, 0.4, 0.6), (0, 0, 0), 0.0),
                               ((0, 0, 0), (0.7, 0.5, 0.3), 0.1)])
    mesh = jax_translate(jax_procedural.uv_sphere(16, 16, material=1, smooth=True),
                         (0, 0, -4))
    return jax_build_shaded_accel(jax_build_scene([mesh], materials=mats),
                                  JaxKDTreeConfig(leaf_size=8))


def _rays(rng):
    """256 camera primaries plus 256 rays from a shell around the sphere
    aimed at points inside it; about 10% dead."""
    cam = jax_look_at_camera((0, 0.4, 0.6), (0, 0, -4), h_fov=0.9, aspect=1.0)
    o, d = (np.asarray(a) for a in jax_camera_rays(cam, 16, 16, 1))
    m = 256
    src = rng.normal(size=(m, 3))
    src = 2.5 * src / np.linalg.norm(src, axis=1, keepdims=True)
    dst = rng.uniform(-0.9, 0.9, (m, 3))
    d2 = dst - src
    d2 /= np.linalg.norm(d2, axis=1, keepdims=True)
    o = np.concatenate([o, src + [0.0, 0.0, -4.0]]).astype(np.float32)
    d = np.concatenate([d, d2]).astype(np.float32)
    d[5] = (0.0, 0.0, -1.0)                       # zero direction components
    alive = rng.uniform(size=o.shape[0]) >= 0.1
    return o, d, alive


def _planes(o, d):
    return [torch.from_numpy(np.ascontiguousarray(a[:, k])) for a in (o, d) for k in range(3)]


def _port_sphere_accel():
    ja = _jax_sphere_accel()
    return ja, shaded_accel_from_numpy(
        {f.name: getattr(ja, f.name) for f in dataclasses.fields(ja)}).to("cpu")


def test_plain_walk_matches_jax_kernel():
    ja, accel = _port_sphere_accel()
    o, d, alive = _rays(np.random.default_rng(4))
    jplanes = [jnp.asarray(a[:, k]) for a in (o, d) for k in range(3)]

    def jax_walk(live):
        out = jax_wide_shade_planes(ja, *jplanes, jnp.asarray(live, jnp.float32),
                                    interpret=True, stats=True)
        return {k: np.asarray(v) for k, v in out.items()}

    ref = jax_walk(alive)
    got = {k: v.numpy() for k, v in
           wide_shade_planes(accel, *_planes(o, d), torch.from_numpy(alive),
                             stats=True).items()}
    assert got["id"].dtype == np.int32 and got["mat"].dtype == np.int32

    hit = ref["id"] >= 0
    assert hit.sum() > 200
    np.testing.assert_array_equal(got["id"] >= 0, hit)
    # equal-t ties may pick another coincident face: compare those by t and normal
    tie = got["id"] != ref["id"]
    assert tie.sum() <= 2, f"{tie.sum()} id differences"
    np.testing.assert_allclose(got["t"], ref["t"], rtol=1e-6)
    for k in ("nx", "ny", "nz"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5)
    np.testing.assert_array_equal(got["mat"], ref["mat"])
    dead = ~alive
    assert np.all(got["t"][dead] == np.float32(INF)) and np.all(got["id"][dead] == -1)
    for k in ("nx", "ny", "nz", "mat"):
        assert np.all(got[k][dead] == 0)

    # Traversal counts. The reference walks each pair of 8x128-ray lockstep
    # blocks as one walk (the union of its rays' walks) and copies the
    # pair's counts to every ray of it; these 512 rays are one pair. A walk
    # pops a node at most once, so the pair's count is at most the node
    # count. A pair whose one live ray is ray r walks exactly r's walk, so
    # its counts are the port's per-ray counts of r: held for every live
    # ray, one compiled kernel reused (about 1 ms a walk).
    for k in STATS:
        assert np.unique(ref[k]).size == 1, k
    assert 1 <= ref["node_visits"][0] <= accel.num_nodes
    assert np.all(got["node_visits"][dead] == 0) and np.all(got["leaf_visits"][dead] == 0)
    for r in np.flatnonzero(alive):
        solo = jax_walk(np.arange(alive.shape[0]) == r)
        assert [int(solo[k][r]) for k in STATS] == [int(got[k][r]) for k in STATS], r


def test_stats_leave_the_hit_planes_unchanged():
    # the reference's stats contract (tests/test_pallas.py::
    # test_wide_shade_stats_mode): every hit output bit-identical with stats
    # on, through the plain version and through the wrapper on a CPU tensor
    _, accel = _port_sphere_accel()
    o, d, alive = _rays(np.random.default_rng(4))
    args = (accel, *_planes(o, d), torch.from_numpy(alive))
    base = wide_shade_planes_ref(*args)
    assert set(base) == set(OUT)
    for st in (wide_shade_planes_ref(*args, stats=True), wide_shade_planes(*args, stats=True)):
        assert set(st) == set(OUT) | set(STATS)
        for k in OUT:
            assert torch.equal(st[k], base[k]), k


def test_stats_count_per_ray_and_sum_to_the_visit_totals():
    _, accel = _port_sphere_accel()
    o, d, alive = _rays(np.random.default_rng(4))
    visits = {}
    st = wide_shade_planes_ref(accel, *_planes(o, d), torch.from_numpy(alive), visits=visits,
                               stats=True)
    nv, lv = st["node_visits"], st["leaf_visits"]
    assert nv.dtype == torch.int32 and lv.dtype == torch.int32
    assert nv.shape == lv.shape == (o.shape[0],)
    dead = torch.from_numpy(~alive)
    assert not bool(nv[dead].any()) and not bool(lv[dead].any())
    assert bool((nv[~dead] >= 1).all())        # every live ray pops the root
    assert int(nv.sum()) == visits["nodes"]
    assert int(lv.sum()) * accel.leaf_size == visits["records"]
    # a ray that hits tested at least one leaf; the counts vary across rays
    assert bool((lv[st["id"] >= 0] >= 1).all())
    assert int(nv.max()) > int(nv[~dead].min())


def _round_trip_derived_tables(acc):
    rec = acc.cnodes
    w = acc.num_nodes
    assert rec.shape == (w, NODE_WORDS) and rec.dtype == torch.int32
    assert rec.is_contiguous() and rec.data_ptr() % 16 == 0
    assert torch.equal(rec[:, 0:48], acc.cboxes[:, 0:48].contiguous().view(torch.int32))
    assert torch.equal(rec[:, 48:56], acc.clinks.t())
    assert torch.equal(rec[:, 56], acc.caxis.reshape(-1))
    assert not bool(rec[:, 57:].any())
    assert acc.cnodes is rec                     # built once per accel object
    # leaf planes: float q of record k of the leaf at row r is plane q,
    # entry k of slot r / rows_per_leaf; as float4s, row * 9 + q * rpl + k / 4
    planes = acc.cleaves
    rpl = acc.rows_per_leaf
    recs = acc.tris.reshape(-1, 4 * rpl, 32)
    assert planes.shape == (recs.shape[0], 9, 4 * rpl) and planes.is_contiguous()
    assert torch.equal(planes.view(torch.int32),
                       recs[:, :, 0:9].transpose(1, 2).contiguous().view(torch.int32))
    flat = planes.reshape(-1, 4)
    row, k = rpl, 4 * rpl - 1                    # the second leaf, its last record
    for q in range(9):
        assert float(flat[row * 9 + q * rpl + k // 4, k % 4]) == float(
            acc.tris.reshape(-1, 32)[row * 4 + k, q])
    assert acc.cleaves is planes


@pytest.mark.parametrize("leaf_size", [16, 2])
def test_derived_tables_round_trip_and_follow_a_refit(rng, leaf_size):
    scene = build_scene([procedural.uv_sphere(12, 12)]).to("cpu")
    accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=leaf_size)).to("cpu")
    _round_trip_derived_tables(accel)
    host = build_shaded_accel(scene, KDTreeConfig(leaf_size=leaf_size))
    assert torch.equal(node_records(host.cboxes, host.clinks, host.caxis), accel.cnodes)
    assert torch.equal(leaf_planes(host.tris, leaf_size, STRIDE32), accel.cleaves)
    v_new = scene.mesh.vertices + torch.from_numpy(
        rng.normal(0.0, 0.02, tuple(scene.mesh.vertices.shape)).astype(np.float32))
    moved = refit_shaded(accel, scene.with_params(
        dataclasses.replace(scene.params(), vertices=v_new)))
    assert not torch.equal(moved.cboxes, accel.cboxes)
    _round_trip_derived_tables(moved)
    assert not torch.equal(moved.cnodes, accel.cnodes)
    assert not torch.equal(moved.cleaves, accel.cleaves)


def test_empty_slots_and_pad_records_never_hit(rng):
    # a 12-triangle cube at leaf_size 8: the root wide node has empty child
    # slots (INT32_MIN links, inverted boxes that every slab test accepts)
    # and its leaves hold pad records (p0 = 1e30, zero edges)
    scene = build_scene([procedural.cube()])
    host = build_shaded_accel(scene, KDTreeConfig(leaf_size=8))
    assert (host.clinks == np.int32(-2 ** 31)).any()
    assert (host.tris.reshape(-1, 32)[:, 0] >= 1.0e29).any()
    accel = host.to("cpu")
    n = 512
    o = rng.normal(size=(n, 3))
    o = 3.0 * o / np.linalg.norm(o, axis=1, keepdims=True)
    away = o / np.linalg.norm(o, axis=1, keepdims=True)            # leave the cube
    toward = -away                                                # hit the cube
    d = np.concatenate([away, toward]).astype(np.float32)
    o = np.concatenate([o, o]).astype(np.float32)
    out = wide_shade_planes(accel, *_planes(o, d), torch.ones(2 * n, dtype=torch.bool))
    ids, t = out["id"].numpy(), out["t"].numpy()
    assert np.all(ids[:n] == -1) and np.all(t[:n] == np.float32(INF))
    assert np.all((ids[n:] >= 0) & (ids[n:] < 12))
    np.testing.assert_allclose(t[n:], 2.0, atol=1.0)


def test_wrapper_checks_inputs_and_builds_nothing_on_cpu(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the CUDA kernels")

    monkeypatch.setattr(_build, "load", no_build)
    accel_host = build_shaded_accel(build_scene([procedural.cube()]), KDTreeConfig(leaf_size=8))
    accel = accel_host.to("cpu")
    o = np.zeros((4, 3), np.float32)
    d = np.tile(np.float32([[0.0, 0.0, 1.0]]), (4, 1))
    planes = _planes(o, d)
    alive = torch.ones(4, dtype=torch.bool)
    before = _build.COUNTERS["wide_shade"].plain_calls
    wide_shade_planes(accel, *planes, alive)
    assert _build.COUNTERS["wide_shade"].plain_calls == before + 1
    with pytest.raises(TypeError):
        wide_shade_planes(accel_host, *planes, alive)             # not uploaded
    with pytest.raises(TypeError):
        wide_shade_planes(accel, *planes[:5], planes[5].double(), alive)
    with pytest.raises(TypeError):
        wide_shade_planes(accel, *planes, alive.float())
    with pytest.raises(ValueError):
        strided = torch.zeros(8)[::2]
        wide_shade_planes(accel, strided, *planes[1:], alive)
    deep = dataclasses.replace(accel, max_depth=40)
    with pytest.raises(ValueError, match="STACK_CAP"):
        wide_shade_planes(deep, *planes, alive)


def test_cuda_module_imports_without_nvcc():
    code = (
        "import shutil, sys\n"
        "shutil.which = lambda *a, **k: None\n"
        "import atray_tpu_torch.kernels.wide_shade as w, atray_tpu_torch.kernels.lane_pack\n"
        "from atray_tpu_torch.kernels import _build\n"
        "assert _build._loaded.lib is None\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    scene = build_scene([procedural.dragon_proxy(target_tris=20000)])
    accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=16)).to(dev)
    rng = np.random.default_rng(5)
    o = rng.uniform(-2, 2, (20000, 3)).astype(np.float32)
    d = rng.normal(size=(20000, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    planes = [p.to(dev) for p in _planes(o, d)]
    alive = torch.from_numpy(rng.uniform(size=20000) >= 0.1).to(dev)
    got = wide_shade_planes(accel, *planes, alive)
    want = wide_shade_planes_ref(accel, *planes, alive, stats=True)
    got_st = wide_shade_planes(accel, *planes, alive, stats=True)
    torch.cuda.synchronize()
    assert torch.equal(got["id"], want["id"]) and torch.equal(got["mat"], want["mat"])
    assert torch.equal(got["t"], want["t"])
    for k in ("nx", "ny", "nz"):
        assert float((got[k] - want[k]).abs().max()) <= 1e-6
    # the kernel's per-ray counts equal the plain version's, and its hit
    # planes do not change with stats on
    for k in OUT:
        assert torch.equal(got_st[k], got[k]), k
    for k in STATS:
        assert got_st[k].dtype == torch.int32
        assert torch.equal(got_st[k], want[k]), k
