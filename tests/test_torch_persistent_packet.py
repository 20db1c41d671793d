"""PyTorch port, the skip-link walks: ``TreePack`` tables against the
reference's ``pack_bvh``, the ``ppacket`` plain version and
``bvh_first_hit`` against the JAX packet kernel (interpret mode) and the JAX
jnp walk, ``render(accel=TreePack)`` against the JAX render, and the
``HybridAccel``, ``TreePack`` and ``BVH`` films and gradients against the
``make_accel`` ones within the port."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from atray_tpu.accel.bvh import build_bvh as jax_build_bvh  # noqa: E402
from atray_tpu.accel.traverse import bvh_first_hit as jax_bvh_first_hit  # noqa: E402
from atray_tpu.config import KDTreeConfig as JaxKDTreeConfig  # noqa: E402
from atray_tpu.config import RenderSettings as JaxRenderSettings  # noqa: E402
from atray_tpu.core.camera import look_at_camera as jax_look_at_camera  # noqa: E402
from atray_tpu.kernels.persistent_packet import ppacket_first_hit as jax_ppacket  # noqa: E402
from atray_tpu.kernels.traverse_pallas import pack_bvh as jax_pack_bvh  # noqa: E402
from atray_tpu.render import wavefront as jw  # noqa: E402
from atray_tpu.scene import build_scene as jax_build_scene  # noqa: E402
from atray_tpu.scene import procedural as jax_procedural  # noqa: E402
from atray_tpu.scene.data import make_materials as jax_make_materials  # noqa: E402
from atray_tpu.scene.transforms import translate as jax_translate  # noqa: E402
from test_torch_render import _accel_fields, _tree, jax_builder  # noqa: E402

from atray_tpu_torch.accel.bvh import build_bvh  # noqa: E402
from atray_tpu_torch.accel.pack import PACK_NODE_WORDS, pack_bvh, pack_node_records  # noqa: E402
from atray_tpu_torch.accel.traverse import bvh_first_hit  # noqa: E402
from atray_tpu_torch.accel.wide import HybridAccel, hybrid_from_mesh, make_accel  # noqa: E402
from atray_tpu_torch.config import KDTreeConfig, RenderSettings  # noqa: E402
from atray_tpu_torch.core.camera import look_at_camera  # noqa: E402
from atray_tpu_torch.interop import scene_from_numpy, treepack_from_numpy  # noqa: E402
from atray_tpu_torch.kernels import _build  # noqa: E402
from atray_tpu_torch.kernels.persistent_packet import ppacket_first_hit, ppacket_ref  # noqa: E402
from atray_tpu_torch.render import wavefront as tw  # noqa: E402
from atray_tpu_torch.render.rng import prng_key  # noqa: E402
from atray_tpu_torch.scene import procedural  # noqa: E402
from atray_tpu_torch.scene.data import SceneParams  # noqa: E402


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _random_rays(rng, n):
    # the rays of the reference's packet-kernel tests
    orig = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return orig, d.astype(np.float32)


@pytest.mark.parametrize("leaf_size", [4, 8, 16])
def test_treepack_tables_bit_equal(leaf_size):
    backend = jax_builder()
    mesh = procedural.dragon_proxy(2000)
    ref_mesh = jax_procedural.dragon_proxy(2000)
    ref = jax_pack_bvh(jax_build_bvh(ref_mesh.vertices, ref_mesh.faces,
                                     JaxKDTreeConfig(leaf_size=leaf_size)))
    got = pack_bvh(build_bvh(mesh.vertices, mesh.faces, KDTreeConfig(leaf_size=leaf_size),
                             backend=backend))
    for f in ("nodebox", "ctrl", "tris"):
        a, b = np.asarray(getattr(ref, f)), getattr(got, f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=f)
    assert (got.leaf_size, got.num_nodes, got.rows_per_leaf) == (
        ref.leaf_size, ref.num_nodes, ref.rows_per_leaf)
    back = treepack_from_numpy(_accel_fields(ref))
    assert all(np.array_equal(_bits(getattr(back, f)), _bits(getattr(got, f)))
               for f in ("nodebox", "ctrl", "tris"))


@pytest.mark.parametrize("leaf_size", [4, 8])
def test_node_records_hold_nodebox_and_ctrl_bits(leaf_size):
    # the kernel's one 32-byte record a node: the box's six floats as their
    # bits, then the miss link and the leaf row as int32, in the tables'
    # DFS preorder (record node + 1 is the interior-hit successor)
    mesh = procedural.dragon_proxy(2000)
    host = pack_bvh(build_bvh(mesh.vertices, mesh.faces, KDTreeConfig(leaf_size=leaf_size)))
    rec = host.to("cpu").cnodes
    assert rec.dtype == torch.int32 and rec.shape == (host.num_nodes, PACK_NODE_WORDS)
    assert rec.is_contiguous()
    np.testing.assert_array_equal(rec[:, 0:6].numpy(), _bits(host.nodebox).T)
    np.testing.assert_array_equal(rec[:, 6:8].numpy(), host.ctrl.T)
    interior = host.ctrl[1] < 0
    assert interior.any() and (~interior).any()
    assert np.all(np.flatnonzero(interior) + 1 < host.num_nodes)     # node + 1 exists
    assert torch.equal(pack_node_records(host.nodebox, host.ctrl), rec)


def test_node_records_are_built_once_per_object_and_anew_after_to():
    mesh = procedural.cube()
    host = pack_bvh(build_bvh(mesh.vertices, mesh.faces, KDTreeConfig(leaf_size=4)))
    pack = host.to("cpu")
    first = pack.cnodes
    assert pack.cnodes is first                                   # cached on the object
    again = pack.to("cpu")
    assert again is not pack and again.cnodes is not first        # a new object, a new table
    assert torch.equal(again.cnodes, first)
    moved = dataclasses.replace(pack, nodebox=pack.nodebox + 1.0)
    assert torch.equal(moved.cnodes[:, 0:6].view(torch.float32), (pack.nodebox + 1.0).t())


def test_plain_walks_match_jax_packet_kernel_and_jnp_walk(rng):
    backend = jax_builder()
    mesh = jax_procedural.uv_sphere(rows=16, cols=16)
    jbvh = jax_build_bvh(mesh.vertices, mesh.faces, JaxKDTreeConfig(leaf_size=8))
    orig, dirn = _random_rays(rng, 1500)
    jo, jd = jnp.asarray(orig), jnp.asarray(dirn)
    kern = [np.asarray(x) for x in jax_ppacket(jax_pack_bvh(jbvh), jo, jd, interpret=True)]
    walk = [np.asarray(x) for x in jax_bvh_first_hit(jbvh, None, jo, jd)]
    bvh = build_bvh(np.asarray(mesh.vertices), np.asarray(mesh.faces), KDTreeConfig(leaf_size=8),
                    backend=backend)
    o, d = torch.from_numpy(orig), torch.from_numpy(dirn)
    before = _build.COUNTERS["ppacket"].plain_calls
    pp = [x.numpy() for x in ppacket_first_hit(pack_bvh(bvh).to("cpu"), o, d)]
    assert _build.COUNTERS["ppacket"].plain_calls == before + 1
    bw = [x.numpy() for x in bvh_first_hit(bvh, None, o, d)]
    assert pp[3].dtype == np.int32 and bw[3].dtype == np.int32
    for got, ref in ((pp, kern), (bw, walk)):
        np.testing.assert_array_equal(got[3], ref[3])
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-5)
        hit = ref[3] >= 0
        assert hit.sum() > 30
        for j in (1, 2):
            np.testing.assert_allclose(got[j][hit], ref[j][hit], atol=1e-5)
        assert np.all(got[0][~hit] == np.float32(3.0e38))
    np.testing.assert_array_equal(pp[3], bw[3])


def test_pad_slots_never_hit(rng):
    # leaf_size larger than the triangle count fills every leaf with pads
    v = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    f = np.asarray([[0, 1, 2]], np.int32)
    bvh = build_bvh(v, f, KDTreeConfig(leaf_size=8))
    pack = pack_bvh(bvh)
    assert (pack.tris.reshape(-1, 16)[:, 0] >= 1.0e29).sum() == 7
    orig, dirn = _random_rays(rng, 1024)
    o, d = torch.from_numpy(orig), torch.from_numpy(dirn)
    _, _, _, ids = ppacket_first_hit(pack.to("cpu"), o, d)
    _, _, _, ids_b = bvh_first_hit(bvh, None, o, d)
    assert set(np.unique(ids.numpy())) == {-1, 0}
    np.testing.assert_array_equal(ids.numpy(), ids_b.numpy())


def _sphere_scene():
    """The reference's packet-render test scene: uv_sphere(10, 10) at z=-4."""
    mats = jax_make_materials([((0.4, 0.5, 0.7), (0.0, 0.0, 0.0), 0.0),
                               ((0.0, 0.0, 0.0), (0.8, 0.6, 0.4), 0.2)])
    mesh = jax_translate(jax_procedural.uv_sphere(rows=10, cols=10, material=1), (0, 0, -4))
    return jax_build_scene([mesh], materials=mats)


def test_render_treepack_matches_jax_render():
    # tests/test_pallas.py's packet render (24x24, 1 spp, 2 bounces) in both
    # packages on the same TreePack tables
    scene = _sphere_scene()
    jpack = jax_pack_bvh(jax_build_bvh(scene.mesh.vertices, scene.mesh.faces,
                                       JaxKDTreeConfig(leaf_size=8)))
    jcam = jax_look_at_camera((0, 0.4, 0.5), (0, 0, -4), h_fov=0.8, aspect=1.0)
    js = JaxRenderSettings(resolution=(24, 24), samples_per_pixel=1, bounce_limit=2)
    ref = np.asarray(jw.render(scene, jcam, js, jax.random.PRNGKey(5), accel=jpack))
    cam = look_at_camera((0, 0.4, 0.5), (0, 0, -4), h_fov=0.8, aspect=1.0)
    s = RenderSettings(resolution=(24, 24), samples_per_pixel=1, bounce_limit=2)
    got = tw.render(scene_from_numpy(_tree(scene)), cam, s, prng_key(5), device="cpu",
                    accel=treepack_from_numpy(_accel_fields(jpack)))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)
    assert ref.std() > 0.05


def _grad_render(scene, accel, cam, settings):
    p = SceneParams(*(x.detach().clone().requires_grad_() for x in scene.params().leaves()))
    film = tw.render(scene.with_params(p), cam, settings, prng_key(7), accel=accel, device="cpu")
    return film.detach(), torch.autograd.grad(film.sum(), p.leaves())


@pytest.mark.parametrize("kind", ["hybrid", "treepack", "bvh"])
def test_skip_link_accels_render_the_make_accel_film_and_gradient(kind):
    # one binary BVH, three walks (HybridAccel: wide_exact for the camera
    # bounce and ppacket after it; TreePack: ppacket; BVH: bvh_first_hit):
    # all find the make_accel walk's hits, so film and gradient are equal
    scene = scene_from_numpy(_tree(_sphere_scene())).to("cpu")
    v, f = scene.mesh.vertices.numpy(), scene.mesh.faces.numpy()
    cfg = KDTreeConfig(leaf_size=8)
    accel = {"hybrid": lambda: hybrid_from_mesh(v, f, cfg),
             "treepack": lambda: pack_bvh(build_bvh(v, f, cfg)),
             "bvh": lambda: build_bvh(v, f, cfg)}[kind]()
    cam = look_at_camera((0, 0.4, 0.5), (0, 0, -4), h_fov=0.8, aspect=1.0)
    s = RenderSettings(resolution=(24, 24), samples_per_pixel=2, bounce_limit=3)
    ref_film, ref_grads = _grad_render(scene, make_accel(v, f, cfg), cam, s)
    counts = {k: (c.launches, c.plain_calls) for k, c in _build.COUNTERS.items()}
    film, grads = _grad_render(scene, accel, cam, s)
    calls = {k: c.plain_calls - counts[k][1] for k, c in _build.COUNTERS.items()}
    assert torch.equal(film, ref_film)
    for a, b in zip(grads, ref_grads):
        assert torch.equal(a, b)
    assert float(ref_film.std()) > 0.05 and float(ref_grads[0].abs().max()) > 0
    if kind == "hybrid":
        assert isinstance(accel, HybridAccel)
        assert calls["wide_exact"] == 1 and calls["ppacket"] == 2    # bounce 0; bounces 1, 2
    else:
        assert calls["wide_exact"] == 0 and calls["ppacket"] == (3 if kind == "treepack" else 0)


def test_wrapper_checks_inputs_and_builds_nothing_on_cpu(monkeypatch):
    def no_build():
        raise AssertionError("the CPU path must not build the CUDA kernels")

    monkeypatch.setattr(_build, "load", no_build)
    mesh = procedural.cube()
    host = pack_bvh(build_bvh(mesh.vertices, mesh.faces, KDTreeConfig(leaf_size=8)))
    pack = host.to("cpu")
    o = torch.tensor([[0.0, 0.0, 3.0]]).repeat(4, 1)
    d = torch.tensor([[0.0, 0.0, -1.0]]).repeat(4, 1)
    t, _, _, fid = ppacket_first_hit(pack, o, d)
    assert fid.dtype == torch.int32 and torch.all(fid >= 0)
    np.testing.assert_allclose(t.numpy(), 2.0)
    with pytest.raises(TypeError):
        ppacket_first_hit(host, o, d)                       # not uploaded
    with pytest.raises(TypeError):
        ppacket_first_hit(pack, o.double(), d)
    with pytest.raises(ValueError):
        ppacket_first_hit(pack, torch.zeros((3, 4)).t(), d)
    with pytest.raises(ValueError, match="num_nodes"):
        ppacket_first_hit(dataclasses.replace(pack, num_nodes=pack.num_nodes + 1), o, d)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    mesh = procedural.dragon_proxy(target_tris=20000)
    pack = pack_bvh(build_bvh(mesh.vertices, mesh.faces, KDTreeConfig(leaf_size=8))).to(dev)
    rng = np.random.default_rng(5)
    o, d = _random_rays(rng, 20000)
    d[:4000][rng.random((4000, 3)) < 0.4] = 0.0           # zero direction components
    o[4000:5000], d[4000:5000] = 1.0e7, (0.0, 0.0, 1.0)   # dead rays, parked as render() parks them
    o, d = torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)
    got = ppacket_first_hit(pack, o, d)
    want = ppacket_ref(pack, o, d)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.all(got[3][4000:5000] == -1) and torch.any(got[3][:4000] >= 0)
    visits = {}
    ppacket_ref(pack, o[4000:5000], d[4000:5000], visits=visits)
    assert visits["nodes"] == 1000                                 # each ends at the root
