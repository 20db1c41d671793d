"""PyTorch port, host side: procedural meshes, transforms, BVH and shaded
accel tables against the JAX package (array- and bit-equal)."""

import os

import numpy as np
import pytest
import torch

import atray_tpu_torch

torch.set_num_threads(2)

from atray_tpu.accel.shaded import build_shaded_accel as jax_build_shaded_accel  # noqa: E402
from atray_tpu.config import KDTreeConfig as JaxKDTreeConfig  # noqa: E402
from atray_tpu.native import available as jax_native_available  # noqa: E402
from atray_tpu.native import bindings as jax_native_bindings  # noqa: E402
from atray_tpu.scene import build_scene as jax_build_scene  # noqa: E402
from atray_tpu.scene import procedural as jax_procedural  # noqa: E402
from atray_tpu.scene import transforms as jax_transforms  # noqa: E402

from atray_tpu_torch.accel.shaded import build_shaded_accel  # noqa: E402
from atray_tpu_torch.config import KDTreeConfig  # noqa: E402
from atray_tpu_torch.kernels.wide_shade import wide_shade_planes  # noqa: E402
from atray_tpu_torch.native import available as port_native_available  # noqa: E402
from atray_tpu_torch.scene import build_scene, procedural, transforms  # noqa: E402

MESH_FIELDS = ("vertices", "faces", "normals", "face_normal_idx", "tex_coords",
               "face_tex_idx", "material_id")
MESHES = [("cube", ()), ("uv_sphere", (10, 10)), ("dragon_proxy", (2000,))]


def _assert_mesh_equal(ref, port):
    for f in MESH_FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("name,args", MESHES + [("uv_sphere", (7, 9, 2.0, 3, False))])
def test_procedural_array_equal(name, args):
    _assert_mesh_equal(getattr(jax_procedural, name)(*args),
                       getattr(procedural, name)(*args))


def test_transforms_array_equal():
    ref = jax_procedural.dragon_proxy(target_tris=1500)
    port = procedural.dragon_proxy(target_tris=1500)
    _assert_mesh_equal(jax_transforms.translate(ref, (0.5, -1.0, -4.0)),
                       transforms.translate(port, (0.5, -1.0, -4.0)))
    _assert_mesh_equal(jax_transforms.translate_to(ref, (1.0, 2.0, 3.0)),
                       transforms.translate_to(port, (1.0, 2.0, 3.0)))
    _assert_mesh_equal(jax_transforms.scale_to(ref, 2.5),
                       transforms.scale_to(port, 2.5))


def _jax_native_loads() -> bool:
    """Whether the JAX package's native builder loads, retried once: its
    loader gives up for the life of the process after one failed load, and
    under parallel workers that load can fall while another worker is still
    writing the library (built in place, its stamp after it). By now that
    worker has finished the file and its stamp."""
    if jax_native_available():
        return True
    jax_native_bindings._tried = False
    return jax_native_bindings.ensure_built()


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("name,args", MESHES)
def test_shaded_accel_tables_bit_equal(name, args, backend):
    if backend == "native" and not (_jax_native_loads() and port_native_available()):
        pytest.skip("no C++ toolchain for the native builder")
    cfg = dict(leaf_size=8)
    ref = jax_build_shaded_accel(
        jax_build_scene([getattr(jax_procedural, name)(*args)]),
        JaxKDTreeConfig(**cfg), backend=backend)
    port = build_shaded_accel(build_scene([getattr(procedural, name)(*args)]),
                              KDTreeConfig(**cfg), backend=backend)
    for f in ("cboxes", "clinks", "caxis", "tris"):
        a, b = np.asarray(getattr(ref, f)), getattr(port, f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32), err_msg=f)
    np.testing.assert_array_equal(np.asarray(ref.tboxes), port.tboxes)   # NaN == NaN
    np.testing.assert_array_equal(np.asarray(ref.build_vertices), port.build_vertices)
    for f in ("leaf_size", "num_nodes", "max_depth", "num_treelets", "leaves_per_treelet"):
        assert getattr(ref, f) == getattr(port, f), f


def test_native_builder_compiles_the_ports_own_source():
    from atray_tpu_torch.native import bindings

    port_dir = os.path.dirname(os.path.abspath(atray_tpu_torch.__file__))
    src = os.path.abspath(bindings.SRC)
    assert os.path.commonpath([src, port_dir]) == port_dir
    assert os.path.isfile(src) and src.endswith(".cpp")


def test_native_and_numpy_builds_give_same_hits(rng):
    if not port_native_available():
        pytest.skip("no C++ toolchain for the native builder")
    scene = build_scene([procedural.dragon_proxy(target_tris=3000, smooth=False)])
    cfg = KDTreeConfig(leaf_size=8)
    acc_nat = build_shaded_accel(scene, cfg, backend="native").to("cpu")
    acc_np = build_shaded_accel(scene, cfg, backend="numpy").to("cpu")
    o = rng.uniform(-3, 3, (1500, 3)).astype(np.float32)
    d = rng.normal(size=(1500, 3))
    d[:1000] = rng.uniform(-0.6, 0.6, (1000, 3)) - o[:1000]    # aimed at the mesh
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    planes = [torch.from_numpy(np.ascontiguousarray(a[:, k])) for a in (o, d) for k in range(3)]
    alive = torch.ones(1500, dtype=torch.bool)
    h1 = wide_shade_planes(acc_nat, *planes, alive)
    h2 = wide_shade_planes(acc_np, *planes, alive)
    assert int((h1["id"] >= 0).sum()) > 500
    np.testing.assert_allclose(h1["t"].numpy(), h2["t"].numpy(), rtol=1e-5)
    np.testing.assert_array_equal(h1["id"].numpy(), h2["id"].numpy())


def test_scene_and_accel_upload():
    scene = build_scene([procedural.cube()])
    accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=8))
    s_dev, a_dev = scene.to("cpu"), accel.to("cpu")
    assert isinstance(s_dev.mesh.vertices, torch.Tensor)
    assert s_dev.mesh.faces.dtype == torch.int32
    assert s_dev.device == torch.device("cpu")
    assert a_dev.clinks.dtype == torch.int32 and a_dev.tris.dtype == torch.float32
    assert a_dev.num_nodes == accel.num_nodes
    np.testing.assert_array_equal(a_dev.tris.numpy().view(np.int32), accel.tris.view(np.int32))
    # host builders accept an uploaded scene too
    again = build_shaded_accel(s_dev, KDTreeConfig(leaf_size=8))
    np.testing.assert_array_equal(again.tris.view(np.int32), accel.tris.view(np.int32))
