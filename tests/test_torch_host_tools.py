"""PyTorch port: host tools. ``compute_vertex_normals`` bit-equal to the
JAX package's; ``validate_bvh`` on the port's builds and on broken trees;
debugviz's depth map and level boxes equal to the JAX package's on the
same tree (a twin of ``tests/test_aux.py::TestDebugViz``)."""

import dataclasses
import os
import zlib

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from atray_tpu.accel.bvh import build_bvh as jax_build_bvh  # noqa: E402
from atray_tpu.config import KDTreeConfig as JaxKDTreeConfig  # noqa: E402
from atray_tpu.core.camera import look_at_camera as jax_look_at_camera  # noqa: E402
from atray_tpu.scene import build_scene as jax_build_scene  # noqa: E402
from atray_tpu.scene import procedural as jax_procedural  # noqa: E402
from atray_tpu.scene.objio import load_obj as jax_load_obj  # noqa: E402
from atray_tpu.scene.transforms import compute_vertex_normals as jax_vertex_normals  # noqa: E402
from atray_tpu.scene.transforms import translate as jax_translate  # noqa: E402
from atray_tpu.utils import debugviz as jax_debugviz  # noqa: E402

from test_torch_render import jax_builder  # noqa: E402

from atray_tpu_torch.accel.bvh import build_bvh, validate_bvh  # noqa: E402
from atray_tpu_torch.config import KDTreeConfig  # noqa: E402
from atray_tpu_torch.core.camera import look_at_camera  # noqa: E402
from atray_tpu_torch.scene import load_obj, procedural  # noqa: E402
from atray_tpu_torch.scene.transforms import compute_vertex_normals, translate  # noqa: E402
from atray_tpu_torch.utils import debugviz  # noqa: E402

DEER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "assets", "Deer.obj")


@pytest.mark.parametrize("which", ["uv_sphere", "Deer.obj"])
def test_vertex_normals_bit_equal_to_jax(which):
    if which == "uv_sphere":
        want_in = jax_procedural.uv_sphere(rows=12, cols=16, smooth=False)
        got_in = procedural.uv_sphere(rows=12, cols=16, smooth=False)
    else:
        want_in, got_in = jax_load_obj(DEER, backend="python"), load_obj(DEER)
    want, got = jax_vertex_normals(want_in), compute_vertex_normals(got_in)
    for f in ("normals", "face_normal_idx", "vertices", "faces"):
        a, b = np.asarray(getattr(want, f)), np.asarray(getattr(got, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)
    assert np.abs(np.linalg.norm(got.normals, axis=1) - 1.0).max() < 1e-6


def test_validate_bvh_passes_on_builds_and_catches_broken_trees():
    dragon = procedural.dragon_proxy(target_tris=139_000)
    deer = load_obj(DEER)
    # the numpy builder takes seconds at 139k triangles: the dragon takes
    # the native one (``tests/test_torch_scene_accel.py`` holds the two equal)
    for mesh, cfg, backends in ((dragon, KDTreeConfig(), ("native",)),
                                (deer, KDTreeConfig(leaf_size=16), ("native", "numpy"))):
        for backend in backends:
            validate_bvh(build_bvh(mesh.vertices, mesh.faces, cfg, backend=backend),
                         mesh.num_faces)
    bvh = build_bvh(deer.vertices, deer.faces, KDTreeConfig(leaf_size=16))
    miss = bvh.node_miss.copy()
    miss[0] = 3
    with pytest.raises(AssertionError, match="root's skip"):
        validate_bvh(dataclasses.replace(bvh, node_miss=miss), deer.num_faces)
    miss = bvh.node_miss.copy()
    i = int(np.nonzero(miss > 1)[0][-1])
    miss[i] = i
    with pytest.raises(AssertionError, match="strictly forward"):
        validate_bvh(dataclasses.replace(bvh, node_miss=miss), deer.num_faces)
    oid = bvh.tri_orig_id.copy()
    oid[np.nonzero(oid >= 0)[0][7]] = -1        # a face dropped from its leaf
    with pytest.raises(AssertionError, match="face count"):
        validate_bvh(dataclasses.replace(bvh, tri_orig_id=oid), deer.num_faces)
    oid = bvh.tri_orig_id.copy()
    real = np.nonzero(oid >= 0)[0]
    oid[real[7]] = oid[real[8]]                 # a face dropped, another twice
    with pytest.raises(AssertionError, match="exactly once"):
        validate_bvh(dataclasses.replace(bvh, tri_orig_id=oid), deer.num_faces)
    nmin = bvh.node_min.copy()
    nmin[0] += 0.5                              # the root no longer holds its subtree
    with pytest.raises(AssertionError):
        validate_bvh(dataclasses.replace(bvh, node_min=nmin), deer.num_faces)


def _debug_pair():
    """The reference's TestDebugViz scene, its BVH built by one builder in
    both packages (``jax_builder``), and the camera."""
    backend = jax_builder()
    jmesh = jax_translate(jax_procedural.uv_sphere(rows=10, cols=10, material=1), (0, 0, -4))
    mesh = translate(procedural.uv_sphere(rows=10, cols=10, material=1), (0, 0, -4))
    jbvh = jax_build_bvh(jmesh.vertices, jmesh.faces, JaxKDTreeConfig(), backend=backend)
    bvh = build_bvh(mesh.vertices, mesh.faces, KDTreeConfig(), backend=backend)
    for f in ("node_min", "node_max", "node_miss", "leaf_start", "tri_orig_id"):
        np.testing.assert_array_equal(getattr(bvh, f), np.asarray(getattr(jbvh, f)), err_msg=f)
    jcam = jax_look_at_camera((0, 0.4, 0.5), (0, 0, -4), h_fov=0.8, aspect=1.5)
    cam = look_at_camera((0, 0.4, 0.5), (0, 0, -4), h_fov=0.8, aspect=1.5)
    return (jax_build_scene([jmesh]), jbvh, jcam), (None, bvh, cam)


def test_traversal_depth_map_equals_jax():
    (jscene, jbvh, jcam), (_, bvh, cam) = _debug_pair()
    want = jax_debugviz.traversal_depth_map(jbvh, jscene, jcam, 48, 32)
    got = debugviz.traversal_depth_map(bvh, None, cam, 48, 32, device="cpu")
    assert got.shape == (32, 48, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got[..., 0].max() == 1.0 and got[..., 0].min() < 0.5
    with pytest.raises(TypeError, match="BVH"):
        debugviz.traversal_depth_map(object(), None, cam, 4, 4, device="cpu")


def test_bvh_level_boxes_equal_jax():
    (_, jbvh, _), (_, bvh, _) = _debug_pair()
    for level in (0, 1, 2, 3, 12):
        want = jax_debugviz.bvh_level_boxes(jbvh, level=level)
        got = debugviz.bvh_level_boxes(bvh, level=level)
        assert got.shape[1:] == (2, 3) and got.shape[0] >= 1
        assert (got[:, 1] >= got[:, 0]).all()
        np.testing.assert_array_equal(got, want, err_msg=f"level {level}")


def test_save_cost_heatmap_writes_the_png(tmp_path):
    _, (_, bvh, cam) = _debug_pair()
    path = debugviz.save_cost_heatmap(str(tmp_path / "cost.png"), bvh, None, cam, width=48,
                                      height=32, device="cpu")
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    idat = data.index(b"IDAT")
    n = int.from_bytes(data[idat - 4:idat], "big")
    raw = np.frombuffer(zlib.decompress(data[idat + 4:idat + 4 + n]), np.uint8)
    rows = raw.reshape(32, 1 + 48 * 3)[:, 1:].reshape(32, 48, 3)
    film = debugviz.traversal_depth_map(bvh, None, cam, 48, 32, device="cpu")
    np.testing.assert_array_equal(rows, np.clip(film * 255.0 + 0.5, 0, 255).astype(np.uint8))
