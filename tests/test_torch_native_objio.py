"""PyTorch port: the native OBJ parser and ``load_obj``'s backends.

Twins of ``tests/test_native.py``, ``test_objio.py``, ``test_assets.py``
and ``test_dragon_file.py``: the port's ``parse_obj_native`` equals the
JAX package's ``parse_obj_native`` and the port's Python parser array for
array, exactly, on every face form, the three assets and a 139k-triangle
file; ``load_obj`` gives the JAX package's ``TriMesh`` leaves under every
backend."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from atray_tpu.native import available as jax_native_available  # noqa: E402
from atray_tpu.native import parse_obj_native as jax_parse_obj_native  # noqa: E402
from atray_tpu.scene.objio import load_obj as jax_load_obj  # noqa: E402

from atray_tpu_torch.native import available, parse_obj_native  # noqa: E402
from atray_tpu_torch.scene import load_obj, procedural, save_obj  # noqa: E402

ASSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "assets")
MESH_FIELDS = ("vertices", "faces", "normals", "face_normal_idx", "tex_coords",
               "face_tex_idx", "material_id")
NATIVE_KEYS = ("vertices", "normals", "tex_coords", "faces", "face_normal_idx", "face_tex_idx")

# every face-vertex form, negative indices, a quad and a pentagon (fans),
# a record with no space after "vt", and two usemtl groups
OBJ_FORMS = """
# comment
v 0.0 0.0 0.0
v 1.0 0.0 0.0
v 0.0 1.0 0.0
v 1.0 1.0 0.0
v 0.5 1.5 0.25
vt 0.0 0.0
vt 1.0 0.0
vt 0.0 1.0
vt 0.5
vn 0.0 0.0 1.0
vn 0.0 1.0 0.0
usemtl red
f 1 2 3
f 1/1 2/2 3/3
f 1//1 2//1 3//2
f 1/1/1 2/2/1 3/3/2
usemtl blue
f -5 -4 -3
f -5/-4/-2 -4/-3/-1 -3/-2/-2
f 1 2 4 3
f 1/1 2/2 4/3 5/4 3/1
"""


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _same_parse(path):
    """The port's native parse, held equal to the JAX package's native
    parse and to the port's Python parser, array for array. The JAX
    package builds its library in place, and a test worker that lost that
    race has none (``jax_native_available()``): there the port's parse is
    held to the Python parser alone, which the JAX package's equals
    (``test_torch_camera_objio.py``)."""
    got = parse_obj_native(path)
    assert got is not None, "the port's native parser did not run"
    want = jax_parse_obj_native(path)
    assert want is not None or not jax_native_available()
    py = load_obj(path, backend="python")
    for k in NATIVE_KEYS:
        if want is not None:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        ref = getattr(py, k)
        if got[k].shape[0] == 0:        # a TriMesh pads an empty table to one zero row
            np.testing.assert_array_equal(ref, np.zeros_like(ref), err_msg=k)
        else:
            assert got[k].dtype == ref.dtype, k
            np.testing.assert_array_equal(got[k], ref, err_msg=k)
    return got


def test_native_parser_face_forms(tmp_path):
    assert available()
    got = _same_parse(_write(tmp_path, "forms.obj", OBJ_FORMS))
    # 6 triangles, the quad's fan of 2 and the pentagon's of 3
    assert got["faces"].shape == (11, 3)
    np.testing.assert_array_equal(got["faces"][4], [0, 1, 2])
    np.testing.assert_array_equal(got["face_normal_idx"][5], [0, 1, 0])
    np.testing.assert_array_equal(got["faces"][6:8], [[0, 1, 3], [0, 3, 2]])
    np.testing.assert_array_equal(got["face_tex_idx"][8:11],
                                  [[0, 1, 2], [0, 2, 3], [0, 3, 0]])
    np.testing.assert_array_equal(got["tex_coords"][3], [0.5, 0.0])


@pytest.mark.parametrize("name,tris,verts",
                         [("Cube", 12, 8), ("Deer", 1570, 832), ("Monkey", 3936, 2012)])
def test_native_parser_on_assets(name, tris, verts):
    got = _same_parse(os.path.join(ASSET_DIR, f"{name}.obj"))
    assert got["faces"].shape == (tris, 3) and got["vertices"].shape == (verts, 3)


def test_native_parser_on_a_139k_triangle_file(tmp_path):
    mesh = procedural.dragon_proxy(target_tris=139_000, material=1)
    path = str(tmp_path / "Dragon.obj")
    save_obj(path, mesh)
    assert os.path.getsize(path) > 5_000_000
    got = _same_parse(path)
    # the file round-trips the mesh it was written from
    for k in ("vertices", "faces", "normals", "face_normal_idx"):
        np.testing.assert_array_equal(got[k], getattr(mesh, k), err_msg=k)


@pytest.mark.parametrize("backend", ["auto", "native", "python"])
def test_load_obj_backends_give_the_jax_meshes(tmp_path, backend):
    forms = _write(tmp_path, "forms.obj", OBJ_FORMS)
    deer = os.path.join(ASSET_DIR, "Deer.obj")
    for path in (forms, deer):
        for kw in ({}, {"default_material": 3},
                   {"material_map": {"red": 2, "blue": 4}, "default_material": 1}):
            # the JAX package's "native" raises where its library lost the
            # build race (``_same_parse``); its Python parser gives the same
            jb = backend if jax_native_available() else "python"
            want = jax_load_obj(path, backend=jb, **kw)
            got = load_obj(path, backend=backend, **kw)
            for f in MESH_FIELDS:
                a, b = np.asarray(getattr(want, f)), getattr(got, f)
                assert a.dtype == b.dtype, (path, kw, f)
                np.testing.assert_array_equal(b, a, err_msg=f"{path} {kw} {f}")
    grouped = load_obj(forms, backend=backend, material_map={"red": 2, "blue": 4})
    np.testing.assert_array_equal(grouped.material_id, [2] * 4 + [4] * 7)


def test_native_parse_failure(tmp_path):
    missing = str(tmp_path / "missing.obj")
    assert parse_obj_native(missing) is None
    with pytest.raises(RuntimeError, match="native OBJ parse failed"):
        load_obj(missing, backend="native")
    # "auto" goes on to the Python parser, which raises as open() does
    with pytest.raises(FileNotFoundError):
        load_obj(missing)
    with pytest.raises(ValueError, match="backend"):
        load_obj(os.path.join(ASSET_DIR, "Cube.obj"), backend="fast")
