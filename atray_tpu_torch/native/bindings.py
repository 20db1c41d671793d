"""ctypes bindings to the native host components: the SAH BVH builder and
the OBJ parser.

The port keeps its own copy of the C++ source,
``atray_tpu_torch/native/atray_native.cpp`` (a copy of the JAX package's
``atray_tpu/native/atray_native.cpp`` with the same builder and parser), and compiles
it with the system C++ compiler into the port's git-ignored
``atray_tpu_torch/_build/``. The library name carries a hash of the source
and flags, so an edited source builds a new library and a stale one is
never loaded.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "atray_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC"]


class _BvhOut(ctypes.Structure):
    _fields_ = [
        ("node_min", ctypes.POINTER(ctypes.c_float)),
        ("node_max", ctypes.POINTER(ctypes.c_float)),
        ("node_miss", ctypes.POINTER(ctypes.c_int32)),
        ("leaf_start", ctypes.POINTER(ctypes.c_int32)),
        ("tri_p0", ctypes.POINTER(ctypes.c_float)),
        ("tri_e1", ctypes.POINTER(ctypes.c_float)),
        ("tri_e2", ctypes.POINTER(ctypes.c_float)),
        ("tri_id", ctypes.POINTER(ctypes.c_int32)),
        ("num_nodes", ctypes.c_int64),
        ("num_slots", ctypes.c_int64),
    ]


class _ObjOut(ctypes.Structure):
    """``AtrayObjOut`` of ``atray_native.cpp``: malloc'd buffers and counts."""

    _fields_ = [
        ("verts", ctypes.POINTER(ctypes.c_float)),
        ("norms", ctypes.POINTER(ctypes.c_float)),
        ("texs", ctypes.POINTER(ctypes.c_float)),
        ("faces", ctypes.POINTER(ctypes.c_int32)),
        ("fnidx", ctypes.POINTER(ctypes.c_int32)),
        ("ftidx", ctypes.POINTER(ctypes.c_int32)),
        ("nverts", ctypes.c_int64),
        ("nnorms", ctypes.c_int64),
        ("ntexs", ctypes.c_int64),
        ("nfaces", ctypes.c_int64),
    ]


class _Native:
    """The loaded library, or the reason it could not be built."""

    lib: Optional[ctypes.CDLL] = None
    error: Optional[str] = None


_native = _Native()


def _build() -> ctypes.CDLL:
    with open(SRC, "rb") as fh:
        src = fh.read()
    tag = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    lib_path = os.path.join(BUILD_DIR, f"libatray_native-{tag}.so")
    if not os.path.exists(lib_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *_FLAGS, SRC, "-o", tmp], check=True,
                           capture_output=True, timeout=300)
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(lib_path)
    lib.atray_build_bvh.restype = ctypes.c_int
    lib.atray_build_bvh.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(_BvhOut),
    ]
    lib.atray_parse_obj.restype = ctypes.c_int
    lib.atray_parse_obj.argtypes = [ctypes.c_char_p, ctypes.POINTER(_ObjOut)]
    lib.atray_free.restype = None
    lib.atray_free.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    """Build (once per process) and load the library; False if the
    toolchain or the source is missing."""
    if _native.lib is None and _native.error is None:
        try:
            _native.lib = _build()
        except (OSError, subprocess.SubprocessError) as e:
            _native.error = repr(e)
    return _native.lib is not None


def _take(ptr, count, dtype):
    """Copy a malloc'd buffer into numpy."""
    return np.ctypeslib.as_array(ptr, shape=(count,)).copy().astype(dtype, copy=False)


def build_bvh_native(vertices, faces, leaf_size: int, sah_bins: int, max_depth: int):
    """Native BVH build -> dict of flat arrays (accel/bvh.py layout), or
    None when the library is unavailable or the build fails."""
    if not available():
        return None
    lib = _native.lib
    v = np.ascontiguousarray(np.asarray(vertices, np.float32))
    f = np.ascontiguousarray(np.asarray(faces, np.int32))
    out = _BvhOut()
    rc = lib.atray_build_bvh(
        v.ctypes.data, v.shape[0], f.ctypes.data, f.shape[0],
        int(leaf_size), int(sah_bins), int(max_depth), ctypes.byref(out),
    )
    if rc != 0:
        return None
    k, slots = out.num_nodes, out.num_slots
    result = dict(
        node_min=_take(out.node_min, 3 * k, np.float32).reshape(k, 3),
        node_max=_take(out.node_max, 3 * k, np.float32).reshape(k, 3),
        node_miss=_take(out.node_miss, k, np.int32),
        leaf_start=_take(out.leaf_start, k, np.int32),
        tri_p0=_take(out.tri_p0, 3 * slots, np.float32).reshape(slots, 3),
        tri_e1=_take(out.tri_e1, 3 * slots, np.float32).reshape(slots, 3),
        tri_e2=_take(out.tri_e2, 3 * slots, np.float32).reshape(slots, 3),
        tri_orig_id=_take(out.tri_id, slots, np.int32),
    )
    for ptr in (out.node_min, out.node_max, out.node_miss, out.leaf_start,
                out.tri_p0, out.tri_e1, out.tri_e2, out.tri_id):
        lib.atray_free(ctypes.cast(ptr, ctypes.c_void_p))
    return result


def parse_obj_native(path: str):
    """Native OBJ parse -> dict of arrays (vertices, normals, tex_coords,
    faces, face_normal_idx, face_tex_idx), or None when the library is
    unavailable or the parse fails (a missing file, say)."""
    if not available():
        return None
    lib = _native.lib
    out = _ObjOut()
    rc = lib.atray_parse_obj(os.fsencode(path), ctypes.byref(out))
    if rc != 0:
        return None

    def rows(ptr, count, width, dtype):
        # the parser allocates at least one row, so an empty table is a
        # valid buffer cut to zero rows
        return _take(ptr, width * max(count, 1), dtype).reshape(-1, width)[:count]

    nf = out.nfaces
    result = dict(
        vertices=rows(out.verts, out.nverts, 3, np.float32),
        normals=rows(out.norms, out.nnorms, 3, np.float32),
        tex_coords=rows(out.texs, out.ntexs, 2, np.float32),
        faces=rows(out.faces, nf, 3, np.int32),
        face_normal_idx=rows(out.fnidx, nf, 3, np.int32),
        face_tex_idx=rows(out.ftidx, nf, 3, np.int32),
    )
    for ptr in (out.verts, out.norms, out.texs, out.faces, out.fnidx, out.ftidx):
        lib.atray_free(ctypes.cast(ptr, ctypes.c_void_p))
    return result
