"""Wavefront OBJ load and save on the host, in numpy
(``atray_tpu/scene/objio.py``).

``v``/``vt``/``vn`` records; the four face-vertex forms (``v``, ``v/vt``,
``v//vn``, ``v/vt/vn``); negative (relative) indices; n-gons split into
fans; ``usemtl`` groups mapped to material ids. Two parsers give the same
arrays: the native C++ one (``native.parse_obj_native``, the port's copy of
the reference's ``atray_native.cpp``), which does not track ``usemtl``, and
the Python one below.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from atray_tpu_torch.scene.data import TriMesh, _f32, _i32, to_numpy


def _fix_index(idx: int, count: int) -> int:
    """OBJ 1-based or negative (relative) index -> 0-based."""
    return idx - 1 if idx > 0 else count + idx


def _native_mesh(nat: dict, default_material: int) -> TriMesh:
    t = nat["faces"].shape[0]
    return TriMesh(
        vertices=_f32(nat["vertices"]),
        faces=_i32(nat["faces"]),
        normals=_f32(nat["normals"] if nat["normals"].shape[0] else np.zeros((1, 3))),
        face_normal_idx=_i32(nat["face_normal_idx"]),
        tex_coords=_f32(nat["tex_coords"] if nat["tex_coords"].shape[0] else np.zeros((1, 2))),
        face_tex_idx=_i32(nat["face_tex_idx"]),
        material_id=_i32(np.full((t,), default_material, np.int32)),
    )


def load_obj(path: str, material_map: Optional[Dict[str, int]] = None,
             default_material: int = 1, backend: str = "auto") -> TriMesh:
    """Parse an OBJ file into a host ``TriMesh``. ``material_map`` maps
    ``usemtl`` names to material ids; unmapped names and faces before any
    ``usemtl`` get ``default_material``.

    ``backend``: "auto" takes the native parser where no ``material_map``
    is given, and the Python parser where one is or where the native
    library cannot build here; "native" takes the native parser where no
    ``material_map`` is given and raises ``RuntimeError`` if it fails;
    "python" takes the Python parser."""
    if backend not in ("auto", "native", "python"):
        raise ValueError(f"unknown OBJ backend {backend!r}")
    if backend != "python" and not material_map:
        from atray_tpu_torch.native import parse_obj_native

        nat = parse_obj_native(path)
        if nat is not None and nat["vertices"].shape[0] > 0:
            return _native_mesh(nat, default_material)
        if backend == "native":
            raise RuntimeError(f"native OBJ parse failed for {path!r}")
    verts: List[Tuple[float, float, float]] = []
    norms: List[Tuple[float, float, float]] = []
    texs: List[Tuple[float, float]] = []
    faces: List[Tuple[int, ...]] = []
    f_nidx: List[Tuple[int, ...]] = []
    f_tidx: List[Tuple[int, ...]] = []
    f_mat: List[int] = []
    cur_mat = default_material

    with open(path, "r", errors="replace") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                verts.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "vn":
                norms.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif tag == "vt":
                texs.append((float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0))
            elif tag == "usemtl":
                name = parts[1] if len(parts) > 1 else ""
                cur_mat = (material_map or {}).get(name, default_material)
            elif tag == "f":
                corners = []
                for tok in parts[1:]:
                    fields = tok.split("/")
                    vi = _fix_index(int(fields[0]), len(verts))
                    ti = (_fix_index(int(fields[1]), len(texs))
                          if len(fields) > 1 and fields[1] else -1)
                    ni = (_fix_index(int(fields[2]), len(norms))
                          if len(fields) > 2 and fields[2] else -1)
                    corners.append((vi, ti, ni))
                for k in range(1, len(corners) - 1):
                    tri = (corners[0], corners[k], corners[k + 1])
                    faces.append(tuple(c[0] for c in tri))
                    f_tidx.append(tuple(c[1] for c in tri))
                    f_nidx.append(tuple(c[2] for c in tri))
                    f_mat.append(cur_mat)

    if not verts:
        raise ValueError(f"OBJ file {path!r} contains no vertices")
    return TriMesh(
        vertices=_f32(verts),
        faces=_i32(np.asarray(faces, np.int32).reshape(-1, 3)),
        normals=_f32(norms if norms else np.zeros((1, 3))),
        face_normal_idx=_i32(np.asarray(f_nidx, np.int32).reshape(-1, 3)),
        tex_coords=_f32(texs if texs else np.zeros((1, 2))),
        face_tex_idx=_i32(np.asarray(f_tidx, np.int32).reshape(-1, 3)),
        material_id=_i32(f_mat),
    )


def save_obj(path: str, mesh: TriMesh) -> None:
    """Write a ``TriMesh`` to OBJ; ``load_obj`` reads it back."""
    v, n, t = (to_numpy(x) for x in (mesh.vertices, mesh.normals, mesh.tex_coords))
    f, fn, ft = (to_numpy(x) for x in (mesh.faces, mesh.face_normal_idx, mesh.face_tex_idx))
    has_n = bool((fn >= 0).any())
    has_t = bool((ft >= 0).any())
    with open(path, "w") as fh:
        fh.write("# atray_tpu_torch mesh\n")
        for row in v:
            fh.write(f"v {row[0]:.9g} {row[1]:.9g} {row[2]:.9g}\n")
        if has_t:
            for row in t:
                fh.write(f"vt {row[0]:.9g} {row[1]:.9g}\n")
        if has_n:
            for row in n:
                fh.write(f"vn {row[0]:.9g} {row[1]:.9g} {row[2]:.9g}\n")
        for i in range(f.shape[0]):
            toks = []
            for c in range(3):
                vi = f[i, c] + 1
                if has_n and fn[i, c] >= 0:
                    ti = str(ft[i, c] + 1) if has_t and ft[i, c] >= 0 else ""
                    toks.append(f"{vi}/{ti}/{fn[i, c] + 1}")
                elif has_t and ft[i, c] >= 0:
                    toks.append(f"{vi}/{ft[i, c] + 1}")
                else:
                    toks.append(str(vi))
            fh.write("f " + " ".join(toks) + "\n")
