"""Host-side mesh transforms and bounds (``atray_tpu/scene/transforms.py``):
AABB, translate and scale (to a position or an extent), and smooth vertex
normals."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from atray_tpu_torch.scene.data import TriMesh, _f32
from atray_tpu_torch.scene.procedural import _vertex_normals_np


def get_aabb(mesh: TriMesh) -> Tuple[np.ndarray, np.ndarray]:
    """(min, max) corners over all vertices."""
    v = np.asarray(mesh.vertices)
    return v.min(axis=0), v.max(axis=0)


def translate(mesh: TriMesh, offset) -> TriMesh:
    v = np.asarray(mesh.vertices) + np.asarray(offset, np.float32)
    return dataclasses.replace(mesh, vertices=_f32(v))


def translate_to(mesh: TriMesh, position) -> TriMesh:
    """Move the mesh so its AABB centre lands on ``position``."""
    lo, hi = get_aabb(mesh)
    center = (lo + hi) * 0.5
    return translate(mesh, np.asarray(position, np.float32) - center)


def scale(mesh: TriMesh, factor: float) -> TriMesh:
    v = np.asarray(mesh.vertices) * np.float32(factor)
    return dataclasses.replace(mesh, vertices=_f32(v))


def scale_to(mesh: TriMesh, max_extent: float) -> TriMesh:
    """Uniformly scale so the longest AABB edge equals ``max_extent``."""
    lo, hi = get_aabb(mesh)
    cur = float((hi - lo).max())
    if cur <= 0.0:
        return mesh
    return scale(mesh, max_extent / cur)


def compute_vertex_normals(mesh: TriMesh) -> TriMesh:
    """Area-weighted smooth vertex normals (float64 sums in the reference's
    order, so the normals are its bits); fills ``normals`` and sets
    ``face_normal_idx`` to the faces."""
    v = np.asarray(mesh.vertices)
    return dataclasses.replace(mesh, normals=_vertex_normals_np(v, np.asarray(mesh.faces)),
                               face_normal_idx=mesh.faces)
