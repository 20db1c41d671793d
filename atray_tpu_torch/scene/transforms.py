"""Host-side mesh transforms (``atray_tpu/scene/transforms.py``)."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from atray_tpu_torch.scene.data import TriMesh, _f32


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
