"""Build the port's objects from plain numpy leaves of the JAX package's.

The port never imports ``atray_tpu``; a caller that holds both (the parity
tests) extracts the reference's leaves as numpy arrays and hands them here,
so both packages render identical scenes and walk identical tables.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from atray_tpu_torch.accel.shaded import ShadedWideBVH
from atray_tpu_torch.scene.data import Materials, Planes, Scene, Spheres, TriMesh


def _arrays(fields: Mapping[str, Any]) -> dict:
    return {k: None if v is None else np.asarray(v) for k, v in fields.items()}


def scene_from_numpy(tree: Mapping[str, Any]) -> Scene:
    """``tree`` maps "mesh", "spheres", "planes" and "materials" to field
    mappings (``TriMesh``, ``Spheres``, ``Planes``, ``Materials`` field
    names), plus an optional "texture" array."""
    tex = tree.get("texture")
    return Scene(
        mesh=TriMesh(**_arrays(tree["mesh"])),
        spheres=Spheres(**_arrays(tree["spheres"])),
        planes=Planes(**_arrays(tree["planes"])),
        materials=Materials(**_arrays(tree["materials"])),
        texture=None if tex is None else np.asarray(tex, np.float32),
    )


_ACCEL_INTS = ("leaf_size", "num_nodes", "max_depth", "num_treelets", "leaves_per_treelet")


def shaded_accel_from_numpy(fields: Mapping[str, Any]) -> ShadedWideBVH:
    """``fields`` holds the ``ShadedWideBVH`` field names: table arrays
    (cboxes, clinks, caxis, tris, tboxes, build_vertices) and ints."""
    kw = {k: (int(v) if k in _ACCEL_INTS else (None if v is None else np.asarray(v)))
          for k, v in fields.items()}
    return ShadedWideBVH(**kw)
