"""Build the port's objects from plain numpy leaves of the JAX package's.

The port never imports ``atray_tpu``; a caller that holds both (the parity
tests, or a run that moves from one package to the other) extracts the
reference's leaves as numpy arrays and hands them here, so both packages
render identical scenes, walk identical tables and train from identical
weights and optimizer state.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from atray_tpu_torch.accel.pack import TreePack
from atray_tpu_torch.accel.shaded import ShadedWideBVH
from atray_tpu_torch.accel.wide import WideBVH
from atray_tpu_torch.device import resolve_device
from atray_tpu_torch.scene.data import (
    Materials,
    Planes,
    Scene,
    SceneParams,
    Spheres,
    TriMesh,
)


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


def _accel_kw(fields: Mapping[str, Any]) -> dict:
    return {k: (int(v) if k in _ACCEL_INTS else None if v is None else np.asarray(v))
            for k, v in fields.items()}


def shaded_accel_from_numpy(fields: Mapping[str, Any]) -> ShadedWideBVH:
    """``fields`` holds the ``ShadedWideBVH`` field names: table arrays
    (cboxes, clinks, caxis, tris, tboxes, build_vertices) and ints."""
    return ShadedWideBVH(**_accel_kw(fields))


def wide_accel_from_numpy(fields: Mapping[str, Any]) -> WideBVH:
    """``fields`` holds the ``WideBVH`` field names: table arrays (cboxes,
    clinks, tris, caxis, slot_face, build_vertices) and ints. The
    reference's ``variant``, which picks one of its two walk kernels, is
    dropped: one kernel serves both here."""
    return WideBVH(**_accel_kw({k: v for k, v in fields.items() if k != "variant"}))


def treepack_from_numpy(fields: Mapping[str, Any]) -> TreePack:
    """``fields`` holds the ``TreePack`` field names: the tables nodebox,
    ctrl and tris, and the ints leaf_size and num_nodes."""
    return TreePack(**_accel_kw(fields))


def params_from_numpy(fields: Mapping[str, Any], device=None) -> SceneParams:
    """The reference's ``SceneParams`` leaves (field name -> array) as the
    port's, float32 tensors on ``device`` (None: "cuda"); set
    ``requires_grad_()`` on the leaves to optimize."""
    dev = resolve_device(device)
    return SceneParams(**{
        f.name: torch.tensor(np.asarray(fields[f.name], np.float32), device=dev)
        for f in dataclasses.fields(SceneParams)})


def adam_state_from_optax(optimizer: torch.optim.Adam, params: SceneParams, count,
                          mu: Mapping[str, Any], nu: Mapping[str, Any]) -> None:
    """Load optax's ``ScaleByAdamState`` (``count``, and ``mu``/``nu`` as
    field name -> array of the ``SceneParams`` tree) into ``optimizer``'s
    state for each leaf of ``params`` it optimizes: ``step``, ``exp_avg``
    and ``exp_avg_sq``. Both implement the same Adam update."""
    names = {id(getattr(params, f.name)): f.name for f in dataclasses.fields(SceneParams)}
    for group in optimizer.param_groups:
        for p in group["params"]:
            name = names[id(p)]
            optimizer.state[p] = {
                "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
                "exp_avg": torch.tensor(np.asarray(mu[name], np.float32), device=p.device),
                "exp_avg_sq": torch.tensor(np.asarray(nu[name], np.float32), device=p.device),
            }
