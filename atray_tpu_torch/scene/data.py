"""Scene representation: plain dataclasses of struct-of-arrays leaves
(``atray_tpu/scene/data.py``).

Leaves are host numpy arrays while a scene is authored and built; one call
to ``Scene.to(device)`` turns every leaf into a tensor on that device.
Conventions are the reference's: material 0 is the sky (rays that miss
pick up ``weight * emission[0]``); ``face_normal_idx`` rows of -1 select
flat shading; empty primitive classes have zero-length leading axes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


def _f32(x):
    return np.asarray(x, np.float32)


def _i32(x):
    return np.asarray(x, np.int32)


def to_numpy(x) -> np.ndarray:
    """Host numpy view of a leaf that may already be a tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _leaf_to(x, device):
    if x is None:
        return None
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.array(x, order="C")).to(device)


class _Leaves:
    """``.to(device)`` for a dataclass whose fields are array leaves or
    nested ``_Leaves``; non-array fields (ints) are kept as they are."""

    def to(self, device):
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, _Leaves):
                kw[f.name] = v.to(device)
            elif isinstance(v, (np.ndarray, torch.Tensor)):
                kw[f.name] = _leaf_to(v, device)
            else:
                kw[f.name] = v
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class Materials(_Leaves):
    """(M,) materials: emission, albedo, and scatter (0 diffuse, 1 mirror)."""

    emission: np.ndarray  # (M, 3) f32
    albedo: np.ndarray    # (M, 3) f32
    scatter: np.ndarray   # (M,) f32

    @property
    def count(self) -> int:
        return self.emission.shape[0]


@dataclasses.dataclass(frozen=True)
class TriMesh(_Leaves):
    """A triangle mesh in SoA form."""

    vertices: np.ndarray         # (V, 3) f32
    faces: np.ndarray            # (T, 3) i32 vertex indices
    normals: np.ndarray          # (N, 3) f32; N >= 1
    face_normal_idx: np.ndarray  # (T, 3) i32 into normals, or -1 = flat
    tex_coords: np.ndarray       # (C, 2) f32; C >= 1
    face_tex_idx: np.ndarray     # (T, 3) i32 into tex_coords, or -1
    material_id: np.ndarray      # (T,) i32

    @property
    def num_faces(self) -> int:
        return self.faces.shape[0]

    @property
    def num_vertices(self) -> int:
        return self.vertices.shape[0]


@dataclasses.dataclass(frozen=True)
class Spheres(_Leaves):
    centers: np.ndarray      # (S, 3) f32
    radii: np.ndarray        # (S,) f32
    material_id: np.ndarray  # (S,) i32

    @property
    def count(self) -> int:
        return self.centers.shape[0]


@dataclasses.dataclass(frozen=True)
class Planes(_Leaves):
    """Infinite planes: dot(normal, x) = offset."""

    normals: np.ndarray      # (P, 3) f32 unit
    offsets: np.ndarray      # (P,) f32
    material_id: np.ndarray  # (P,) i32

    @property
    def count(self) -> int:
        return self.normals.shape[0]


@dataclasses.dataclass(frozen=True)
class Scene(_Leaves):
    """The render-facing scene. ``texture`` is carried for parity with the
    reference but textured rendering is not ported yet."""

    mesh: TriMesh
    spheres: Spheres
    planes: Planes
    materials: Materials
    texture: Optional[np.ndarray] = None

    @property
    def device(self) -> torch.device:
        """Device of the scene's leaves (the CPU while they are numpy)."""
        em = self.materials.emission
        return em.device if isinstance(em, torch.Tensor) else torch.device("cpu")


def make_materials(rows: Sequence[Tuple]) -> Materials:
    """rows: sequence of (emission_rgb, albedo_rgb, scatter). Row 0 = sky."""
    return Materials(
        emission=_f32([r[0] for r in rows]),
        albedo=_f32([r[1] for r in rows]),
        scatter=_f32([r[2] for r in rows]),
    )


def empty_mesh() -> TriMesh:
    return TriMesh(
        vertices=_f32(np.zeros((0, 3))),
        faces=_i32(np.zeros((0, 3))),
        normals=_f32(np.zeros((1, 3))),
        face_normal_idx=_i32(np.zeros((0, 3))),
        tex_coords=_f32(np.zeros((1, 2))),
        face_tex_idx=_i32(np.zeros((0, 3))),
        material_id=_i32(np.zeros((0,))),
    )


def empty_spheres() -> Spheres:
    return Spheres(
        centers=_f32(np.zeros((0, 3))),
        radii=_f32(np.zeros((0,))),
        material_id=_i32(np.zeros((0,))),
    )


def empty_planes() -> Planes:
    return Planes(
        normals=_f32(np.zeros((0, 3))),
        offsets=_f32(np.zeros((0,))),
        material_id=_i32(np.zeros((0,))),
    )


def merge_meshes(meshes: Sequence[TriMesh]) -> TriMesh:
    """Fuse authored meshes into one triangle soup with shifted indices."""
    if not meshes:
        return empty_mesh()
    if len(meshes) == 1:
        return meshes[0]
    v_off = n_off = c_off = 0
    verts, faces, norms, fnidx, texs, ftidx, mids = [], [], [], [], [], [], []
    for m in meshes:
        verts.append(np.asarray(m.vertices))
        faces.append(np.asarray(m.faces) + v_off)
        norms.append(np.asarray(m.normals))
        fn = np.asarray(m.face_normal_idx)
        fnidx.append(np.where(fn >= 0, fn + n_off, -1))
        texs.append(np.asarray(m.tex_coords))
        ft = np.asarray(m.face_tex_idx)
        ftidx.append(np.where(ft >= 0, ft + c_off, -1))
        mids.append(np.asarray(m.material_id))
        v_off += m.vertices.shape[0]
        n_off += m.normals.shape[0]
        c_off += m.tex_coords.shape[0]
    return TriMesh(
        vertices=_f32(np.concatenate(verts)),
        faces=_i32(np.concatenate(faces)),
        normals=_f32(np.concatenate(norms)),
        face_normal_idx=_i32(np.concatenate(fnidx)),
        tex_coords=_f32(np.concatenate(texs)),
        face_tex_idx=_i32(np.concatenate(ftidx)),
        material_id=_i32(np.concatenate(mids)),
    )


def build_scene(
    meshes: Sequence[TriMesh] = (),
    spheres: Optional[Spheres] = None,
    planes: Optional[Planes] = None,
    materials: Optional[Materials] = None,
    texture=None,
) -> Scene:
    if materials is None:
        # minimal default: black sky + one grey diffuse material
        materials = make_materials(
            [((0.0, 0.0, 0.0), (0.0, 0.0, 0.0), 0.0),
             ((0.0, 0.0, 0.0), (0.7, 0.7, 0.7), 0.0)]
        )
    return Scene(
        mesh=merge_meshes(list(meshes)),
        spheres=spheres if spheres is not None else empty_spheres(),
        planes=planes if planes is not None else empty_planes(),
        materials=materials,
        texture=None if texture is None else _f32(texture),
    )
