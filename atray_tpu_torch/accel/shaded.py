"""Shaded wide BVH (``atray_tpu/accel/shaded.py``): 8-wide node tables plus
leaf records that carry shading data, so the hit kernel returns everything
shading needs with no per-ray gathers.

Leaf record layout, stride 32 floats (4 records per 128-float row):
  0-2  p0     3-5  e1     6-8  e2     9  face id (int32 BITS, not a value)
  10-12 n0    13-15 n1    16-18 n2    (flat normal in all three when the
                                       face has no smooth normals)
  19   material id (exact f32)
  20-22 emission   23-25 albedo   26 scatter   27-31 pad
Pad records have p0 = 1e30 and zero edges (det = 0: they never hit).
Column 9 holds face ids bit-cast into the f32 table: they are denormal
floats, and anything that reads them must go through an int32 view.

The tables are built in host numpy and are array-equal to the reference's
for the same builder backend, so both packages' hit kernels read one input
contract. ``ShadedWideBVH.to(device)`` uploads them once.
``refit_shaded`` recomputes the tables from a moved scene on its device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from atray_tpu_torch.accel.bvh import build_bvh
from atray_tpu_torch.accel.wide import _collapse_wide_np
from atray_tpu_torch.config import KDTreeConfig
from atray_tpu_torch.scene.data import _Leaves, to_numpy

STRIDE32 = 32
RECS_PER_ROW = 128 // STRIDE32   # 4


@dataclasses.dataclass(frozen=True)
class ShadedWideBVH(_Leaves):
    """Wide-BVH tables with shaded stride-32 leaf records.

    ``tboxes`` (ceil(T/8), 128) packs 8 treelet AABBs per row in the
    ``cboxes`` field layout, NaN for pad treelets; only the pair-binned
    traversal reads it (not ported yet), but it is built so the tables stay
    array-equal to the reference's.
    """

    cboxes: np.ndarray   # f32 (W, 128)
    clinks: np.ndarray   # i32 (8, W)
    tris: np.ndarray     # f32 (rows_per_leaf * num_leaves, 128), stride 32
    leaf_size: int
    num_nodes: int
    max_depth: int       # wide depth, root = 1
    caxis: Optional[np.ndarray] = None     # i32 (1, W)
    tboxes: Optional[np.ndarray] = None
    num_treelets: int = 0
    leaves_per_treelet: int = 0
    build_vertices: Optional[np.ndarray] = None

    @property
    def rows_per_leaf(self) -> int:
        return max(1, self.leaf_size // RECS_PER_ROW)

    @property
    def device(self) -> torch.device:
        cb = self.cboxes
        return cb.device if isinstance(cb, torch.Tensor) else torch.device("cpu")


def _treelet_boxes_np(tris: np.ndarray, leaf_size: int, leaves_per_treelet: int):
    """Per-treelet AABBs packed 8 per row: (tboxes, num_treelets). Boxes
    round outward on the f64 -> f32 cast; empty treelets and row-pad lanes
    are NaN, which fails every slab comparison (an inverted box would not)."""
    recs = tris.reshape(-1, STRIDE32)
    p0 = recs[:, 0:3].astype(np.float64)
    e1 = recs[:, 3:6].astype(np.float64)
    e2 = recs[:, 6:9].astype(np.float64)
    real = recs[:, 0] < 1.0e29
    v1, v2 = p0 + e1, p0 + e2
    lo = np.minimum(np.minimum(p0, v1), v2)
    hi = np.maximum(np.maximum(p0, v1), v2)
    lo[~real] = 1.0e30
    hi[~real] = -1.0e30
    tpt = leaves_per_treelet * leaf_size
    n_t = -(-recs.shape[0] // tpt)
    pad = n_t * tpt - recs.shape[0]
    if pad:
        lo = np.concatenate([lo, np.full((pad, 3), 1.0e30)])
        hi = np.concatenate([hi, np.full((pad, 3), -1.0e30)])
    tlo64 = lo.reshape(n_t, tpt, 3).min(axis=1)
    thi64 = hi.reshape(n_t, tpt, 3).max(axis=1)
    tlo = tlo64.astype(np.float32)
    tlo = np.where(tlo.astype(np.float64) > tlo64,
                   np.nextafter(tlo, np.float32(-np.inf)), tlo)
    thi = thi64.astype(np.float32)
    thi = np.where(thi.astype(np.float64) < thi64,
                   np.nextafter(thi, np.float32(np.inf)), thi)
    empty = (tlo64 > thi64).any(axis=1)
    tlo[empty] = np.nan
    thi[empty] = np.nan
    rows = -(-n_t // 8)
    tb = np.zeros((rows, 128), np.float32)
    full_lo = np.concatenate([tlo, np.full((rows * 8 - n_t, 3), np.nan, np.float32)])
    full_hi = np.concatenate([thi, np.full((rows * 8 - n_t, 3), np.nan, np.float32)])
    for ax in range(3):
        tb[:, 8 * ax: 8 * ax + 8] = full_lo[:, ax].reshape(rows, 8)
        tb[:, 24 + 8 * ax: 32 + 8 * ax] = full_hi[:, ax].reshape(rows, 8)
    return tb, n_t


def _face_shading_np(scene):
    """Per-face n0, n1, n2 (flat fallback), material id and the baked
    material constants, as host arrays."""
    v = to_numpy(scene.mesh.vertices).astype(np.float64)
    f = to_numpy(scene.mesh.faces)
    p0 = v[f[:, 0]]
    e1 = v[f[:, 1]] - p0
    e2 = v[f[:, 2]] - p0
    flat = np.cross(e1, e2)
    flat /= np.maximum(np.linalg.norm(flat, axis=1, keepdims=True), 1e-20)
    nidx = to_numpy(scene.mesh.face_normal_idx)
    has = (nidx[:, 0] >= 0)[:, None]
    norms = to_numpy(scene.mesh.normals).astype(np.float64)
    ncl = np.clip(nidx, 0, norms.shape[0] - 1)
    n0 = np.where(has, norms[ncl[:, 0]], flat)
    n1 = np.where(has, norms[ncl[:, 1]], flat)
    n2 = np.where(has, norms[ncl[:, 2]], flat)
    mat = to_numpy(scene.mesh.material_id)
    em = to_numpy(scene.materials.emission).astype(np.float64)[mat]
    al = to_numpy(scene.materials.albedo).astype(np.float64)[mat]
    sc = to_numpy(scene.materials.scatter).astype(np.float64)[mat]
    return n0, n1, n2, mat, em, al, sc


def build_shaded_accel(scene, config: KDTreeConfig = KDTreeConfig(leaf_size=16),
                       backend: str = "auto") -> ShadedWideBVH:
    """Binary SAH build -> stride-32 shaded leaf pack -> 8-wide collapse.
    Host numpy; call ``.to(device)`` on the result to upload it."""
    ls = int(config.leaf_size)
    if ls > RECS_PER_ROW and ls % RECS_PER_ROW != 0:
        raise ValueError(f"leaf_size {ls} must be <=4 or a multiple of 4")
    vertices = to_numpy(scene.mesh.vertices)
    bvh = build_bvh(vertices, to_numpy(scene.mesh.faces), config, backend=backend)

    tp0, te1, te2, tid = bvh.tri_p0, bvh.tri_e1, bvh.tri_e2, bvh.tri_orig_id
    n0, n1, n2, mat, em, al, sc = _face_shading_np(scene)

    slots = tp0.shape[0]
    rows_per_leaf = max(1, ls // RECS_PER_ROW)
    num_leaves = max(1, slots // ls)
    tris = np.zeros((num_leaves * rows_per_leaf, 128), np.float32)
    flat = tris.reshape(-1, STRIDE32)       # one record per row
    flat[:, 0:3] = 1.0e30                   # pad slots never hit
    s = np.arange(slots)
    rec = (s // ls) * (rows_per_leaf * RECS_PER_ROW) + (s % ls)
    flat[rec, 0:3] = tp0
    flat[rec, 3:6] = te1
    flat[rec, 6:9] = te2
    flat[rec, 9] = tid.view(np.float32)
    real = tid >= 0
    t_real = tid[real]
    flat[rec[real], 10:13] = n0[t_real]
    flat[rec[real], 13:16] = n1[t_real]
    flat[rec[real], 16:19] = n2[t_real]
    flat[rec[real], 19] = mat[t_real].astype(np.float32)
    flat[rec[real], 20:23] = em[t_real]
    flat[rec[real], 23:26] = al[t_real]
    flat[rec[real], 26] = sc[t_real]

    cboxes, clinks, caxis, max_depth = _collapse_wide_np(bvh)
    # the collapse counted leaf rows in the 16-float stride (leaf_size // 8
    # rows per leaf); rewrite leaf links for the stride-32 records
    rpl16 = max(1, ls // 8)
    is_leaf = (clinks < 0) & (clinks > -2147483647)
    leaf_idx = (-(clinks + 1)) // rpl16
    clinks = np.where(is_leaf, -(leaf_idx * rows_per_leaf + 1), clinks)

    lpt = max(1, int(config.leaves_per_treelet))
    # pad the records to a whole number of treelets
    pad_leaves = (-num_leaves) % lpt
    if pad_leaves:
        pad_rows = np.zeros((pad_leaves * rows_per_leaf, 128), np.float32)
        pad_rows.reshape(-1, STRIDE32)[:, 0:3] = 1.0e30
        tris = np.concatenate([tris, pad_rows])
    tbox, n_treelets = _treelet_boxes_np(tris, ls, lpt)
    return ShadedWideBVH(
        cboxes=cboxes,
        clinks=clinks.astype(np.int32),
        tris=tris,
        leaf_size=ls,
        num_nodes=cboxes.shape[0],
        max_depth=max_depth,
        caxis=caxis,
        tboxes=tbox,
        num_treelets=n_treelets,
        leaves_per_treelet=lpt,
        build_vertices=np.asarray(vertices, np.float32),
    )


def refit_shaded(accel: ShadedWideBVH, scene) -> ShadedWideBVH:
    """The accel recomputed from the live ``scene`` (on the accel's
    device): every real record's geometry, vertex normals, material id and
    baked constants; the treelet boxes exactly, one float step outward and
    NaN for empty treelets and row pads; the node boxes widened by the
    largest vertex move since the build. Topology stays as built. Face ids
    (column 9, denormal floats) are read and written only through an int32
    view. The outputs are detached: they decide which face a ray hits, and
    the gradient replays the hit from the live scene."""
    if accel.build_vertices is None:
        raise ValueError("accel was built without refit support")
    mesh = scene.mesh
    with torch.no_grad():
        v = mesh.vertices.detach()
        f = mesh.faces.long()
        nf = int(f.shape[0])
        flat_i = accel.tris.view(torch.int32).reshape(-1, STRIDE32)
        fid = flat_i[:, 9]
        ok = fid >= 0
        fcl = torch.clamp(fid.long(), 0, max(nf - 1, 0))
        p0 = v[f[fcl, 0]]
        e1 = v[f[fcl, 1]] - p0
        e2 = v[f[fcl, 2]] - p0
        flat_n = torch.linalg.cross(e1, e2, dim=1)
        flat_n = flat_n / torch.clamp_min(torch.linalg.norm(flat_n, dim=1, keepdim=True), 1e-20)
        nidx = mesh.face_normal_idx.long()[fcl]
        has = (nidx[:, 0] >= 0)[:, None]
        norms = mesh.normals.detach()
        ncl = torch.clamp(nidx, 0, norms.shape[0] - 1)
        n0 = torch.where(has, norms[ncl[:, 0]], flat_n)
        n1 = torch.where(has, norms[ncl[:, 1]], flat_n)
        n2 = torch.where(has, norms[ncl[:, 2]], flat_n)
        mat = mesh.material_id.long()[fcl]
        em = scene.materials.emission.detach()[mat]
        al = scene.materials.albedo.detach()[mat]
        sc = scene.materials.scatter.detach()[mat][:, None]
        okc = ok[:, None]
        geo = torch.where(okc, torch.cat([p0, e1, e2], dim=1), flat_i[:, 0:9].view(torch.float32))
        shade = torch.where(
            okc, torch.cat([n0, n1, n2, mat.to(torch.float32)[:, None], em, al, sc], dim=1),
            flat_i[:, 10:27].contiguous().view(torch.float32))
        tris = torch.cat([
            geo.contiguous().view(torch.int32), flat_i[:, 9:10],
            shade.contiguous().view(torch.int32), flat_i[:, 27:],
        ], dim=1).view(torch.float32).reshape(accel.tris.shape)

        delta = torch.max(torch.abs(v - accel.build_vertices))
        cb = accel.cboxes
        cboxes = torch.cat([cb[:, 0:24] - delta, cb[:, 24:48] + delta, cb[:, 48:]], dim=1)

        tboxes = accel.tboxes
        if accel.num_treelets > 0 and tboxes is not None:
            big = 1.0e30
            lo = torch.where(okc, torch.minimum(torch.minimum(p0, p0 + e1), p0 + e2), big)
            hi = torch.where(okc, torch.maximum(torch.maximum(p0, p0 + e1), p0 + e2), -big)
            tpt = accel.leaves_per_treelet * accel.leaf_size
            n_t = accel.num_treelets
            tlo = lo.reshape(n_t, tpt, 3).min(dim=1).values
            thi = hi.reshape(n_t, tpt, 3).max(dim=1).values
            empty = (tlo > thi).any(dim=1)[:, None]
            inf = torch.tensor(float("inf"), device=v.device)
            tlo = torch.where(empty, float("nan"), torch.nextafter(tlo, -inf))
            thi = torch.where(empty, float("nan"), torch.nextafter(thi, inf))
            rows = tboxes.shape[0]
            pad = torch.full((rows * 8 - n_t, 3), float("nan"), device=v.device)
            tlo = torch.cat([tlo, pad])
            thi = torch.cat([thi, pad])
            cols = [tlo[:, ax].reshape(rows, 8) for ax in range(3)]
            cols += [thi[:, ax].reshape(rows, 8) for ax in range(3)]
            tboxes = torch.cat(cols + [torch.zeros((rows, 128 - 48), device=v.device)], dim=1)
    return dataclasses.replace(accel, tris=tris, cboxes=cboxes, tboxes=tboxes)
