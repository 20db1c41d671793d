"""Treelet (geometry-sharded) rendering: rays ride a ring of ranks
(``atray_tpu/dist/treelet.py``, its forward backends).

The triangle set is partitioned spatially into one treelet per rank; each
rank keeps only its own treelet on its device, while its block of rays
travels around the ring: a hop tests the visiting rays against the resident
treelet, keeps the strictly nearer hits in the carried best record, and
sends rays and record to rank (rank + 1) % n while receiving from (rank - 1)
% n, the reference's ``ppermute`` permutation. After n hops every ray has
met every treelet and is home with its global nearest hit (t, interpolated
normal, material id, face id), where shading runs through
``trace_radiance``'s ``hit_override`` seam exactly as in the replicated
path. NEE's shadow rays ride a second, leaner ring (``occl_override``).

Local queries, as in the reference:

- ``TreeletGeom`` (``build_treelets``): each part's face records, brute
  force by ``core/intersect.py::first_triangle_hit`` (the oracle path);
- ``TreeletAccels`` (``build_treelet_accels``): one shaded wide BVH a part,
  walked by the ``wide_shade`` kernel (``wide_shade_first_hit``) at every
  hop, its baked face ids remapped to global ones;
- the differentiable backends, brute force like ``TreeletGeom``, whose
  record tables are built in the graph from the parameters:
  ``TreeletParts`` (``build_treelet_parts``: the scene stays replicated,
  each rank builds its own part's records from it, ``treelet_records``)
  and ``TreeletShards`` (``build_treelet_shards``: the vertex and normal
  slices are born sharded, rank r holds only part r's, ``shard_records``,
  and its gradients land on them; ``merge_vertex_grads`` and
  ``merge_normal_grads`` reconcile the copies of boundary vertices).
  The discrete ring (which face wins, ``ring_first_fid``) is detached; each
  ray's winning record row then comes home through ``diff_row_pickup``, a
  second ring whose backward is its transpose: the row cotangents ride the
  ring the other way (send to rank - 1) and are added into the owning
  rank's records, staged through pinned host memory under gloo like the
  forward hops. The ray's t, normal and material are replayed from the row
  on the live rays, so gradients reach the vertices also through later
  bounces' origins.

Differences from the reference: one process per rank (the tables are built
on the host of every rank, and each rank uploads only its own part; the
film's gather hands each rank back only its own rays' cotangent, and the
replicated leaves' gradients are summed after ``autograd.grad`` by
``dist.train.reduce_grads``, where the reference's ``jax.grad`` of its one
program returns them summed);
``num_parts`` must equal the ranks. A hop's payload travels as one
float32 buffer (int32 planes as their bits). Gloo's ``send``/``recv`` take
host tensors only: on a CUDA device under gloo (two ranks sharing one card)
each hop stages the buffer through pinned host memory; under NCCL it goes
card to card. Every rank runs every hop of every bounce, whatever its rays'
liveness, so the ranks make the same calls in the same order.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from atray_tpu_torch.accel.shaded import STRIDE32, ShadedWideBVH, build_shaded_accel
from atray_tpu_torch.config import KDTreeConfig, RenderSettings
from atray_tpu_torch.core.camera import Camera, camera_rays
from atray_tpu_torch.core.intersect import (
    INF,
    cross,
    first_triangle_hit,
    moller_trumbore,
    normalize,
)
from atray_tpu_torch.dist import mesh as dmesh
from atray_tpu_torch.kernels import wide_shade
from atray_tpu_torch.render.rng import split
from atray_tpu_torch.render.wavefront import (
    _pad_rays,
    _rows,
    build_face_table,
    clip01,
    from_tile_order,
    resolve_material_rows,
    to_tile_order,
    trace_radiance,
)
from atray_tpu_torch.scene.data import Scene, empty_mesh, to_numpy


@dataclasses.dataclass(frozen=True)
class TreeletGeom:
    """Spatially partitioned, padded triangle records: ``recs`` (P, Tpad,
    20) float32, per part rows in the face-table layout [p0, e1, e2, n0,
    n1, n2, material_id, global face id] (``wavefront.build_face_table``
    with the pad slot carrying the id). Pad rows are zero (their
    determinant is 0, so they never hit) with id -1."""

    recs: np.ndarray

    @property
    def num_parts(self) -> int:
        return self.recs.shape[0]

    def local(self, rank: int, device) -> torch.Tensor:
        """Part ``rank``'s (Tpad, 20) records on ``device``."""
        return torch.as_tensor(np.ascontiguousarray(to_numpy(self.recs)[rank]), device=device)


def partition_faces(vertices: np.ndarray, faces: np.ndarray, n_parts: int):
    """Balanced spatial partition of faces: sort by centroid along the
    longest axis of the centroids' bounding box, split into ``n_parts``
    contiguous chunks (sizes differ by at most 1). Host numpy; a list of
    index arrays, a permutation of arange(T) split into parts."""
    t = faces.shape[0]
    if t == 0:
        return [np.zeros((0,), np.int64) for _ in range(n_parts)]
    cent = vertices[faces].mean(axis=1)
    spread = cent.max(axis=0) - cent.min(axis=0)
    order = np.argsort(cent[:, int(np.argmax(spread))], kind="stable")
    return np.array_split(order, n_parts)


def _check_fid_precision(num_faces: int) -> None:
    """Global face ids ride float32 record slots (column 19), exact only
    below 2^24."""
    if num_faces >= 2 ** 24:
        raise ValueError(
            f"treelet face ids ride f32 record slots, exact only below 2^24; scene has "
            f"{num_faces} faces")


def _host_scene(scene: Scene) -> Scene:
    """The scene's leaves as host numpy."""
    return dataclasses.replace(scene, **{
        part: dataclasses.replace(getattr(scene, part), **{
            f.name: to_numpy(getattr(getattr(scene, part), f.name))
            for f in dataclasses.fields(getattr(scene, part))})
        for part in ("mesh", "spheres", "planes", "materials")})


def build_treelets(scene: Scene, n_parts: int) -> TreeletGeom:
    """Partition the scene's mesh into ``n_parts`` padded record tables
    (host numpy)."""
    if scene.mesh.num_faces == 0:
        raise ValueError("treelet sharding needs a non-empty mesh")
    _check_fid_precision(int(scene.mesh.num_faces))
    host = _host_scene(scene)
    ft = build_face_table(host.to("cpu")).numpy().copy()
    ft[:, 19] = np.arange(ft.shape[0], dtype=np.float32)     # global face id
    parts = partition_faces(host.mesh.vertices, host.mesh.faces, n_parts)
    tpad = max(1, max(len(p) for p in parts))
    recs = np.zeros((n_parts, tpad, 20), np.float32)
    for i, idx in enumerate(parts):
        recs[i, :len(idx)] = ft[idx]
        recs[i, len(idx):, 19] = -1.0
    return TreeletGeom(recs=recs)


@dataclasses.dataclass(frozen=True)
class TreeletParts:
    """The static face partition of the differentiable backend (host
    numpy): ``idx`` (P, Tpad) the face ids of each part, -1 pad; ``owner``
    and ``lrow`` (T,) the owning part of each global face id and its row
    in that part's table (two O(T) maps rather than a dense (P, T) one).
    The record tables are rebuilt from the live scene at every render
    (``treelet_records``), so gradients reach vertices, normals and
    materials. The scene stays replicated on every rank."""

    idx: np.ndarray
    owner: np.ndarray
    lrow: np.ndarray

    @property
    def num_parts(self) -> int:
        return self.idx.shape[0]


def build_treelet_parts(scene: Scene, n_parts: int) -> TreeletParts:
    """The host-side spatial partition (indices only) of the
    differentiable treelet path."""
    _check_fid_precision(int(scene.mesh.num_faces))
    parts = partition_faces(to_numpy(scene.mesh.vertices), to_numpy(scene.mesh.faces), n_parts)
    t = int(scene.mesh.num_faces)
    tpad = max(1, max(len(p) for p in parts))
    idx = np.full((n_parts, tpad), -1, np.int32)
    owner = np.zeros((max(1, t),), np.int32)
    lrow = np.zeros((max(1, t),), np.int32)
    for i, p in enumerate(parts):
        idx[i, :len(p)] = p
        owner[p] = i
        lrow[p] = np.arange(len(p), dtype=np.int32)
    return TreeletParts(idx=idx, owner=owner, lrow=lrow)


def _pad_rows(rows: torch.Tensor, pad: torch.Tensor) -> torch.Tensor:
    """``rows`` (Tpad, 20) with the rows where ``pad`` holds zero and
    face id -1 (a degenerate record, which never hits)."""
    pad_row = torch.zeros(20, dtype=rows.dtype, device=rows.device)
    pad_row[19] = -1.0
    return torch.where(pad[:, None], pad_row, rows)


def _face_records(scene: Scene) -> torch.Tensor:
    """``build_face_table`` of the live scene with the global face id in
    column 19."""
    ft = build_face_table(scene)
    if ft is None:
        raise ValueError("treelet sharding needs a non-empty mesh")
    _check_fid_precision(ft.shape[0])
    ids = torch.arange(ft.shape[0], dtype=ft.dtype, device=ft.device)
    return torch.cat([ft[:, :19], ids[:, None]], dim=1)


def _part_records(ft: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(Tpad, 20) records of one part: the face table's rows ``idx`` (-1
    pad) by ``index_select``, whose backward is an ``index_add_``."""
    safe = torch.clamp(idx, 0, ft.shape[0] - 1).long()
    return _pad_rows(_rows(ft, safe), idx < 0)


def treelet_records(scene: Scene, parts: TreeletParts) -> torch.Tensor:
    """(P, Tpad, 20) record tables built in the graph from the scene (on
    its device): each part's rows of the face table, the global face id in
    column 19, pad rows zero with id -1. A differentiable function of the
    vertices and normals. ``render_treelet`` builds only its rank's part."""
    ft = _face_records(scene)
    idx = torch.as_tensor(parts.idx, device=ft.device)
    return torch.stack([_part_records(ft, idx[p]) for p in range(parts.num_parts)])


@dataclasses.dataclass(frozen=True)
class TreeletShards:
    """Geometry parameters born sharded (host numpy, stacked on a parts
    axis): per part the vertex and normal slices its faces use, its faces
    indexed locally. Rank r takes part r (``local``) and builds its
    records from it alone (``shard_records``), so no rank holds another
    part's vertices or their gradients. Vertices that faces of several
    parts share are copied into each; their gradients arrive per copy, and
    ``merge_vertex_grads``/``merge_normal_grads`` add them into the global
    arrays.

    ``vertices`` (P, Vpad, 3) and ``normals`` (P, Npad, 3) float32;
    ``faces``/``fnidx`` (P, Tpad, 3) local vertex and normal indices (fnidx
    -1: flat shading); ``matid``/``fid`` (P, Tpad) material and global face
    ids (fid -1 pad); ``v_gid``/``n_gid`` (P, Vpad)/(P, Npad) the global id
    of each local slot (-1 pad); ``owner``/``lrow`` (T,) as in
    ``TreeletParts``."""

    vertices: np.ndarray
    normals: np.ndarray
    faces: np.ndarray
    fnidx: np.ndarray
    matid: np.ndarray
    fid: np.ndarray
    v_gid: np.ndarray
    n_gid: np.ndarray
    owner: np.ndarray
    lrow: np.ndarray

    @property
    def num_parts(self) -> int:
        return self.faces.shape[0]

    def local(self, rank: int, device) -> "TreeletShard":
        """Part ``rank``'s slices and the two ownership maps on ``device``;
        set ``requires_grad`` on its ``vertices``/``normals`` to
        differentiate with respect to them."""
        def put(x):
            return torch.as_tensor(np.ascontiguousarray(x), device=device)

        return TreeletShard(
            **{k: put(getattr(self, k)[rank]) for k in
               ("vertices", "normals", "faces", "fnidx", "matid", "fid", "v_gid", "n_gid")},
            owner=put(self.owner), lrow=put(self.lrow), rank=rank, num_parts=self.num_parts)


@dataclasses.dataclass(frozen=True)
class TreeletShard:
    """One rank's part of a ``TreeletShards`` on its device (the fields as
    there, without the parts axis), ``rank`` the part it is."""

    vertices: torch.Tensor
    normals: torch.Tensor
    faces: torch.Tensor
    fnidx: torch.Tensor
    matid: torch.Tensor
    fid: torch.Tensor
    v_gid: torch.Tensor
    n_gid: torch.Tensor
    owner: torch.Tensor
    lrow: torch.Tensor
    rank: int
    num_parts: int


def build_treelet_shards(scene: Scene, n_parts: int) -> TreeletShards:
    """Host build of the sharded parameters: the spatial face partition
    (``partition_faces``), then per part the vertices and normals its faces
    use, sliced out, and the faces indexed locally. Every table is padded
    to the largest part."""
    _check_fid_precision(int(scene.mesh.num_faces))
    m = _host_scene(scene).mesh
    v, nrm, f = m.vertices, m.normals, m.faces
    fn, mid = m.face_normal_idx, m.material_id
    parts = partition_faces(v, f, n_parts)

    loc = []
    for p in parts:
        pf = f[p]
        vu, vinv = np.unique(pf, return_inverse=True)
        lf = vinv.reshape(pf.shape).astype(np.int32)
        pfn = fn[p] if fn.size else np.full((len(p), 3), -1, np.int64)
        used = pfn[pfn >= 0]
        nu = np.unique(used) if used.size else np.zeros((0,), np.int64)
        remap = np.full((nrm.shape[0] + 1,), -1, np.int32)
        remap[nu] = np.arange(len(nu), dtype=np.int32)
        lfn = np.where(pfn >= 0, remap[np.clip(pfn, 0, nrm.shape[0])], -1)
        loc.append((p, vu, lf, nu, lfn.astype(np.int32)))

    vpad = max(1, max(len(x[1]) for x in loc))
    npad = max(1, max(len(x[3]) for x in loc))
    tpad = max(1, max(len(x[0]) for x in loc))
    t = int(scene.mesh.num_faces)
    out = {"vertices": np.zeros((n_parts, vpad, 3), np.float32),
           "normals": np.zeros((n_parts, npad, 3), np.float32),
           "faces": np.zeros((n_parts, tpad, 3), np.int32),
           "fnidx": np.full((n_parts, tpad, 3), -1, np.int32),
           "matid": np.zeros((n_parts, tpad), np.int32),
           "fid": np.full((n_parts, tpad), -1, np.int32),
           "v_gid": np.full((n_parts, vpad), -1, np.int32),
           "n_gid": np.full((n_parts, npad), -1, np.int32),
           "owner": np.zeros((max(1, t),), np.int32),
           "lrow": np.zeros((max(1, t),), np.int32)}
    for i, (p, vu, lf, nu, lfn) in enumerate(loc):
        k = len(p)
        out["vertices"][i, :len(vu)] = v[vu]
        if len(nu):
            out["normals"][i, :len(nu)] = nrm[nu]
        out["faces"][i, :k] = lf
        out["fnidx"][i, :k] = lfn
        out["matid"][i, :k] = mid[p]
        out["fid"][i, :k] = p
        out["v_gid"][i, :len(vu)] = vu
        out["n_gid"][i, :len(nu)] = nu
        out["owner"][p] = i
        out["lrow"][p] = np.arange(k, dtype=np.int32)
    return TreeletShards(**out)


def shard_records(v: torch.Tensor, nrm: torch.Tensor, f: torch.Tensor, fnidx: torch.Tensor,
                  matid: torch.Tensor, fid: torch.Tensor) -> torch.Tensor:
    """(Tpad, 20) record table of one part from its local slices, in the
    layout of ``build_face_table`` with the global face id in column 19:
    the per-part analog of the face table, differentiable with respect to
    ``v`` and ``nrm`` (gathered by ``index_select``)."""
    f = f.long()
    p0 = _rows(v, f[:, 0])
    e1 = _rows(v, f[:, 1]) - p0
    e2 = _rows(v, f[:, 2]) - p0
    flat_n = normalize(cross(e1, e2))
    has_smooth = (fnidx[:, 0] >= 0)[:, None]
    ncl = torch.clamp(fnidx, 0, nrm.shape[0] - 1).long()
    n0, n1, n2 = (torch.where(has_smooth, _rows(nrm, ncl[:, k]), flat_n) for k in range(3))
    recs = torch.cat([p0, e1, e2, n0, n1, n2, matid.to(torch.float32)[:, None],
                      fid.to(torch.float32)[:, None]], dim=1)
    return _pad_rows(recs, fid < 0)


def _merge_copies(gid, g: torch.Tensor, count: int) -> torch.Tensor:
    """Scatter-add per-copy rows ``g`` (P, pad, 3) into a (count, 3) array
    by their global ids ``gid`` (P, pad), -1 pad."""
    gid = torch.as_tensor(gid, device=g.device).reshape(-1)
    flat = g.reshape(-1, 3) * (gid >= 0).to(g.dtype)[:, None]
    safe = torch.clamp(gid, 0, max(count - 1, 0)).long()
    return torch.zeros((count, 3), dtype=g.dtype, device=g.device).index_add_(0, safe, flat)


def merge_vertex_grads(shards: TreeletShards, g_vertices: torch.Tensor,
                       num_vertices: int) -> torch.Tensor:
    """The per-copy vertex gradients (P, Vpad, 3), gathered from the ranks
    in rank order, added into the global (V, 3) array: the copies of a
    boundary vertex sum, as in the replicated path's gradient."""
    return _merge_copies(shards.v_gid, g_vertices, num_vertices)


def merge_normal_grads(shards: TreeletShards, g_normals: torch.Tensor,
                       num_normals: int) -> torch.Tensor:
    """The normals' analog of ``merge_vertex_grads``."""
    return _merge_copies(shards.n_gid, g_normals, num_normals)


@dataclasses.dataclass(frozen=True)
class TreeletAccels:
    """One ``ShadedWideBVH`` a part, padded to common shapes and stacked on
    a leading parts axis (host numpy), with GLOBAL face ids in the leaf
    records. Pad nodes are inverted boxes with empty links, never linked;
    pad records sit at 1e30 with id -1 and never hit."""

    cboxes: np.ndarray   # f32 (P, W, 128)
    clinks: np.ndarray   # i32 (P, 8, W)
    caxis: np.ndarray    # i32 (P, 1, W)
    tris: np.ndarray     # f32 (P, rows, 128), stride-32 shaded records
    leaf_size: int
    num_nodes: int
    max_depth: int

    @property
    def num_parts(self) -> int:
        return self.cboxes.shape[0]

    def local(self, rank: int, device) -> ShadedWideBVH:
        """Part ``rank``'s tables as the ``ShadedWideBVH`` the kernel walks,
        on ``device``."""
        return ShadedWideBVH(
            cboxes=self.cboxes[rank], clinks=self.clinks[rank], tris=self.tris[rank],
            leaf_size=self.leaf_size, num_nodes=self.num_nodes, max_depth=self.max_depth,
            caxis=self.caxis[rank]).to(device)


def build_treelet_accels(scene: Scene, n_parts: int, config: Optional[KDTreeConfig] = None,
                         backend: str = "auto") -> TreeletAccels:
    """Spatially partition the mesh and build one shaded wide BVH a part
    (``build_shaded_accel`` with ``config``, default leaf 16, and the
    builder ``backend``); the tables are padded to the largest part's node
    and record-row counts and the baked face ids remapped to global ones."""
    cfg = config or KDTreeConfig(leaf_size=16)
    host = _host_scene(scene)
    faces = host.mesh.faces
    if faces.shape[0] < n_parts:
        raise ValueError(f"treelet accels need >= {n_parts} faces, got {faces.shape[0]}")
    parts = partition_faces(host.mesh.vertices, faces, n_parts)
    accs = []
    for idx in parts:
        m = host.mesh
        sub = dataclasses.replace(host, mesh=dataclasses.replace(
            m, faces=m.faces[idx], face_normal_idx=m.face_normal_idx[idx],
            face_tex_idx=m.face_tex_idx[idx], material_id=m.material_id[idx]))
        acc = build_shaded_accel(sub, cfg, backend=backend)
        # remap the baked local face ids (column 9, int32 bits) to global ones
        tris = np.array(acc.tris)
        flat = tris.reshape(-1, STRIDE32)
        tid = flat[:, 9].view(np.int32).copy()
        real = tid >= 0
        tid[real] = np.asarray(idx, np.int64)[tid[real]].astype(np.int32)
        flat[:, 9] = tid.view(np.float32)
        accs.append(dataclasses.replace(acc, tris=tris))

    w = max(a.num_nodes for a in accs)
    rows = max(a.tris.shape[0] for a in accs)
    cb = np.zeros((n_parts, w, 128), np.float32)
    for f in range(3):          # pad nodes: inverted boxes
        cb[:, :, 8 * f:8 * f + 8] = 3.0e38
        cb[:, :, 8 * (f + 3):8 * (f + 3) + 8] = -3.0e38
    cl = np.full((n_parts, 8, w), np.int32(-2147483648), np.int32)
    ax = np.zeros((n_parts, 1, w), np.int32)
    tr = np.zeros((n_parts, rows, 128), np.float32)
    tr.reshape(n_parts, -1, STRIDE32)[:, :, 0:3] = 1.0e30      # pad records miss
    tr.reshape(n_parts, -1, STRIDE32)[:, :, 9] = np.array([-1], np.int32).view(np.float32)[0]
    for i, a in enumerate(accs):
        cb[i, :a.num_nodes] = a.cboxes
        cl[i, :, :a.num_nodes] = a.clinks
        ax[i, :, :a.num_nodes] = a.caxis
        tr[i, :a.tris.shape[0]] = a.tris
    return TreeletAccels(cboxes=cb, clinks=cl, caxis=ax, tris=tr, leaf_size=cfg.leaf_size,
                         num_nodes=w, max_depth=max(a.max_depth for a in accs))


# ---------------------------------------------------------------------------
# Local queries against one treelet's records (brute force)
# ---------------------------------------------------------------------------


def _local_first_hit(recs: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """Nearest hit of each ray against one treelet's records: (t, normal
    (R, 3), mat, fid), a miss (INF, 0, 0, -1); the normal is interpolated
    from the record's vertex normals."""
    t, u, v, j = first_triangle_hit(o, d, recs[:, 0:3], recs[:, 3:6], recs[:, 6:9])
    found = j >= 0
    row = _rows(recs, torch.clamp(j, min=0).long())
    w0 = (1.0 - u - v)[:, None]
    n = normalize(w0 * row[:, 9:12] + u[:, None] * row[:, 12:15] + v[:, None] * row[:, 15:18])
    mat = torch.where(found, row[:, 18].to(torch.int32), 0)
    fid = torch.where(found, row[:, 19].to(torch.int32), -1)
    return t, torch.where(found[:, None], n, 0.0), mat, fid


def _local_min_t(recs: torch.Tensor, o: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Nearest-hit distance only (the shadow-ray query) against one
    treelet: (R,)."""
    return first_triangle_hit(o, d, recs[:, 0:3], recs[:, 3:6], recs[:, 6:9])[0]


def _local_first_fid(recs: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """(t, fid) of the nearest hit against one treelet."""
    t, _, _, j = first_triangle_hit(o, d, recs[:, 0:3], recs[:, 3:6], recs[:, 6:9])
    row = _rows(recs, torch.clamp(j, min=0).long())
    return t, torch.where(j >= 0, row[:, 19].to(torch.int32), -1)


# ---------------------------------------------------------------------------
# The ring
# ---------------------------------------------------------------------------


def _bits(x: torch.Tensor) -> torch.Tensor:
    """An int32 plane as the float32 words that carry it."""
    return x.to(torch.int32).contiguous().view(torch.float32)


def _ints(row: torch.Tensor) -> torch.Tensor:
    """The int32 plane a buffer row carries (a view of it)."""
    return row.view(torch.int32)


def _keep_int(buf: torch.Tensor, k: int, upd: torch.Tensor, x: torch.Tensor) -> None:
    """Row ``k`` of the buffer, an int32 plane, takes ``x`` where ``upd``
    (selected as integers, so every bit pattern travels unchanged)."""
    _ints(buf[k]).copy_(torch.where(upd, x.to(torch.int32), _ints(buf[k])))


class _Ring:
    """One rotation a hop of a (W, R) float32 buffer: send to (rank + 1) %
    n, receive from (rank - 1) % n (ranks of the mesh's group, which is the
    world); with ``reverse`` the other way, send to rank - 1 and receive
    from rank + 1 (the transpose, which a backward runs). Under gloo with
    CUDA tensors the buffer is staged through pinned host buffers,
    allocated once a ring (gloo's send/recv take host tensors). ``log``
    gets one dict a hop: the ring's name, its direction (``reverse``), the
    hop, rays, bytes sent, and the seconds of the hop's local work
    (``kernel_s``) and of the rotation (``transfer_s``), each closed by a
    device synchronize; without a log nothing synchronizes."""

    def __init__(self, mesh: dmesh.RayMesh, name: str, log: Optional[List[dict]],
                 reverse: bool = False):
        self.mesh, self.name, self.log, self.reverse = mesh, name, log, reverse
        self.stage = (mesh.group is not None and mesh.device.type == "cuda"
                      and dist.get_backend(mesh.group) == "gloo")
        self.host = None

    def _now(self) -> float:
        if self.log is not None and self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        return time.perf_counter()

    def _rotate(self, buf: torch.Tensor) -> torch.Tensor:
        mesh = self.mesh
        if mesh.group is None or mesh.size == 1:
            return buf
        step = -1 if self.reverse else 1
        nxt, prv = (mesh.rank + step) % mesh.size, (mesh.rank - step) % mesh.size
        if self.stage:
            if self.host is None:
                self.host = [torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
                             for _ in range(2)]
            send, recv = self.host
            send.copy_(buf)
        else:
            send, recv = buf, torch.empty_like(buf)
        ops = [dist.P2POp(dist.isend, send, nxt, mesh.group),
               dist.P2POp(dist.irecv, recv, prv, mesh.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return recv.to(mesh.device) if self.stage else recv

    def run(self, buf: torch.Tensor, hop) -> torch.Tensor:
        """``mesh.size`` hops: ``hop(buf)`` updates the buffer in place,
        then it rotates; a reverse ring rotates first, then calls ``hop``,
        with the hops numbered down. Returns the buffer back home."""
        buf = buf.contiguous()
        n = self.mesh.size
        for i in range(n):
            t0 = self._now()
            if self.reverse:
                buf = self._rotate(buf)
                t1 = self._now()
                hop(buf)
                t2 = self._now()
                kernel_s, transfer_s = t2 - t1, t1 - t0
            else:
                hop(buf)
                t1 = self._now()
                buf = self._rotate(buf)
                t2 = self._now()
                kernel_s, transfer_s = t1 - t0, t2 - t1
            if self.log is not None:
                self.log.append({"ring": self.name, "reverse": self.reverse,
                                 "hop": n - 1 - i if self.reverse else i,
                                 "rays": buf.shape[1], "bytes": buf.numel() * buf.element_size(),
                                 "kernel_s": kernel_s, "transfer_s": transfer_s})
        return buf


def _ray_buffer(orig: torch.Tensor, dirn: torch.Tensor, *rows: torch.Tensor) -> torch.Tensor:
    """(6 + planes, R) float32: the rays' o and d planes, then ``rows``
    ((R,) planes or (k, R) blocks), detached: the rings write their
    buffers in place and view planes of them as int32, and which face a
    ray hits carries no derivative."""
    return torch.cat([orig.detach().t(), dirn.detach().t(),
                      *(r.detach() if r.dim() == 2 else r.detach()[None] for r in rows)]
                     ).contiguous()


def ring_first_hit(recs_local: torch.Tensor, orig: torch.Tensor, dirn: torch.Tensor,
                   mesh: dmesh.RayMesh, hop_log: Optional[List[dict]] = None):
    """Global nearest hit of this rank's rays through ``mesh.size`` hops of
    the brute-force query against each treelet (``recs_local``, this
    rank's (Tpad, 20) records). A hop carries (o, d, t, normal, mat, fid),
    12 words a ray; a strictly nearer hit replaces the carried one, so ties
    keep the earlier treelet in ring order, as in the reference. Returns
    (t, normal (R, 3), mat, hit, fid)."""
    recs_local = recs_local.detach()
    r, dev = orig.shape[0], orig.device
    buf = _ray_buffer(orig, dirn, torch.full((r,), INF, device=dev),
                      torch.zeros((3, r), device=dev), torch.zeros(r, device=dev),
                      _bits(torch.full((r,), -1, dtype=torch.int32, device=dev)))

    def hop(b):
        t, n, mat, fid = _local_first_hit(recs_local, b[0:3].t(), b[3:6].t())
        upd = t < b[6]
        b[6] = torch.where(upd, t, b[6])
        b[7:10] = torch.where(upd[None], n.t(), b[7:10])
        _keep_int(b, 10, upd, mat)
        _keep_int(b, 11, upd, fid)

    buf = _Ring(mesh, "first_hit", hop_log).run(buf, hop)
    fid = _ints(buf[11]).clone()
    return buf[6].clone(), buf[7:10].t().contiguous(), _ints(buf[10]).clone(), fid >= 0, fid


def ring_first_fid(recs_local: torch.Tensor, orig: torch.Tensor, dirn: torch.Tensor,
                   mesh: dmesh.RayMesh, hop_log: Optional[List[dict]] = None):
    """Global (t, fid) through ``mesh.size`` hops, carrying only (o, d, t,
    fid): the discrete ring of the reference's differentiable path."""
    recs_local = recs_local.detach()
    r, dev = orig.shape[0], orig.device
    buf = _ray_buffer(orig, dirn, torch.full((r,), INF, device=dev),
                      _bits(torch.full((r,), -1, dtype=torch.int32, device=dev)))

    def hop(b):
        t, fid = _local_first_fid(recs_local, b[0:3].t(), b[3:6].t())
        upd = t < b[6]
        b[6] = torch.where(upd, t, b[6])
        _keep_int(b, 7, upd, fid)

    buf = _Ring(mesh, "first_fid", hop_log).run(buf, hop)
    return buf[6].clone(), _ints(buf[7]).clone()


def ring_occlusion_t(recs_local: torch.Tensor, orig: torch.Tensor, dirn: torch.Tensor,
                     mesh: dmesh.RayMesh, hop_log: Optional[List[dict]] = None) -> torch.Tensor:
    """Triangle-class nearest t of the shadow rays through ``mesh.size``
    hops (o, d, t: 7 words a ray): the ``occl_override`` of the
    brute-force backend."""
    recs_local = recs_local.detach()
    r, dev = orig.shape[0], orig.device
    buf = _ray_buffer(orig, dirn, torch.full((r,), INF, device=dev))

    def hop(b):
        b[6] = torch.minimum(b[6], _local_min_t(recs_local, b[0:3].t(), b[3:6].t()))

    return _Ring(mesh, "occlusion", hop_log).run(buf, hop)[6].clone()


def ring_first_hit_accel(acc: ShadedWideBVH, orig: torch.Tensor, dirn: torch.Tensor,
                         alive: torch.Tensor, mesh: dmesh.RayMesh,
                         hop_log: Optional[List[dict]] = None):
    """Kernel-backed global nearest hit: at each hop the resident treelet's
    ``wide_shade`` walk (``acc``, this rank's part) answers for the visiting
    rays, dead ones skipped. A hop carries (o, d, alive, t, normal, mat,
    fid), 13 words a ray; the material id rides the ring and its constants
    resolve at home. Returns (t, normal (R, 3), mat, fid)."""
    r, dev = orig.shape[0], orig.device
    buf = _ray_buffer(orig, dirn, alive.to(torch.float32), torch.full((r,), INF, device=dev),
                      torch.zeros((3, r), device=dev), torch.zeros(r, device=dev),
                      _bits(torch.full((r,), -1, dtype=torch.int32, device=dev)))

    def hop(b):
        fo = wide_shade.wide_shade_first_hit(acc, b[0:3].t(), b[3:6].t(), b[6])
        upd = fo["t"] < b[7]
        b[7] = torch.where(upd, fo["t"], b[7])
        b[8:11] = torch.where(upd[None], fo["normal"].t(), b[8:11])
        _keep_int(b, 11, upd, fo["mat"])
        _keep_int(b, 12, upd, fo["id"])

    buf = _Ring(mesh, "first_hit_accel", hop_log).run(buf, hop)
    return (buf[7].clone(), buf[8:11].t().contiguous(), _ints(buf[11]).clone(),
            _ints(buf[12]).clone())


def ring_occlusion_t_accel(acc: ShadedWideBVH, orig: torch.Tensor, dirn: torch.Tensor,
                           live: torch.Tensor, mesh: dmesh.RayMesh,
                           hop_log: Optional[List[dict]] = None) -> torch.Tensor:
    """Shadow-ray companion of ``ring_first_hit_accel``: nearest t only
    (o, d, live, t: 8 words a ray)."""
    r, dev = orig.shape[0], orig.device
    buf = _ray_buffer(orig, dirn, live.to(torch.float32), torch.full((r,), INF, device=dev))

    def hop(b):
        t = wide_shade.wide_shade_first_hit(acc, b[0:3].t(), b[3:6].t(), b[6])["t"]
        b[7] = torch.minimum(b[7], t)

    return _Ring(mesh, "occlusion_accel", hop_log).run(buf, hop)[7].clone()


class _RowPickup(torch.autograd.Function):
    """``diff_row_pickup``'s ring with its transpose as the backward."""

    @staticmethod
    def forward(ctx, recs_local, owner, lrow, fid, mesh, hop_log):
        r, tpad, t = fid.shape[0], recs_local.shape[0], owner.shape[0]
        saved = []

        def hop(b):
            f = _ints(b[0])
            fc = torch.clamp(f, 0, t - 1).long()
            own = (f >= 0) & (torch.index_select(owner, 0, fc) == mesh.rank)
            rows = torch.where(own, torch.index_select(lrow, 0, fc), -1).to(torch.int32)
            saved.append(rows)
            mine = _rows(recs_local, torch.clamp(rows, 0, tpad - 1).long())
            b[1:] = torch.where(own[None], mine.t(), b[1:])

        buf = torch.cat([_bits(fid)[None],
                         torch.zeros((20, r), dtype=recs_local.dtype, device=fid.device)])
        buf = _Ring(mesh, "pickup", hop_log).run(buf, hop)
        ctx.mesh, ctx.hop_log, ctx.tpad = mesh, hop_log, tpad
        ctx.save_for_backward(*saved)
        return buf[1:].t().contiguous()

    @staticmethod
    def backward(ctx, grad):
        saved = list(ctx.saved_tensors)
        d_recs = torch.zeros((ctx.tpad, 20), dtype=grad.dtype, device=grad.device)

        def hop(g):
            rows = saved.pop()
            own = rows >= 0
            d_recs.index_add_(0, torch.clamp(rows, 0, ctx.tpad - 1).long(),
                              torch.where(own[None], g, 0.0).t())
            g.masked_fill_(own[None], 0.0)

        _Ring(ctx.mesh, "pickup", ctx.hop_log, reverse=True).run(
            torch.clone(grad.t(), memory_format=torch.contiguous_format), hop)
        return d_recs, None, None, None, None, None


def diff_row_pickup(recs_local: torch.Tensor, owner: torch.Tensor, lrow: torch.Tensor,
                    fid: torch.Tensor, mesh: dmesh.RayMesh,
                    hop_log: Optional[List[dict]] = None) -> torch.Tensor:
    """Differentiable gather of each home ray's winning record row (R, 20)
    from the rank that owns its face: (fid, row), 21 words a ray, ride the
    ring for ``mesh.size`` hops, and at each hop the resident rank fills
    the rows it owns (``owner[f] == rank``, local row ``lrow[f]`` of its
    ``recs_local`` (Tpad, 20)). Rays with fid < 0 keep a zero row.

    The backward is the transpose: the row cotangents, 20 words a ray, ride
    the ring the other way (rank - 1), hops in reverse, and at each hop the
    lanes the rank filled (saved by the forward, one int32 row index a lane
    and hop) are added into its records' gradient by ``index_add_`` and
    zeroed in the carried buffer. It walks no geometry. Every rank must
    call it, and run its backward, the same number of times."""
    return _RowPickup.apply(recs_local, owner, lrow, fid.detach().to(torch.int32), mesh, hop_log)


def _diff_override(recs: torch.Tensor, owner: torch.Tensor, lrow: torch.Tensor,
                   mesh: dmesh.RayMesh, hop_log: Optional[List[dict]]):
    """The differentiable backends' ``hit_override``: which face wins comes
    from the detached ``ring_first_fid``; t, the normal and the material
    are replayed from the winning row (``diff_row_pickup``) on the live
    rays, so gradients reach the records and the ray origins. A lane whose
    replay misses (a grazing hit decided the other way) is demoted: an INF
    hit would poison the backward."""

    def override(o, d, alive):
        fid = ring_first_fid(recs, o, d, mesh, hop_log)[1]
        row = diff_row_pickup(recs, owner, lrow, fid, mesh, hop_log)
        tt, u, v, _ = moller_trumbore(o, d, row[:, 0:3], row[:, 3:6], row[:, 6:9])
        w0 = (1.0 - u - v)[:, None]
        nrm = normalize(w0 * row[:, 9:12] + u[:, None] * row[:, 12:15]
                        + v[:, None] * row[:, 15:18])
        mat = row[:, 18].detach().to(torch.int32)
        hit = (fid >= 0) & (tt < 1.0e30)
        return (torch.where(hit, tt, INF), torch.where(hit[:, None], nrm, 0.0),
                torch.where(hit, mat, 0), hit)

    return override


def _diff_tables(scene: Scene, treelets, mesh: dmesh.RayMesh):
    """(this rank's records (Tpad, 20), owner, lrow) of a differentiable
    backend on the mesh's device: a ``TreeletParts`` part's rows of the
    live scene's face table, or a ``TreeletShards``'/``TreeletShard``'s
    records from the rank's own slices."""
    dev = mesh.device
    if isinstance(treelets, TreeletParts):
        ft = _face_records(scene.to(dev))
        idx = torch.as_tensor(treelets.idx[mesh.rank], device=dev)
        return (_part_records(ft, idx), torch.as_tensor(treelets.owner, device=dev),
                torch.as_tensor(treelets.lrow, device=dev))
    sh = treelets.local(mesh.rank, dev) if isinstance(treelets, TreeletShards) else treelets
    if sh.rank != mesh.rank:
        raise ValueError(f"part {sh.rank} of the treelet shards given to rank {mesh.rank}")
    return shard_records(sh.vertices, sh.normals, sh.faces, sh.fnidx, sh.matid, sh.fid), \
        sh.owner, sh.lrow


# ---------------------------------------------------------------------------
# The render
# ---------------------------------------------------------------------------


def render_treelet(scene: Scene, camera: Camera, settings: RenderSettings, key,
                   mesh: dmesh.RayMesh, treelets=None, axis_name: str = "rays",
                   return_stats: bool = False, hop_log: Optional[List[dict]] = None):
    """Geometry-sharded render -> (H, W, 3) film on every rank.

    Mirrors ``wavefront.render`` (tile-ordered rays padded to a multiple of
    the ranks, each rank tracing its contiguous slice, spp average, clamp)
    but shards the TRIANGLES over the ranks instead of replicating them:
    each bounce's nearest hit is a ring through ``trace_radiance``'s
    ``hit_override`` seam, so shading, random numbers, compaction and the
    rays-cast counter are the replicated path's code. Spheres, planes and
    materials are replicated. ``settings.ray_chunk`` is ignored (a rank
    holds its whole slice). NEE's shadow rays take a second ring.

    Lights under treelets: the traced scene is lean (its mesh empty, the
    triangles live in the rings), so NEE finds no emissive triangle and
    samples only sphere lights, as the reference does.

    ``treelets``: a ``TreeletAccels`` (``build_treelet_accels``) runs each
    hop through the ``wide_shade`` kernel on the resident part; a
    ``TreeletGeom`` or None (``build_treelets``) brute-forces the part's
    records; a ``TreeletParts`` (``build_treelet_parts``) builds this
    rank's records from the live scene and is differentiable with respect
    to its leaves; a ``TreeletShards`` (``build_treelet_shards``, the rank
    takes its part) or this rank's ``TreeletShard`` builds them from the
    part's own slices, differentiable with respect to the shard's vertices
    and normals. The film's gather hands each rank back its own rays'
    cotangent: sum the replicated leaves' gradients over the ranks
    (``dist.train.reduce_grads``); a shard's leaves hold their whole
    gradient. ``hop_log`` (a list) gets every hop's rays, bytes and seconds
    (``_Ring``), the backward's pickup hops too. With ``return_stats`` also
    returns ``{"rays_cast", "rays_cast_per_shard"}``."""
    n_dev = mesh.size
    if treelets is None:
        treelets = build_treelets(scene, n_dev)
    if not isinstance(treelets, (TreeletGeom, TreeletAccels, TreeletParts, TreeletShards,
                                 TreeletShard)):
        raise TypeError(f"unknown treelet backend {type(treelets).__name__}")
    if treelets.num_parts != n_dev:
        raise ValueError(f"treelets built for {treelets.num_parts} parts, mesh has {n_dev}")
    dmesh.check_axis(mesh, axis_name)
    dev = mesh.device
    w, h = settings.resolution
    spp = settings.samples_per_pixel
    aa_key, bounce_key = split(np.asarray(key, np.uint32))
    orig, dirn = camera_rays(camera, w, h, spp, device=dev,
                             anti_aliasing=settings.anti_aliasing,
                             key=aa_key if settings.anti_aliasing else None)
    orig = to_tile_order(orig, w, h, spp)
    dirn = to_tile_order(dirn, w, h, spp)
    n = orig.shape[0]
    ray_ids = torch.arange(n, dtype=torch.int32, device=dev)
    orig, dirn, ray_ids, _ = _pad_rays(orig, dirn, ray_ids, None, (-n) % n_dev)
    part = dmesh.shard_slice(orig.shape[0], mesh)

    lean = dataclasses.replace(scene, mesh=empty_mesh()).to(dev)
    if isinstance(treelets, TreeletAccels):
        acc = treelets.local(mesh.rank, dev)

        def override(o, d, alive):
            t, nrm, mat, fid = ring_first_hit_accel(acc, o, d, alive, mesh, hop_log)
            hit = fid >= 0
            em, al, sc = resolve_material_rows(lean, mat, hit)
            return t, nrm, em, al, sc, hit

        def occl(o, d, live):
            return ring_occlusion_t_accel(acc, o, d, live, mesh, hop_log)
    else:
        if isinstance(treelets, TreeletGeom):
            recs = treelets.local(mesh.rank, dev)

            def override(o, d, alive):
                return ring_first_hit(recs, o, d, mesh, hop_log)[:4]
        else:
            recs, owner, lrow = _diff_tables(scene, treelets, mesh)
            override = _diff_override(recs, owner, lrow, mesh, hop_log)

        def occl(o, d, live):
            return ring_occlusion_t(recs, o, d, mesh, hop_log)

    color, stats = trace_radiance(
        lean, orig[part], dirn[part], settings.bounce_limit, key=bounce_key,
        sort_rays=settings.sort_bounces, nee=settings.nee, return_stats=True,
        ray_ids=ray_ids[part], hit_override=override, occl_override=occl)
    color = dmesh.gather_rows_grad(color, mesh)[:n]
    rc_shards = dmesh.gather_rows(stats["rays_cast"].reshape(1), mesh)
    color = from_tile_order(color, w, h, spp)
    film = clip01(color.reshape(spp, h, w, 3).mean(dim=0))
    if return_stats:
        return film, {"rays_cast": rc_shards.sum(), "rays_cast_per_shard": rc_shards}
    return film
