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

Two local queries, as in the reference:

- ``TreeletGeom`` (``build_treelets``): each part's face records, brute
  force by ``core/intersect.py::first_triangle_hit`` (the oracle path);
- ``TreeletAccels`` (``build_treelet_accels``): one shaded wide BVH a part,
  walked by the ``wide_shade`` kernel (``wide_shade_first_hit``) at every
  hop, its baked face ids remapped to global ones.

The reference's differentiable backends, ``TreeletParts`` and
``TreeletShards``, are ``ROADMAP.md`` queue 1 item 3b; ``render_treelet``
raises ``NotImplementedError`` for them.

Differences from the reference: one process per rank (the tables are built
on the host of every rank, and each rank uploads only its own part);
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
from atray_tpu_torch.core.intersect import INF, first_triangle_hit, normalize
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

_NEXT_ITEM = "ROADMAP.md queue 1 item 3b"


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
    world). Under gloo with CUDA tensors the buffer is staged through pinned
    host buffers, allocated once a ring (gloo's send/recv take host
    tensors). ``log`` gets one dict a hop: the ring's name, the hop, rays,
    bytes sent, and the seconds of the hop's local query with its merge
    (``kernel_s``) and of the rotation (``transfer_s``), each closed by a
    device synchronize; without a log nothing synchronizes."""

    def __init__(self, mesh: dmesh.RayMesh, name: str, log: Optional[List[dict]]):
        self.mesh, self.name, self.log = mesh, name, log
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
        nxt, prv = (mesh.rank + 1) % mesh.size, (mesh.rank - 1) % mesh.size
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
        then it rotates. Returns the buffer back home."""
        buf = buf.contiguous()
        for i in range(self.mesh.size):
            t0 = self._now()
            hop(buf)
            t1 = self._now()
            buf = self._rotate(buf)
            t2 = self._now()
            if self.log is not None:
                self.log.append({"ring": self.name, "hop": i, "rays": buf.shape[1],
                                 "bytes": buf.numel() * buf.element_size(),
                                 "kernel_s": t1 - t0, "transfer_s": t2 - t1})
        return buf


def _ray_buffer(orig: torch.Tensor, dirn: torch.Tensor, *rows: torch.Tensor) -> torch.Tensor:
    """(6 + planes, R) float32: the rays' o and d planes, then ``rows``
    ((R,) planes or (k, R) blocks)."""
    return torch.cat([orig.t(), dirn.t(), *(r if r.dim() == 2 else r[None] for r in rows)]
                     ).contiguous()


def ring_first_hit(recs_local: torch.Tensor, orig: torch.Tensor, dirn: torch.Tensor,
                   mesh: dmesh.RayMesh, hop_log: Optional[List[dict]] = None):
    """Global nearest hit of this rank's rays through ``mesh.size`` hops of
    the brute-force query against each treelet (``recs_local``, this
    rank's (Tpad, 20) records). A hop carries (o, d, t, normal, mat, fid),
    12 words a ray; a strictly nearer hit replaces the carried one, so ties
    keep the earlier treelet in ring order, as in the reference. Returns
    (t, normal (R, 3), mat, hit, fid)."""
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


# ---------------------------------------------------------------------------
# The render
# ---------------------------------------------------------------------------


def render_treelet(scene: Scene, camera: Camera, settings: RenderSettings, key,
                   mesh: dmesh.RayMesh, treelets=None, axis_name: str = "rays",
                   return_stats: bool = False, hop_log: Optional[List[dict]] = None):
    """Geometry-sharded forward render -> (H, W, 3) film on every rank.

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
    records. The differentiable backends raise ``NotImplementedError``
    (``ROADMAP.md`` queue 1 item 3b). ``hop_log`` (a list) gets every hop's
    rays, bytes and seconds (``_Ring``). With ``return_stats`` also returns
    ``{"rays_cast", "rays_cast_per_shard"}``."""
    n_dev = mesh.size
    if treelets is None:
        treelets = build_treelets(scene, n_dev)
    if not isinstance(treelets, (TreeletGeom, TreeletAccels)):
        raise NotImplementedError(
            f"the {type(treelets).__name__} treelet backend (the differentiable ones, "
            f"TreeletParts and TreeletShards) is {_NEXT_ITEM}")
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
        recs = treelets.local(mesh.rank, dev)

        def override(o, d, alive):
            return ring_first_hit(recs, o, d, mesh, hop_log)[:4]

        def occl(o, d, live):
            return ring_occlusion_t(recs, o, d, mesh, hop_log)

    color, stats = trace_radiance(
        lean, orig[part], dirn[part], settings.bounce_limit, key=bounce_key,
        sort_rays=settings.sort_bounces, nee=settings.nee, return_stats=True,
        ray_ids=ray_ids[part], hit_override=override, occl_override=occl)
    color = dmesh.gather_rows(color, mesh)[:n]
    rc_shards = dmesh.gather_rows(stats["rays_cast"].reshape(1), mesh)
    color = from_tile_order(color, w, h, spp)
    film = clip01(color.reshape(spp, h, w, 3).mean(dim=0))
    if return_stats:
        return film, {"rays_cast": rc_shards.sum(), "rays_cast_per_shard": rc_shards}
    return film
