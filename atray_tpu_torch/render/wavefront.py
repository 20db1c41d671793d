"""Wavefront path tracer with path-replay gradients
(``atray_tpu/render/wavefront.py``).

All rays of a chunk advance together through the bounces: nearest hit,
sphere and plane patch-in, shading, respawn. Every per-ray quantity is a
flat (R,) plane, as in the reference. Every random number is a pure
function of (key, global ray id, bounce) (``render/rng.py``), so chunked,
compacted and whole-frame renders give the same film bit-for-bit.

Two hit paths, chosen by the accel and the scene:

- ``ShadedWideBVH`` on an untextured scene (the production path):
  ``wide_shade`` returns t, face id, the interpolated normal and the
  material id in one kernel call. The call is a ``torch.autograd.Function``
  whose backward replays Möller–Trumbore and the normal from the saved face
  id and the per-trace face table in plain PyTorch, so the backward never
  walks the BVH again. With ``pair_bounces`` the bounces after the first
  take the same data from ``treelet_pair_hit`` (the pair-binned traversal)
  instead; the camera bounce keeps ``wide_shade``, and the backward is the
  same replay.
- The gather path: ``nearest_hit_ids`` walks a ``ShadedWideBVH`` with
  ``wide_shade`` (its ``t`` and ``id`` planes), a ``WideBVH``
  (``make_accel``, the trainer's accel) with ``wide_exact``, a ``TreePack``
  with ``ppacket`` and a binary ``BVH`` with the plain ``bvh_first_hit``
  for integer hit ids, or with no accel tests every triangle
  (``first_triangle_hit``, plain PyTorch as in the reference), and the
  differentiable ``resolve_hit`` recomputes the hit from them. The ids are
  what each bounce keeps for the backward. A ``HybridAccel`` walks its
  ``wide`` half for the camera bounce and its ``pack`` half for the later
  ones.

A textured scene (``Scene.texture``, with a mesh) takes the gather path
whatever the accel, as in the reference: the kernel bakes no tex coords.
Its albedo is modulated by the texel at the hit's interpolated UV
(``_texture_mod_soa``: nearest texel, wrap addressing, one ``index_select``
row gather whose index is detached), so the gradient reaches the texels;
``pair_bounces`` is ignored there.

Next-event estimation (``nee``): at every live hit one light is picked
uniformly from the spheres and the emissive triangles (area lights, found
on the concrete scene by ``_static_tri_lights``), a point on it is
sampled, and a shadow ray adds the light's share when nothing else blocks
it; hit emission then counts only on the camera bounce. The shadow rays
take the accel's own query: ``wide_shade`` (its ``t`` plane) for a
``ShadedWideBVH``, ``nearest_hit_ids`` for the gather accels.

Gradients follow the detached-visibility convention: which primitive a ray
hits, and whether a shadow ray is blocked, carry no derivative; t,
barycentrics, normals, material constants and the light sample do, down to
vertices, vertex normals, emission, albedo, scatter and texels. When autograd
records the trace, each bounce's shading runs under
``torch.utils.checkpoint`` with the hit call outside it; the occlusion
test runs once, in its forward, and keeps its bool plane: the backward
recomputes the cheap elementwise shading and reuses the saved hit and the
kept occlusion, so it walks no BVH.

Schedule (the reference's production one): bounce 0, then the first
diffuse bounce at full width, then ONE compaction (``compact_state``: rows
sorted by origin cell with dead rays last, then live rays packed to a lane
prefix by the lane-take kernel, whose VJP is the lane-scatter kernel), then
the remaining bounces. Python loops take the place of ``lax.scan`` and
``lax.map``.

Shading convention (shared with the reference and its oracle):
- miss -> color += weight * emission[0] (sky), the path ends;
- hit  -> attenuation = dot(-d, n), 0 if the normal had to be flipped;
  color += weight * emission[m]; weight *= albedo[m] * attenuation; the
  next direction blends a jittered diffuse and a mirror bounce by scatter.

Explicit uniforms (``uniforms=``, (B, R, 3 or 6) from
``rng.draw_bounce_uniforms``) replace the keyed draw for oracle
comparisons: each bounce reads the row of the ray's global id, so they
give the keyed film when drawn from the same key.

``render(progress_cb=)`` calls the callback once per ray chunk with the
chunk's rays cast, on the chunked branch only, as the reference does.
``render(mesh=)`` shards the rays over the ranks of a ``dist.mesh.RayMesh``:
each rank traces its contiguous slice of the padded frame and the colours
are gathered on every rank, bit-equal to the one-rank film.
``trace_radiance(hit_override=, occl_override=)`` replace the
triangle-class nearest hit and the shadow rays' nearest t by the caller's
query (the treelet rings of ``dist/treelet.py``). The reference's TPU
schedule switches (``ATRAY_*`` environment variables) are not carried:
they select film-identical variants.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from atray_tpu_torch.accel.bvh import BVH
from atray_tpu_torch.accel.pack import TreePack
from atray_tpu_torch.accel.shaded import ShadedWideBVH
from atray_tpu_torch.accel.traverse import bvh_first_hit
from atray_tpu_torch.accel.wide import HybridAccel, WideBVH
from atray_tpu_torch.config import RenderSettings
from atray_tpu_torch.core.camera import Camera, camera_rays
from atray_tpu_torch.core.intersect import (
    INF,
    cross,
    dot,
    first_triangle_hit,
    moller_trumbore,
    normalize,
    plane_hits,
    sphere_hits,
)
from atray_tpu_torch.device import resolve_device
from atray_tpu_torch.kernels.lane_pack import (
    lane_take,
    lane_take_p,
    pack_indices,
    unpack_indices,
)
from atray_tpu_torch.kernels.persistent_packet import ppacket_first_hit
from atray_tpu_torch.kernels.treelet_pairs import treelet_pair_hit
from atray_tpu_torch.kernels.wide_exact import wide_exact_first_hit
from atray_tpu_torch.kernels.wide_shade import wide_shade_planes
from atray_tpu_torch.render.rng import ray_uniform_cols, split
from atray_tpu_torch.scene.data import Scene, to_numpy

# primitive type codes of a hit record (the reference's)
PRIM_NONE = 0
PRIM_TRI = 1
PRIM_SPHERE = 2
PRIM_PLANE = 3

# accels whose bounces take the gather path (integer ids + resolve_hit)
_GATHER_ACCELS = (WideBVH, TreePack, BVH)


class WaveState(NamedTuple):
    """Per-ray wavefront state: origin, direction, path weight, radiance,
    liveness, global ray id (int32), and the running count of rays cast."""

    ox: torch.Tensor
    oy: torch.Tensor
    oz: torch.Tensor
    dx: torch.Tensor
    dy: torch.Tensor
    dz: torch.Tensor
    wr: torch.Tensor
    wg: torch.Tensor
    wb: torch.Tensor
    cr: torch.Tensor
    cg: torch.Tensor
    cb: torch.Tensor
    alive: torch.Tensor
    gid: torch.Tensor
    rc: torch.Tensor


class HitIds(NamedTuple):
    """Discrete outcome of a nearest-hit query (all detached)."""

    prim_type: torch.Tensor  # (R,) int32 in {NONE, TRI, SPHERE, PLANE}
    prim_id: torch.Tensor    # (R,) int32 index within its class, -1 if none
    t: torch.Tensor          # (R,) f32, INF on a miss


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` along dim 0 through ``index_select``, whose backward
    is an ``index_add_``; the backward of ``table[idx]`` sorts the indices
    first and took about 130 ms per call on the gradient config's
    2,073,600 rows (``chip_smoke.py`` phase 8 profile, H100)."""
    return torch.index_select(table, 0, idx)


def build_face_table(scene: Scene) -> Optional[torch.Tensor]:
    """(T, 20) per-face table [p0, e1, e2, n0, n1, n2, material_id, pad];
    faces without smooth normals get the flat normal in all three slots.
    Built once per trace from the live scene, so gradients of the hit
    replay and of ``resolve_hit`` reach vertices and vertex normals."""
    mesh = scene.mesh
    if mesh.num_faces == 0:
        return None
    v = mesh.vertices
    f = mesh.faces.long()
    p0 = _rows(v, f[:, 0])
    e1 = _rows(v, f[:, 1]) - p0
    e2 = _rows(v, f[:, 2]) - p0
    flat_n = normalize(cross(e1, e2))
    nidx = mesh.face_normal_idx.long()
    has_smooth = (nidx[:, 0] >= 0)[:, None]
    ncl = torch.clamp(nidx, 0, mesh.normals.shape[0] - 1)
    n0 = torch.where(has_smooth, _rows(mesh.normals, ncl[:, 0]), flat_n)
    n1 = torch.where(has_smooth, _rows(mesh.normals, ncl[:, 1]), flat_n)
    n2 = torch.where(has_smooth, _rows(mesh.normals, ncl[:, 2]), flat_n)
    mat = mesh.material_id.to(torch.float32)[:, None]
    return torch.cat([p0, e1, e2, n0, n1, n2, mat, torch.zeros_like(mat)], dim=1)


def build_face_uv(scene: Scene) -> Optional[torch.Tensor]:
    """(T, 8) per-face texture coordinates [u0, v0, u1, v1, u2, v2, has_uv,
    pad], built once per trace like ``build_face_table``; faces without tex
    coords get has_uv = 0."""
    mesh = scene.mesh
    if mesh.num_faces == 0:
        return None
    ft = mesh.face_tex_idx.long()
    has = (ft[:, 0] >= 0).to(torch.float32)[:, None]
    tcl = torch.clamp(ft, 0, mesh.tex_coords.shape[0] - 1)
    tc = mesh.tex_coords
    uv = torch.cat([_rows(tc, tcl[:, 0]), _rows(tc, tcl[:, 1]), _rows(tc, tcl[:, 2])], dim=1)
    return torch.cat([uv, has, torch.zeros_like(has)], dim=1)


def _mod1(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mod(x, 1.0)``: the truncated remainder, plus 1 where it is
    negative (``torch.remainder`` rounds differently near the edges, which
    can move a texel one column over)."""
    r = torch.fmod(x, 1.0)
    return torch.where(r < 0.0, r + 1.0, r)


def _texture_mod_soa(texture, face_table, face_uv, fid, tri_hit, ox, oy, oz, dx, dy, dz):
    """Per-ray albedo modulation planes (tr, tg, tb): the texel at the
    hit's interpolated UV, nearest texel, wrap addressing, v = 0 the
    image's bottom row; 1.0 where the ray is not a triangle hit or its face
    has no tex coords. The barycentrics are recomputed with the reference's
    op order; the texel index is detached, so the gradient reaches the
    texels through one ``index_select`` row gather."""
    fcl = torch.clamp(fid, 0, face_table.shape[0] - 1).long()
    uu, vv, _, _ = _barycentrics(_rows(face_table, fcl), ox, oy, oz, dx, dy, dz)
    w0 = 1.0 - uu - vv
    uvrow = _rows(face_uv, fcl)
    ut = w0 * uvrow[:, 0] + uu * uvrow[:, 2] + vv * uvrow[:, 4]
    vt = w0 * uvrow[:, 1] + uu * uvrow[:, 3] + vv * uvrow[:, 5]
    th, tw = texture.shape[0], texture.shape[1]
    ix = torch.clamp((_mod1(ut) * tw).to(torch.int32), 0, tw - 1)
    iy = torch.clamp(((1.0 - _mod1(vt)) * th).to(torch.int32), 0, th - 1)
    idx = (iy * tw + ix).detach().long()
    texel = _rows(texture.reshape(-1, 3), idx)            # one (R, 3) row gather
    use = tri_hit & (uvrow[:, 6] > 0.5)
    return tuple(torch.where(use, texel[:, k], 1.0) for k in range(3))


def _norm3(x, y, z, eps: float = 1.0e-20):
    """Component normalize with the reference's op order."""
    r = torch.reciprocal(torch.sqrt(torch.clamp_min(x * x + y * y + z * z, eps)))
    return x * r, y * r, z * r


def _bounce_dir_soa(dx, dy, dz, nx, ny, nz, scatter, u0, u1, u2):
    """Next direction: lerp(normalize(n + jitter), mirror(d, n), scatter)."""
    rx, ry, rz = _norm3(nx + u0, ny + u1, nz + u2)
    dn = dx * nx + dy * ny + dz * nz
    px = dx - 2.0 * dn * nx
    py = dy - 2.0 * dn * ny
    pz = dz - 2.0 * dn * nz
    return _norm3(rx + (px - rx) * scatter, ry + (py - ry) * scatter,
                  rz + (pz - rz) * scatter)


def _sphere_hits_soa(ox, oy, oz, dx, dy, dz, centers, radii):
    """Nearest sphere per ray over the (tiny) sphere table: (t, sid), with
    t = INF and sid = -1 on a miss."""
    best_t = torch.full_like(ox, INF)
    best_id = torch.full(ox.shape, -1, dtype=torch.int32, device=ox.device)
    for p in range(centers.shape[0]):
        ocx = ox - centers[p, 0]
        ocy = oy - centers[p, 1]
        ocz = oz - centers[p, 2]
        b = ocx * dx + ocy * dy + ocz * dz
        csq = ocx * ocx + ocy * ocy + ocz * ocz - radii[p] * radii[p]
        disc = b * b - csq
        pos = disc > 0.0
        sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
        t0 = -b - sq
        t1 = -b + sq
        ts = torch.where(t0 > 1.0e-4, t0, torch.where(t1 > 1.0e-4, t1, INF))
        ts = torch.where(pos, ts, INF)
        closer = ts < best_t
        best_t = torch.where(closer, ts, best_t)
        best_id = torch.where(closer, p, best_id)
    return best_t, best_id


def _plane_hits_soa(ox, oy, oz, dx, dy, dz, normals, offsets):
    """Nearest plane per ray (plane: dot(n, x) = offset): (t, pid)."""
    best_t = torch.full_like(ox, INF)
    best_id = torch.full(ox.shape, -1, dtype=torch.int32, device=ox.device)
    for p in range(normals.shape[0]):
        denom = dx * normals[p, 0] + dy * normals[p, 1] + dz * normals[p, 2]
        num = offsets[p] - (ox * normals[p, 0] + oy * normals[p, 1] + oz * normals[p, 2])
        ok = torch.abs(denom) > 1.0e-12
        tp = num / torch.where(ok, denom, 1.0)
        tp = torch.where(ok & (tp > 1.0e-4), tp, INF)
        closer = tp < best_t
        best_t = torch.where(closer, tp, best_t)
        best_id = torch.where(closer, p, best_id)
    return best_t, best_id


def onehot_rows(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Row pickup from a SMALL table: a select chain for k <= 16 (ids
    outside 1..k-1 get row 0), a one-hot product above that."""
    k = table.shape[0]
    if k <= 16:
        out = table[0].expand(idx.shape + table.shape[1:])
        for j in range(1, k):
            pick = idx == j
            if table.dim() > 1:
                pick = pick[:, None]
            out = torch.where(pick, table[j], out)
        return out
    oh = (idx[:, None] == torch.arange(k, device=idx.device)[None, :]).to(table.dtype)
    return oh @ table


def resolve_material_comps(scene: Scene, mat: torch.Tensor, hit: torch.Tensor):
    """7 flat planes (em_r, em_g, em_b, al_r, al_g, al_b, scatter) for
    per-ray material ids; miss lanes 0."""
    em = scene.materials.emission
    al = scene.materials.albedo
    sc = scene.materials.scatter
    return tuple(
        torch.where(hit, onehot_rows(mat, tab), 0.0)
        for tab in (em[:, 0], em[:, 1], em[:, 2], al[:, 0], al[:, 1], al[:, 2], sc)
    )


def resolve_material_rows(scene: Scene, mat: torch.Tensor, hit: torch.Tensor):
    """(emission (R, 3), albedo (R, 3), scatter (R,)) rows for per-ray
    material ids, miss lanes zeroed (the miss sentinel is material 0, which
    would otherwise pick up the sky's row)."""
    h1 = hit[:, None]
    em = torch.where(h1, onehot_rows(mat, scene.materials.emission), 0.0)
    al = torch.where(h1, onehot_rows(mat, scene.materials.albedo), 0.0)
    sc = torch.where(hit, onehot_rows(mat, scene.materials.scatter[:, None])[:, 0], 0.0)
    return em, al, sc


def _patch_spheres_planes(scene, ox, oy, oz, dx, dy, dz, t, nx, ny, nz, hit,
                          emr, emg, emb, alr, alg, alb, scat):
    """Merge the sphere and plane classes into a triangle-class hit."""
    if scene.spheres.count > 0:
        cen = scene.spheres.centers
        ts, sid = _sphere_hits_soa(ox, oy, oz, dx, dy, dz, cen, scene.spheres.radii)
        closer = ts < t
        ts_safe = torch.where(ts < 1.0e30, ts, 0.0)
        nsx, nsy, nsz = _norm3(
            ox + ts_safe * dx - onehot_rows(sid, cen[:, 0]),
            oy + ts_safe * dy - onehot_rows(sid, cen[:, 1]),
            oz + ts_safe * dz - onehot_rows(sid, cen[:, 2]),
        )
        mat_s = onehot_rows(sid, scene.spheres.material_id.to(torch.float32)).to(torch.int32)
        t = torch.where(closer, ts, t)
        nx = torch.where(closer, nsx, nx)
        ny = torch.where(closer, nsy, ny)
        nz = torch.where(closer, nsz, nz)
        ms = resolve_material_comps(scene, mat_s, closer)
        emr, emg, emb, alr, alg, alb, scat = (
            torch.where(closer, a, b)
            for a, b in zip(ms, (emr, emg, emb, alr, alg, alb, scat)))
        hit = hit | (closer & (sid >= 0))
    if scene.planes.count > 0:
        pn = scene.planes.normals
        tp, pid = _plane_hits_soa(ox, oy, oz, dx, dy, dz, pn, scene.planes.offsets)
        closer = tp < t
        mat_p = onehot_rows(pid, scene.planes.material_id.to(torch.float32)).to(torch.int32)
        t = torch.where(closer, tp, t)
        nx = torch.where(closer, onehot_rows(pid, pn[:, 0]), nx)
        ny = torch.where(closer, onehot_rows(pid, pn[:, 1]), ny)
        nz = torch.where(closer, onehot_rows(pid, pn[:, 2]), nz)
        ms = resolve_material_comps(scene, mat_p, closer)
        emr, emg, emb, alr, alg, alb, scat = (
            torch.where(closer, a, b)
            for a, b in zip(ms, (emr, emg, emb, alr, alg, alb, scat)))
        hit = hit | (closer & (pid >= 0))
    return t, nx, ny, nz, hit, emr, emg, emb, alr, alg, alb, scat


# ---------------------------------------------------------------------------
# The fused hit (ShadedWideBVH): kernel forward, path-replay backward
# ---------------------------------------------------------------------------


def _barycentrics(row, ox, oy, oz, dx, dy, dz):
    """Möller–Trumbore of each ray against its face-table row (``row``,
    (R, 20)) in the kernel's op order, with no hit test: (u, v, q, 1 / det),
    q = (o - p0) x e1 as a triple of planes, 1 / det 0 where |det| <= 1e-12."""
    e1x, e1y, e1z = row[:, 3], row[:, 4], row[:, 5]
    e2x, e2y, e2z = row[:, 6], row[:, 7], row[:, 8]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = torch.abs(det) > 1.0e-12
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvx = ox - row[:, 0]
    tvy = oy - row[:, 1]
    tvz = oz - row[:, 2]
    uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    return uu, vv, (qvx, qvy, qvz), inv_det


def _replay_hit(face_table, fid_c, ox, oy, oz, dx, dy, dz):
    """Differentiable recompute of a fused hit from its face id: t and the
    normalized barycentric normal, with the kernel's Möller–Trumbore and
    interpolation op order."""
    row = _rows(face_table, fid_c)                # one (R, 20) gather
    uu, vv, (qvx, qvy, qvz), inv_det = _barycentrics(row, ox, oy, oz, dx, dy, dz)
    tt = (row[:, 6] * qvx + row[:, 7] * qvy + row[:, 8] * qvz) * inv_det
    w0 = 1.0 - uu - vv
    nx = w0 * row[:, 9] + uu * row[:, 12] + vv * row[:, 15]
    ny = w0 * row[:, 10] + uu * row[:, 13] + vv * row[:, 16]
    nz = w0 * row[:, 11] + uu * row[:, 14] + vv * row[:, 17]
    return (tt, *_norm3(nx, ny, nz))


class _FusedHit(torch.autograd.Function):
    """Forward: the ``wide_shade`` kernel, or with ``pair`` the pair-binned
    ``treelet_pair_hit`` (t, nx, ny, nz, face id, material id). Backward:
    the hit replayed from the saved face id, ray planes and face table
    (``_replay_hit``), miss-lane cotangents zeroed; no walk."""

    @staticmethod
    def forward(ctx, accel, pair, face_table, ox, oy, oz, dx, dy, dz, alive):
        if pair:
            fo, _ = treelet_pair_hit(accel, ox, oy, oz, dx, dy, dz, alive)
        else:
            fo = wide_shade_planes(accel, ox, oy, oz, dx, dy, dz, alive)
        ctx.mark_non_differentiable(fo["id"], fo["mat"])
        ctx.save_for_backward(face_table, ox, oy, oz, dx, dy, dz, fo["id"])
        return fo["t"], fo["nx"], fo["ny"], fo["nz"], fo["id"], fo["mat"]

    @staticmethod
    def backward(ctx, g_t, g_nx, g_ny, g_nz, _g_id, _g_mat):
        face_table, ox, oy, oz, dx, dy, dz, fid = ctx.saved_tensors
        need = ctx.needs_input_grad[2:9]
        if not any(need):
            return (None,) * 10
        hit = fid >= 0
        fid_c = torch.clamp(fid, 0, face_table.shape[0] - 1).long()
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(r)
                   for x, r in zip((face_table, ox, oy, oz, dx, dy, dz), need)]
            outs = _replay_hit(ins[0], fid_c, *ins[1:])
            cot = [torch.where(hit, g, 0.0) for g in (g_t, g_nx, g_ny, g_nz)]
            grads = iter(torch.autograd.grad(outs, [x for x in ins if x.requires_grad], cot,
                                             allow_unused=True))
        return (None, None, *(next(grads) if r else None for r in need), None)


def fused_hit(accel: ShadedWideBVH, face_table, ox, oy, oz, dx, dy, dz, alive,
              pair: bool = False):
    """Triangle-class nearest hit over a ``ShadedWideBVH``:
    (t, nx, ny, nz, face id, material id) as flat planes; ``pair`` takes
    the pair-binned traversal."""
    return _FusedHit.apply(accel, pair, face_table, ox, oy, oz, dx, dy, dz, alive)


def _shade_ids(scene, _face_table, ox, oy, oz, dx, dy, dz, t, nx, ny, nz, mat, hit):
    """Hit planes of a triangle-class hit given by its material id:
    material constants from the id, then spheres and planes patched in."""
    mats = resolve_material_comps(scene, mat, hit)
    return _patch_spheres_planes(scene, ox, oy, oz, dx, dy, dz, t, nx, ny, nz, hit, *mats)


def _shade_fused(scene, face_table, ox, oy, oz, dx, dy, dz, t, nx, ny, nz, fid, mat):
    """Hit planes of the fused path (``_shade_ids`` with hit = fid >= 0)."""
    return _shade_ids(scene, face_table, ox, oy, oz, dx, dy, dz, t, nx, ny, nz, mat, fid >= 0)


def _shade_consts(scene, _face_table, ox, oy, oz, dx, dy, dz, t, nx, ny, nz, hit,
                  emr, emg, emb, alr, alg, alb, scat):
    """Hit planes of a triangle-class hit that carries its material
    constants: spheres and planes patched in."""
    return _patch_spheres_planes(scene, ox, oy, oz, dx, dy, dz, t, nx, ny, nz, hit,
                                 emr, emg, emb, alr, alg, alb, scat)


def _override_hit(hit_override, st):
    """The triangle-class hit of ``hit_override(o (R, 3), d (R, 3), alive)``
    on the bounce's live rays, as (hit planes, the shading that reads
    them): the fused form ``(t, normal (R, 3), emission (R, 3), albedo
    (R, 3), scatter, hit)`` or the id form ``(t, normal, material id,
    hit)``. An override that decides hits alone detaches the rays itself;
    one that replays the hit from them passes their gradient on, as in
    the reference."""
    o3 = torch.stack([st.ox, st.oy, st.oz], dim=1)
    d3 = torch.stack([st.dx, st.dy, st.dz], dim=1)
    out = hit_override(o3, d3, st.alive)
    if len(out) == 6:
        t, n, em, al, sc, hit = out
        return ((t, n[:, 0], n[:, 1], n[:, 2], hit, em[:, 0], em[:, 1], em[:, 2],
                 al[:, 0], al[:, 1], al[:, 2], sc), _shade_consts)
    t, n, mat, hit = out
    return (t, n[:, 0], n[:, 1], n[:, 2], mat, hit), _shade_ids


# ---------------------------------------------------------------------------
# The gather path (WideBVH): integer hit ids + differentiable resolve
# ---------------------------------------------------------------------------


@torch.no_grad()
def nearest_hit_ids(scene: Scene, orig: torch.Tensor, dirn: torch.Tensor,
                    accel=None, alive: Optional[torch.Tensor] = None) -> HitIds:
    """Nearest primitive per ray over every class: triangles through the
    accel's walk (the ``t`` and ``id`` planes of ``wide_shade`` for a
    ``ShadedWideBVH``, ``wide_exact`` for a ``WideBVH``, ``ppacket`` for a
    ``TreePack``, ``bvh_first_hit`` for a ``BVH``, every triangle by brute
    force for None), then spheres, then planes, a later class winning only
    on a strictly smaller t. ``alive`` (bool (R,)) lets ``wide_shade`` skip
    dead rays, whose triangle class then misses; the other walks ignore it.
    Detached by intent."""
    o = orig.detach().contiguous()
    d = dirn.detach().contiguous()
    r = o.shape[0]
    best_t = torch.full((r,), INF, dtype=torch.float32, device=o.device)
    best_type = torch.zeros((r,), dtype=torch.int32, device=o.device)
    best_id = torch.full((r,), -1, dtype=torch.int32, device=o.device)

    def merge(t, pid, kind):
        closer = t < best_t
        best_t.copy_(torch.where(closer, t, best_t))
        best_type.copy_(torch.where(closer, kind, best_type))
        best_id.copy_(torch.where(closer, pid, best_id))

    if scene.mesh.num_faces > 0:
        if accel is None:
            t, _, _, tid = first_triangle_hit(o, d, *scene.triangle_soa())
        elif isinstance(accel, ShadedWideBVH):
            if alive is None:
                alive = torch.ones((r,), dtype=torch.bool, device=o.device)
            fo = wide_shade_planes(accel, *(o[:, k].contiguous() for k in range(3)),
                                   *(d[:, k].contiguous() for k in range(3)), alive)
            t, tid = fo["t"], fo["id"]
        elif isinstance(accel, WideBVH):
            t, _, _, tid = wide_exact_first_hit(accel, o, d)
        elif isinstance(accel, TreePack):
            t, _, _, tid = ppacket_first_hit(accel, o, d)
        elif isinstance(accel, BVH):
            t, _, _, tid = bvh_first_hit(accel, scene, o, d)
        else:
            raise TypeError(f"nearest_hit_ids takes a ShadedWideBVH, WideBVH, TreePack or "
                            f"BVH, not {type(accel).__name__}")
        merge(t, tid, PRIM_TRI)
    if scene.spheres.count > 0:
        merge(*sphere_hits(o, d, scene.spheres.centers, scene.spheres.radii), PRIM_SPHERE)
    if scene.planes.count > 0:
        merge(*plane_hits(o, d, scene.planes.normals, scene.planes.offsets), PRIM_PLANE)
    return HitIds(best_type, best_id, best_t)


def resolve_hit(scene: Scene, orig: torch.Tensor, dirn: torch.Tensor, ids: HitIds,
                face_table: Optional[torch.Tensor] = None):
    """Differentiable recompute of the hit from its ids: (t, shading normal
    (R, 3), material id, hit). Gradients reach vertices and vertex normals
    through ``face_table`` (``build_face_table``), and the ray rows."""
    r = orig.shape[0]
    dev = orig.device
    t = torch.full((r,), INF, dtype=torch.float32, device=dev)
    normal = torch.zeros((r, 3), dtype=torch.float32, device=dev)
    mat = torch.zeros((r,), dtype=torch.int32, device=dev)
    is_tri = ids.prim_type == PRIM_TRI
    is_sph = ids.prim_type == PRIM_SPHERE
    is_pln = ids.prim_type == PRIM_PLANE

    if scene.mesh.num_faces > 0:
        if face_table is None:
            face_table = build_face_table(scene)
        fid = torch.clamp(ids.prim_id, 0, scene.mesh.num_faces - 1).long()
        row = _rows(face_table, fid)                   # one (R, 20) gather
        tt, u, vv, _ = moller_trumbore(orig, dirn, row[:, 0:3], row[:, 3:6], row[:, 6:9])
        w0 = (1.0 - u - vv)[:, None]
        tri_n = normalize(w0 * row[:, 9:12] + u[:, None] * row[:, 12:15]
                          + vv[:, None] * row[:, 15:18])
        t = torch.where(is_tri, tt, t)
        normal = torch.where(is_tri[:, None], tri_n, normal)
        mat = torch.where(is_tri, row[:, 18].detach().to(torch.int32), mat)

    if scene.spheres.count > 0:
        sid = torch.clamp(ids.prim_id, 0, scene.spheres.count - 1).long()
        c = scene.spheres.centers[sid]
        rad = scene.spheres.radii[sid]
        oc = orig - c
        b = dot(oc, dirn)
        disc = b * b - (dot(oc, oc) - rad * rad)
        pos = disc > 0.0
        sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
        t0 = -b - sq
        ts = torch.where(t0 > 1e-4, t0, -b + sq)
        t = torch.where(is_sph, ts, t)
        normal = torch.where(is_sph[:, None], normalize(orig + ts[:, None] * dirn - c), normal)
        mat = torch.where(is_sph, scene.spheres.material_id[sid].to(torch.int32), mat)

    if scene.planes.count > 0:
        pid = torch.clamp(ids.prim_id, 0, scene.planes.count - 1).long()
        pn = scene.planes.normals[pid]
        denom = dot(dirn, pn)
        safe = torch.where(torch.abs(denom) > 1e-12, denom, 1.0)
        tp = (scene.planes.offsets[pid] - dot(orig, pn)) / safe
        t = torch.where(is_pln, tp, t)
        normal = torch.where(is_pln[:, None], pn, normal)
        mat = torch.where(is_pln, scene.planes.material_id[pid].to(torch.int32), mat)

    # a lane whose recompute missed (a grazing hit decided by one ulp, or
    # stale tables) is demoted: an INF hit point would poison the backward
    hit = (ids.prim_type != PRIM_NONE) & (t < 1.0e30)
    return t, normal, torch.where(hit, mat, 0), hit


def _shade_standard(scene, face_table, ox, oy, oz, dx, dy, dz, prim_type, prim_id, t_hit,
                    face_uv=None):
    """Hit planes of the gather path from the saved ids; with ``face_uv``
    (a textured scene) the albedo is modulated by the scene's texture."""
    o3 = torch.stack([ox, oy, oz], dim=1)
    d3 = torch.stack([dx, dy, dz], dim=1)
    t, n, mat, hit = resolve_hit(scene, o3, d3, HitIds(prim_type, prim_id, t_hit), face_table)
    emr, emg, emb, alr, alg, alb, scat = resolve_material_comps(scene, mat, hit)
    if face_uv is not None:
        tr, tg, tb = _texture_mod_soa(scene.texture, face_table, face_uv, prim_id,
                                      (prim_type == PRIM_TRI) & hit, ox, oy, oz, dx, dy, dz)
        alr, alg, alb = alr * tr, alg * tg, alb * tb
    return (t, n[:, 0], n[:, 1], n[:, 2], hit, emr, emg, emb, alr, alg, alb, scat)


# ---------------------------------------------------------------------------
# Bounces
# ---------------------------------------------------------------------------


class Lights(NamedTuple):
    """The NEE light set of a trace: the scene's ``spheres`` (a count;
    sphere ids come first) and the face ids of its emissive triangles
    (``tri``, an int64 tensor on the rays' device, or None)."""

    spheres: int
    tri: Optional[torch.Tensor]

    @property
    def count(self) -> int:
        return self.spheres + (0 if self.tri is None else int(self.tri.shape[0]))


def _static_tri_lights(scene: Scene) -> Optional[np.ndarray]:
    """Face ids of the emissive triangles (the area lights of NEE) from the
    concrete scene, as int32 numpy, or None where there are none."""
    em = to_numpy(scene.materials.emission)
    mid = to_numpy(scene.mesh.material_id)
    if em.size == 0 or mid.size == 0:
        return None
    ids = np.flatnonzero(em.max(axis=1)[mid] > 0.0)
    return ids.astype(np.int32) if ids.size else None


def _nee_lights(scene: Scene, nee: bool, dev) -> Optional[Lights]:
    """The trace's ``Lights``, or None where NEE is off or the scene has no
    light; the area lights are found on the concrete scene, once a trace."""
    if not nee:
        return None
    tri_ids = _static_tri_lights(scene)
    tri = None if tri_ids is None else torch.as_tensor(tri_ids, device=dev).long()
    lights = Lights(scene.spheres.count, tri)
    return lights if lights.count > 0 else None


def _light_sample(scene, face_table, lights: Lights, u_pick, u_a, u_b):
    """One light per ray, picked uniformly, and a uniform point on it from
    two uniforms: (px, py, pz, sphere radius, emission [r, g, b], the
    sphere id the shadow ray may hit (-1 for a triangle), whether it is a
    triangle, the triangle's normal [x, y, z] and area, both None without
    area lights). Differentiable in the light's geometry and emission."""
    ns, nl = lights.spheres, lights.count
    em = scene.materials.emission
    lid = torch.clamp_max(((u_pick + 1.0) * 0.5 * nl).to(torch.int32), nl - 1)
    is_tri = lid >= ns
    if ns > 0:
        cen = scene.spheres.centers
        lem_tab = _rows(em, scene.spheres.material_id.long())
        slid = torch.clamp(lid, 0, ns - 1)
        lr = onehot_rows(slid, scene.spheres.radii)
        lem = [onehot_rows(slid, lem_tab[:, k]) for k in range(3)]
        z = u_a
        phi = (u_b + 1.0) * math.pi
        s = torch.sqrt(torch.clamp_min(1.0 - z * z, 0.0))
        px = onehot_rows(slid, cen[:, 0]) + lr * (s * torch.cos(phi))
        py = onehot_rows(slid, cen[:, 1]) + lr * (s * torch.sin(phi))
        pz = onehot_rows(slid, cen[:, 2]) + lr * z
        occl_lid = slid
    else:
        px = py = pz = lr = torch.zeros_like(u_pick)
        lem = [px, px, px]
        occl_lid = torch.full_like(lid, -1)
    nl3 = area = None
    if lights.tri is not None:
        nt = lights.tri.shape[0]
        rows_l = _rows(face_table, lights.tri)                    # (nt, 20)
        em_l = _rows(em, rows_l[:, 18].detach().long())
        cr_l = cross(rows_l[:, 3:6], rows_l[:, 6:9])
        len_l = torch.sqrt(torch.clamp_min((cr_l * cr_l).sum(dim=1), 1.0e-20))
        nrm_l = cr_l / len_l[:, None]
        tlid = torch.clamp(lid - ns, 0, nt - 1)
        r1 = (u_a + 1.0) * 0.5
        r2 = (u_b + 1.0) * 0.5
        su = torch.sqrt(torch.clamp_min(r1, 0.0))
        b1 = su * (1.0 - r2)
        b2 = su * r2

        def lrow(k):
            return onehot_rows(tlid, rows_l[:, k])

        px = torch.where(is_tri, lrow(0) + b1 * lrow(3) + b2 * lrow(6), px)
        py = torch.where(is_tri, lrow(1) + b1 * lrow(4) + b2 * lrow(7), py)
        pz = torch.where(is_tri, lrow(2) + b1 * lrow(5) + b2 * lrow(8), pz)
        lem = [torch.where(is_tri, onehot_rows(tlid, em_l[:, k]), lem[k]) for k in range(3)]
        occl_lid = torch.where(is_tri, -1, occl_lid)
        nl3 = [onehot_rows(tlid, nrm_l[:, k]) for k in range(3)]
        area = onehot_rows(tlid, 0.5 * len_l)
    return px, py, pz, lr, lem, occl_lid, is_tri, nl3, area


def _merge_light_check(scene, t, ox, oy, oz, dx, dy, dz, dist, lid):
    """Fold spheres and planes into the shadow rays' triangle-class nearest
    ``t`` and decide occlusion: blocked by anything nearer than ``dist``
    that is not the picked light sphere."""
    is_light = torch.zeros_like(lid, dtype=torch.bool)
    if scene.spheres.count > 0:
        ts, sid = _sphere_hits_soa(ox, oy, oz, dx, dy, dz, scene.spheres.centers,
                                   scene.spheres.radii)
        is_light = (ts < t) & (sid == lid)
        t = torch.minimum(t, ts)
    if scene.planes.count > 0:
        tp, _ = _plane_hits_soa(ox, oy, oz, dx, dy, dz, scene.planes.normals,
                                scene.planes.offsets)
        is_light = is_light & ~(tp < t)
        t = torch.minimum(t, tp)
    return (t < dist - 1.0e-3) & ~is_light


@torch.no_grad()
def occlusion(scene: Scene, accel, ox, oy, oz, dx, dy, dz, dist, lid, live,
              occl_override: Optional[Callable] = None) -> torch.Tensor:
    """True where something other than the picked light blocks the shadow
    ray before ``dist``: the triangle-class nearest t from
    ``occl_override(o (R, 3), d (R, 3), live)`` where given (the treelet
    path's shadow-ray ring), else the ``t`` plane of ``wide_shade`` over
    the ``live`` rays for a ``ShadedWideBVH``, ``nearest_hit_ids`` for the
    gather accels and for None. Discrete: the inputs are detached."""
    ox, oy, oz, dx, dy, dz, dist = (x.detach() for x in (ox, oy, oz, dx, dy, dz, dist))
    if occl_override is not None:
        t = occl_override(torch.stack([ox, oy, oz], dim=1), torch.stack([dx, dy, dz], dim=1),
                          live)
        return _merge_light_check(scene, t, ox, oy, oz, dx, dy, dz, dist, lid)
    if isinstance(accel, ShadedWideBVH):
        t = wide_shade_planes(accel, ox, oy, oz, dx, dy, dz, live)["t"]
        return _merge_light_check(scene, t, ox, oy, oz, dx, dy, dz, dist, lid)
    ids = nearest_hit_ids(scene, torch.stack([ox, oy, oz], dim=1),
                          torch.stack([dx, dy, dz], dim=1), accel)
    is_light = (ids.prim_type == PRIM_SPHERE) & (ids.prim_id == lid)
    return (ids.t < dist - 1.0e-3) & ~is_light


def _shade_bounce(scene, face_table, shade_hit, draw, b, lights, occlude, ox, oy, oz,
                  dx, dy, dz, wr, wg, wb, cr, cg, cb, alive, gid, *hit):
    """Everything of a bounce after the hit query: hit planes from the
    saved hit, shading, with ``lights`` the NEE term, respawn. Pure
    elementwise work, recomputed in the backward when checkpointed.
    ``occlude`` maps the bounce's shadow rays to their occlusion."""
    u = draw(gid, b, 3 if lights is None else 6)
    (t, nx, ny, nz, hit_m, emr, emg, emb, alr, alg, alb,
     scat) = shade_hit(scene, face_table, ox, oy, oz, dx, dy, dz, *hit)

    sky = scene.materials.emission[0]
    miss_now = alive & ~hit_m
    cr = cr + torch.where(miss_now, wr * sky[0], 0.0)
    cg = cg + torch.where(miss_now, wg * sky[1], 0.0)
    cb = cb + torch.where(miss_now, wb * sky[2], 0.0)

    live_hit = alive & hit_m
    cos_in = -(dx * nx + dy * ny + dz * nz)
    backface = cos_in < 0.0
    nxo = torch.where(backface, -nx, nx)
    nyo = torch.where(backface, -ny, ny)
    nzo = torch.where(backface, -nz, nz)
    atten = torch.where(backface, 0.0, cos_in)

    # with NEE the lights' share arrives by shadow rays: hit emission
    # counts only on the camera bounce
    if lights is None or b == 0:
        cr = cr + torch.where(live_hit, wr * emr, 0.0)
        cg = cg + torch.where(live_hit, wg * emg, 0.0)
        cb = cb + torch.where(live_hit, wb * emb, 0.0)

    # t is INF on misses: zero it so the untaken branch stays finite
    t_safe = torch.where(hit_m, t, 0.0)
    hx = ox + t_safe * dx
    hy = oy + t_safe * dy
    hz = oz + t_safe * dz

    if lights is not None:
        px, py, pz, lr, lem, occl_lid, is_tri, nl3, area = _light_sample(
            scene, face_table, lights, u[3], u[4], u[5])
        tx, ty, tz = px - hx, py - hy, pz - hz
        dist = torch.sqrt(torch.clamp_min(tx * tx + ty * ty + tz * tz, 1.0e-12))
        ldx, ldy, ldz = tx / dist, ty / dist, tz / dist
        cos_l = torch.clamp_min(nxo * ldx + nyo * ldy + nzo * ldz, 0.0)
        # dead lanes get parked shadow rays
        occluded = occlude(
            torch.where(live_hit, hx, 1.0e7), torch.where(live_hit, hy, 1.0e7),
            torch.where(live_hit, hz, 1.0e7), torch.where(live_hit, ldx, 0.0),
            torch.where(live_hit, ldy, 0.0), torch.where(live_hit, ldz, 1.0),
            dist, occl_lid, live_hit)
        nl = lights.count
        gain = cos_l * ((lr * lr) / torch.maximum(dist * dist, lr * lr)) * nl
        if nl3 is not None:
            # area light: receiver cosine x |light cosine| (two-sided) x
            # area / squared distance
            cos_lt = torch.abs(nl3[0] * ldx + nl3[1] * ldy + nl3[2] * ldz)
            gain_t = cos_l * cos_lt * area / torch.clamp_min(dist * dist, 1.0e-12) * nl
            gain = torch.where(is_tri, gain_t, gain)
        lit = live_hit & ~occluded
        cr = cr + torch.where(lit, wr * alr * lem[0] * gain, 0.0)
        cg = cg + torch.where(lit, wg * alg * lem[1] * gain, 0.0)
        cb = cb + torch.where(lit, wb * alb * lem[2] * gain, 0.0)

    wr = torch.where(live_hit, wr * alr * atten, wr)
    wg = torch.where(live_hit, wg * alg * atten, wg)
    wb = torch.where(live_hit, wb * alb * atten, wb)

    ndx, ndy, ndz = _bounce_dir_soa(dx, dy, dz, nxo, nyo, nzo, scat, u[0], u[1], u[2])
    alive = live_hit
    # park dead rays far outside the scene, pointing +z
    return (torch.where(alive, hx, 1.0e7), torch.where(alive, hy, 1.0e7),
            torch.where(alive, hz, 1.0e7), torch.where(alive, ndx, 0.0),
            torch.where(alive, ndy, 0.0), torch.where(alive, ndz, 1.0),
            wr, wg, wb, cr, cg, cb, alive)


def _records(scene: Scene, *xs: torch.Tensor) -> bool:
    """Whether autograd records work on ``xs``, the scene's float leaves
    and its texture."""
    leaves = (*scene.params().leaves(), scene.texture)
    return torch.is_grad_enabled() and any(
        isinstance(x, torch.Tensor) and x.requires_grad for x in (*xs, *leaves))


def _textured(scene: Scene) -> bool:
    """Whether the scene's texture is sampled (the reference's ``has_tex``):
    it has one and a mesh to map it on."""
    return scene.texture is not None and scene.mesh.num_faces > 0


def _face_table_for(scene: Scene, accel, record: bool,
                    lights: Optional[Lights] = None) -> Optional[torch.Tensor]:
    """The face table where a pass reads it: the gather path's
    ``resolve_hit`` (every accel on a textured scene), the texture lookup
    and the area lights' sample always, the fused hit's backward replay
    only when autograd records."""
    if (record or accel is None or isinstance(accel, (*_GATHER_ACCELS, HybridAccel))
            or _textured(scene) or (lights is not None and lights.tri is not None)):
        return build_face_table(scene)
    return None


def _trace_tables(scene: Scene, accel, nee: bool, orig: torch.Tensor, dirn: torch.Tensor):
    """What a trace builds once for all its chunks: (the NEE ``Lights`` or
    None, the face table where a pass reads it, the tex-coord table of a
    textured scene or None)."""
    lights = _nee_lights(scene, nee, orig.device)
    face_table = _face_table_for(scene, accel, _records(scene, orig, dirn), lights)
    return lights, face_table, build_face_uv(scene) if _textured(scene) else None


Draw = Callable[[torch.Tensor, int, int], Tuple[torch.Tensor, ...]]


def _drawer(key, uniforms: Optional[torch.Tensor], ray_ids: torch.Tensor) -> Draw:
    """``draw(gid, b, channels)``: the bounce's uniform columns of the rays
    with global ids ``gid``, hashed from ``key`` or read from the explicit
    (B, R, C) ``uniforms`` at row ``gid - ray_ids[0]`` (ids are a
    contiguous block before compaction permutes them; a dead packed lane's
    row is clamped into the block, its numbers unused)."""
    if uniforms is None:
        if key is None:
            raise ValueError("need key or uniforms for stochastic bounces")
        return lambda gid, b, c: ray_uniform_cols(key, gid, b, c)
    gid0 = ray_ids[0].long()
    n = uniforms.shape[1]

    def draw(gid, b, c):
        if c > uniforms.shape[2]:
            raise ValueError(f"uniforms have {uniforms.shape[2]} channels, the bounce needs {c}")
        rows = torch.clamp(gid.long() - gid0, 0, n - 1)
        uni = torch.index_select(uniforms[b], 0, rows)
        return tuple(uni[:, k] for k in range(c))

    return draw


def bounce_step(scene: Scene, accel, face_table, st: WaveState, b: int, draw: Draw,
                pair: bool = False, lights: Optional[Lights] = None,
                face_uv: Optional[torch.Tensor] = None,
                hit_override: Optional[Callable] = None,
                occl_override: Optional[Callable] = None) -> WaveState:
    """One wavefront bounce over flat (R,) planes: the hit query (with
    ``pair``, the pair-binned one; with ``hit_override``, the caller's,
    ``_override_hit``), then ``_shade_bounce``, checkpointed
    when autograd records it. ``face_uv`` (a textured scene) sends every
    accel down the gather path, whose shading samples the texture. With
    ``lights`` the checkpointed shading gets an occluder that keeps the
    bool plane of its first call: the forward walks the shadow rays once
    and the backward's recompute reads the kept plane, so the backward
    walks no BVH. The hit ids are taken outside the checkpoint, so the
    recompute walks nothing for them either."""
    ox, oy, oz, dx, dy, dz = st.ox, st.oy, st.oz, st.dx, st.dy, st.dz
    # rays cast = live paths entering the bounce
    rc = st.rc + st.alive.sum()
    if hit_override is not None:
        hit, shade_hit = _override_hit(hit_override, st)
    elif accel is None or isinstance(accel, _GATHER_ACCELS) or face_uv is not None:
        ids = nearest_hit_ids(scene, torch.stack([ox, oy, oz], dim=1),
                              torch.stack([dx, dy, dz], dim=1), accel, alive=st.alive)
        hit = tuple(ids)
        shade_hit = (_shade_standard if face_uv is None
                     else functools.partial(_shade_standard, face_uv=face_uv))
    else:
        hit = fused_hit(accel, face_table, ox, oy, oz, dx, dy, dz, st.alive, pair)
        shade_hit = _shade_fused

    kept = []

    def occlude(*shadow):
        # the first call walks; the checkpoint's recompute reads its plane
        if not kept:
            kept.append(occlusion(scene, accel, *shadow, occl_override=occl_override))
        return kept[0]

    def shade(*planes):
        return _shade_bounce(scene, face_table, shade_hit, draw, b, lights, occlude, *planes)

    args = (*st[:14], *hit)
    if not _records(scene, *st[:12]):
        return WaveState(*shade(*args), st.gid, rc)
    out = checkpoint(shade, *args, use_reentrant=False)
    return WaveState(*out, st.gid, rc)


def _spread3(x):
    """Spread up to 10 bits so bit k lands at position 3k (Morton)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


@torch.no_grad()
def sort_key(scene: Scene, ox, oy, oz, dx, dy, dz, alive) -> torch.Tensor:
    """Compaction key: dead rays last; live rays by the Morton code of the
    origin cell (6 bits per axis over the mesh bounds), direction octant as
    tiebreak."""
    if scene.mesh.num_vertices > 0:
        v = scene.mesh.vertices
        lo = v.min(dim=0).values
        hi = v.max(dim=0).values
        span = torch.clamp_min(hi - lo, 1e-6)

        def cell(c, k):
            q = torch.clamp((c - lo[k]) / span[k], 0.0, 1.0)
            return (q * 63.0).to(torch.int32)

        morton = ((_spread3(cell(ox, 0)) << 2) | (_spread3(cell(oy, 1)) << 1)
                  | _spread3(cell(oz, 2)))
    else:
        morton = torch.zeros(alive.shape, dtype=torch.int32, device=alive.device)
    octd = ((dx > 0).to(torch.int32) * 4 + (dy > 0).to(torch.int32) * 2
            + (dz > 0).to(torch.int32))
    return torch.where(alive, (morton << 3) | octd, 1 << 30).to(torch.int32)


Restore = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, ...]]


def _lane_pack_state(st: WaveState) -> Tuple[WaveState, Restore]:
    """Stable live-ray packing of the state: the 12 float planes through
    ``lane_take_p`` (differentiable: its backward is ``lane_scatter``),
    liveness and the int32 global ray id through a plain int ``lane_take``
    (a second launch), so ids stay exact at any size. Returns the packed
    state and ``lane_restore(cr, cg, cb)``, which routes results back
    (``lane_take_p`` again); rays already dead at pack time keep their
    radiance."""
    alive = st.alive
    pidx = pack_indices(alive)
    uidx = unpack_indices(alive)
    pk = lane_take_p(torch.stack(st[:12]), pidx)
    ints = lane_take(torch.stack([alive.to(torch.int32), st.gid.to(torch.int32)]), pidx)
    alive2 = ints[0] != 0
    packed = WaveState(
        torch.where(alive2, pk[0], 1.0e7), torch.where(alive2, pk[1], 1.0e7),
        torch.where(alive2, pk[2], 1.0e7), torch.where(alive2, pk[3], 0.0),
        torch.where(alive2, pk[4], 0.0), torch.where(alive2, pk[5], 1.0),
        pk[6], pk[7], pk[8], pk[9], pk[10], pk[11], alive2, ints[1], st.rc,
    )
    c_pre = (st.cr, st.cg, st.cb)

    def lane_restore(cr, cg, cb):
        up = lane_take_p(torch.stack([cr, cg, cb]), uidx)
        return tuple(torch.where(alive, up[k], c_pre[k]) for k in range(3))

    return packed, lane_restore


def compact_state(scene: Scene, st: WaveState, lane_pack: bool) -> Tuple[WaveState, Restore]:
    """One-shot compaction: reorder 128-ray rows by their smallest
    ``sort_key`` (per-ray for small or ragged wavefronts), then, with
    ``lane_pack``, pack live rays to a lane prefix. Returns the state and
    ``restore(cr, cg, cb)`` that undoes both by gathers."""
    keys = sort_key(scene, st.ox, st.oy, st.oz, st.dx, st.dy, st.dz, st.alive)
    n = keys.shape[0]
    lane = 128
    if n % lane == 0 and n >= 4 * lane:
        rows = n // lane
        perm = torch.argsort(keys.reshape(rows, lane).min(dim=1).values, stable=True)

        def take(x, p):
            return _rows(x.reshape(rows, lane), p).reshape(-1)
    else:
        perm = torch.argsort(keys, stable=True)

        def take(x, p):
            return _rows(x, p)

    inv = torch.argsort(perm)
    st = WaveState(*(take(x, perm) for x in st[:14]), st.rc)

    def restore(cr, cg, cb):
        return take(cr, inv), take(cg, inv), take(cb, inv)

    if lane_pack:
        st, lane_restore = _lane_pack_state(st)
        row_restore = restore

        def restore(cr, cg, cb):
            return row_restore(*lane_restore(cr, cg, cb))

    return st, restore


def _accel_on(accel, dev: torch.device):
    """A host accel uploaded to ``dev``; an uploaded one must be there."""
    if accel is None:
        return None
    if not isinstance(accel, (ShadedWideBVH, HybridAccel, *_GATHER_ACCELS)):
        raise TypeError(f"unknown accel type {type(accel).__name__}")
    probe = accel.wide if isinstance(accel, HybridAccel) else accel
    table = getattr(probe, dataclasses.fields(probe)[0].name)     # its first table
    if not isinstance(table, torch.Tensor):
        return accel.to(dev)
    if table.device != dev:
        raise ValueError(f"accel is on {table.device}, the rays on {dev}")
    return accel


def _split_accel(accel, pair_bounces: bool):
    """(camera-bounce accel, later-bounce accel, pair): a ``HybridAccel``
    splits into its two halves; ``pair`` holds when ``pair_bounces`` asks
    for the pair-binned traversal and the later-bounce accel is a
    ``ShadedWideBVH`` with a treelet view (any other accel ignores it)."""
    if isinstance(accel, HybridAccel):
        return accel.wide, accel.pack, False
    pair = (pair_bounces and isinstance(accel, ShadedWideBVH)
            and accel.num_treelets > 0 and accel.tboxes is not None)
    return accel, accel, pair


def trace_radiance(scene: Scene, orig: torch.Tensor, dirn: torch.Tensor,
                   bounce_limit: int, key=None, uniforms: Optional[torch.Tensor] = None,
                   accel=None, sort_rays: bool = False, nee: bool = False,
                   return_stats: bool = False,
                   ray_ids: Optional[torch.Tensor] = None,
                   lane_pack: bool = True, pair_bounces: bool = False,
                   hit_override: Optional[Callable] = None,
                   occl_override: Optional[Callable] = None):
    """Path-trace each ray to its radiance (R, 3) on the rays' device (the
    scene, a host accel and ``uniforms`` are moved there). ``accel`` is a
    ``ShadedWideBVH`` (fused hit; ``pair_bounces`` takes the pair-binned
    traversal after the camera bounce), a ``WideBVH``, ``TreePack``,
    ``BVH`` or ``HybridAccel`` (gather path), or None (every triangle by
    brute force); a textured scene takes the gather path with any of them.
    ``key`` is the uint32[2] bounce key; ``ray_ids``
    (default 0..R-1) are the global ids that key the per-ray random
    numbers. ``uniforms`` (B, R, 3, or 6 with NEE, in [-1, 1)) replaces the
    keyed draw, and then ``key`` may be None. ``nee`` adds next-event
    estimation to the spheres and the emissive triangles. Differentiable with respect to the scene's float leaves
    and the rays. With ``return_stats`` also returns ``{"rays_cast": int64
    tensor}``, the live paths summed over bounces.

    ``hit_override(o (R, 3), d (R, 3), alive)`` replaces the triangle-class
    nearest hit (the accel is then not walked for hits; spheres and planes
    are still merged here). It returns ``(t, normal (R, 3), material id,
    hit)``, or the fused form ``(t, normal, emission (R, 3), albedo (R, 3),
    scatter, hit)``; its ray inputs are the live rays (an override that
    only decides which face a ray hits detaches them, which carries no
    derivative; one that replays the hit from them passes their gradient
    on), and its outputs are taken as they come. With
    NEE and a light it needs ``occl_override(o, d, live) -> t``, the
    shadow rays' triangle-class nearest t, and raises
    ``NotImplementedError`` without one. A textured scene under an
    override is shaded untextured, as in the reference."""
    dev = orig.device
    scene = scene.to(dev)
    accel = _accel_on(accel, dev)
    if ray_ids is None:
        ray_ids = torch.arange(orig.shape[0], dtype=torch.int32, device=dev)
    if uniforms is not None:
        uniforms = torch.as_tensor(uniforms, dtype=torch.float32, device=dev)
    lights, face_table, face_uv = _trace_tables(scene, accel, nee, orig, dirn)
    if hit_override is not None:
        if lights is not None and occl_override is None:
            raise NotImplementedError(
                "NEE with hit_override needs an occl_override occlusion query "
                "(the treelet path passes its shadow-ray ring)")
        face_uv = None
    color, rays_cast = _trace(scene, accel, face_table, orig, dirn, ray_ids,
                              bounce_limit, _drawer(key, uniforms, ray_ids), sort_rays,
                              lane_pack, pair_bounces, lights, face_uv, hit_override,
                              occl_override)
    if return_stats:
        return color, {"rays_cast": rays_cast}
    return color


def _trace(scene, accel, face_table, orig, dirn, ray_ids, bounce_limit, draw,
           sort_rays, lane_pack, pair_bounces=False, lights=None, face_uv=None,
           hit_override=None, occl_override=None):
    """The bounce loop of ``trace_radiance`` on a scene and accel already on
    the rays' device: (color (R, 3), rays_cast). ``face_uv`` (a textured
    scene) takes the gather path and no pair bounces. Every bounce runs on
    every call, whatever rays are alive: an override's collectives see the
    same calls on every rank."""
    dev = orig.device
    r = orig.shape[0]
    ones = torch.ones(r, dtype=torch.float32, device=dev)
    zeros = torch.zeros(r, dtype=torch.float32, device=dev)
    st = WaveState(
        orig[:, 0].contiguous(), orig[:, 1].contiguous(), orig[:, 2].contiguous(),
        dirn[:, 0].contiguous(), dirn[:, 1].contiguous(), dirn[:, 2].contiguous(),
        ones, ones, ones, zeros, zeros, zeros,
        torch.ones(r, dtype=torch.bool, device=dev), ray_ids.to(torch.int32),
        torch.zeros((), dtype=torch.int64, device=dev),
    )

    primary, later, pair = _split_accel(accel, pair_bounces and face_uv is None)

    def step(st, b):
        return bounce_step(scene, later if b else primary, face_table, st, b, draw,
                           pair=pair and b > 0, lights=lights, face_uv=face_uv,
                           hit_override=hit_override, occl_override=occl_override)

    start = 0
    if bounce_limit > 0:
        st = step(st, 0)
        start = 1
    restore = None
    if sort_rays and bounce_limit > start + 1:
        # the first diffuse bounce runs at full width, then compact once
        st = step(st, start)
        start += 1
        st, restore = compact_state(scene, st, lane_pack)
    for b in range(start, bounce_limit):
        st = step(st, b)

    cr, cg, cb = st.cr, st.cg, st.cb
    if restore is not None:
        cr, cg, cb = restore(cr, cg, cb)
    return torch.stack([cr, cg, cb], dim=1), st.rc


def _largest_divisor_leq(n: int, cap: int) -> int:
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def film_tile_shape(width: int, height: int) -> Tuple[int, int]:
    """(tile_h, tile_w) dividing the film: up to 16 rows by 128 columns."""
    return _largest_divisor_leq(height, 16), _largest_divisor_leq(width, 128)


def to_tile_order(x: torch.Tensor, w: int, h: int, spp: int) -> torch.Tensor:
    """(spp*h*w, C) sample-major rays -> film-tile-major order (samples of
    one tile stay adjacent)."""
    th, tw = film_tile_shape(w, h)
    c = x.shape[-1]
    t = x.reshape(spp, h // th, th, w // tw, tw, c)
    return t.permute(1, 3, 0, 2, 4, 5).reshape(-1, c)


def from_tile_order(x: torch.Tensor, w: int, h: int, spp: int) -> torch.Tensor:
    """Inverse of ``to_tile_order``."""
    th, tw = film_tile_shape(w, h)
    c = x.shape[-1]
    t = x.reshape(h // th, w // tw, spp, th, tw, c)
    return t.permute(2, 0, 3, 1, 4, 5).reshape(-1, c)


def _pad_rays(orig, dirn, ray_ids, uniforms, pad: int):
    """The rays with ``pad`` parked rays appended (origin 1e7, heading +z:
    they hit nothing, and their colour is dropped), whose ids continue the
    last id, and zero uniforms for them."""
    if not pad:
        return orig, dirn, ray_ids, uniforms
    dev = orig.device
    orig = torch.cat([orig, torch.full((pad, 3), 1.0e7, dtype=orig.dtype, device=dev)])
    park = torch.tensor([[0.0, 0.0, 1.0]], dtype=dirn.dtype, device=dev)
    dirn = torch.cat([dirn, park.expand(pad, 3)])
    ray_ids = torch.cat([ray_ids, ray_ids[-1] + 1 + torch.arange(
        pad, dtype=ray_ids.dtype, device=dev)])
    if uniforms is not None:
        uniforms = torch.cat([uniforms, uniforms.new_zeros(
            (uniforms.shape[0], pad, uniforms.shape[2]))], dim=1)
    return orig, dirn, ray_ids, uniforms


def _trace_chunked(scene, orig, dirn, ray_ids, settings: RenderSettings, key, accel,
                   uniforms=None, progress_cb: Optional[Callable[[int], None]] = None):
    """Trace a flat ray set in chunks of ``settings.ray_chunk`` (a Python
    loop; the last chunk is padded with parked rays and zero uniforms), on
    a scene, accel and ``uniforms`` already on the rays' device. The face
    table, the tex coords and the light set are built once for all chunks.
    ``progress_cb(rays_cast_of_the_chunk)`` (a Python int, which costs a
    host sync) is called after each chunk when there are several, as in the
    reference. Returns (color (N, 3), rays_cast)."""
    n = orig.shape[0]
    chunk = settings.ray_chunk
    lights, face_table, face_uv = _trace_tables(scene, accel, settings.nee, orig, dirn)

    def trace(o, d, ids, un):
        return _trace(scene, accel, face_table, o, d, ids, settings.bounce_limit,
                      _drawer(key, un, ids), settings.sort_bounces, settings.lane_pack,
                      settings.pair_bounces, lights, face_uv)

    if not chunk or chunk >= n:
        return trace(orig, dirn, ray_ids, uniforms)
    orig, dirn, ray_ids, uniforms = _pad_rays(orig, dirn, ray_ids, uniforms, (-n) % chunk)
    colors, rays_cast = [], 0
    for s in range(0, orig.shape[0], chunk):
        color, rc = trace(orig[s:s + chunk], dirn[s:s + chunk], ray_ids[s:s + chunk],
                          None if uniforms is None else uniforms[:, s:s + chunk])
        colors.append(color)
        rays_cast = rays_cast + rc
        if progress_cb is not None:
            progress_cb(int(rc))
    return torch.cat(colors)[:n], rays_cast


def clip01(x: torch.Tensor) -> torch.Tensor:
    """Clamp to [0, 1] with ``jnp.clip``'s gradient: at an exact bound each
    side of the min/max gets half (``torch.clamp`` would pass all of it),
    so black pixels at exactly 0 still carry half their emission gradient."""
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)), torch.ones_like(x))


def _trace_on_mesh(scene, orig, dirn, ray_ids, settings: RenderSettings, key, accel,
                   uniforms, mesh, axis_name: str):
    """The frame's rays padded to a multiple of the ranks (parked rays with
    ids n.., zero uniforms), this rank's contiguous slice traced by
    ``_trace_chunked``, the colours gathered on every rank and the pad rows
    dropped. Returns (color (N, 3), rays_cast, rays_cast_per_shard: one
    int64 a rank)."""
    from atray_tpu_torch.dist import mesh as dmesh

    dmesh.check_axis(mesh, axis_name)
    n = orig.shape[0]
    orig, dirn, ray_ids, uniforms = _pad_rays(orig, dirn, ray_ids, uniforms, (-n) % mesh.size)
    part = dmesh.shard_slice(orig.shape[0], mesh)
    color, rc = _trace_chunked(scene, orig[part], dirn[part], ray_ids[part], settings, key,
                               accel, None if uniforms is None else uniforms[:, part])
    color = dmesh.gather_rows(color, mesh)[:n]
    per_shard = dmesh.gather_rows(torch.as_tensor(rc, dtype=torch.int64,
                                                  device=orig.device).reshape(1), mesh)
    return color, per_shard.sum(), per_shard


def render(scene: Scene, camera: Camera, settings: RenderSettings, key,
           accel=None, uniforms: Optional[torch.Tensor] = None,
           return_stats: bool = False, device=None,
           progress_cb: Optional[Callable[[int], None]] = None,
           mesh=None, axis_name: str = "rays"):
    """Full render -> linear-RGB film (H, W, 3) in [0, 1] on ``device``
    (None: "cuda"; "cpu" runs the plain versions of the kernels). A host
    scene or accel is moved there. ``key`` is a uint32[2] key
    (``rng.prng_key(seed)``); it splits into an anti-aliasing key and the
    bounce key, as in the reference. ``uniforms`` ((B, spp*H*W, C) in
    camera-ray order, ``rng.draw_bounce_uniforms``) replaces the bounce
    key's draw. Differentiable with respect to the scene's float
    leaves (``Scene.with_params``) and its texture
    (``dataclasses.replace(scene, texture=t)``); the film clamp is
    ``clip01``. ``progress_cb(rays_cast_of_the_chunk)`` is called once per
    chunk where ``settings.ray_chunk`` cuts the frame in several.

    ``mesh`` (a ``dist.mesh.RayMesh``, whose ``axis_name`` must be the one
    given) shards the rays over its ranks, each rank calling ``render``
    with the same arguments: every rank makes the frame's camera rays, pads
    them to a multiple of the ranks, traces its own slice (chunked as
    ``settings.ray_chunk`` says) and gathers the colours, so every rank
    returns the film, bit-equal to the one-rank film. It runs on the mesh's
    device (``device`` must be None or that one); ``progress_cb`` is not
    called, as in the reference; the stats add ``rays_cast_per_shard``, one
    int64 a rank, which ``rays_cast`` sums. The area lights come from the
    concrete scene, the same on every rank."""
    dev = resolve_device(device) if mesh is None or device is not None else mesh.device
    if mesh is not None and dev != mesh.device:
        raise ValueError(f"render on {dev}, but the mesh's rank computes on {mesh.device}")
    scene = scene.to(dev)
    accel = _accel_on(accel, dev)
    w, h = settings.resolution
    spp = settings.samples_per_pixel
    aa_key, bounce_key = split(np.asarray(key, np.uint32))
    orig, dirn = camera_rays(camera, w, h, spp, device=dev,
                             anti_aliasing=settings.anti_aliasing,
                             key=aa_key if settings.anti_aliasing else None)
    orig = to_tile_order(orig, w, h, spp)
    dirn = to_tile_order(dirn, w, h, spp)
    if uniforms is not None:
        uniforms = torch.as_tensor(uniforms, dtype=torch.float32, device=dev)
        uniforms = torch.stack([to_tile_order(u, w, h, spp) for u in uniforms])
    ray_ids = torch.arange(orig.shape[0], dtype=torch.int32, device=dev)
    stats = {}
    if mesh is None:
        color, stats["rays_cast"] = _trace_chunked(scene, orig, dirn, ray_ids, settings,
                                                   bounce_key, accel, uniforms, progress_cb)
    else:
        color, stats["rays_cast"], stats["rays_cast_per_shard"] = _trace_on_mesh(
            scene, orig, dirn, ray_ids, settings, bounce_key, accel, uniforms, mesh, axis_name)
    color = from_tile_order(color, w, h, spp)
    film = color.reshape(spp, h, w, 3).mean(dim=0)
    film = clip01(film)
    if return_stats:
        return film, stats
    return film
