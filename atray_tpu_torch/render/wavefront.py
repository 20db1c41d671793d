"""Wavefront path tracer with path-replay gradients
(``atray_tpu/render/wavefront.py``).

All rays of a chunk advance together through the bounces: nearest hit,
sphere and plane patch-in, shading, respawn. Every per-ray quantity is a
flat (R,) plane, as in the reference. Every random number is a pure
function of (key, global ray id, bounce) (``render/rng.py``), so chunked,
compacted and whole-frame renders give the same film bit-for-bit.

Two hit paths, chosen by the accel:

- ``ShadedWideBVH`` (the production path): ``wide_shade`` returns t, face
  id, the interpolated normal and the material id in one kernel call. The
  call is a ``torch.autograd.Function`` whose backward replays
  Möller–Trumbore and the normal from the saved face id and the per-trace
  face table in plain PyTorch, so the backward never walks the BVH again.
- ``WideBVH`` (``make_accel``, the trainer's accel): ``nearest_hit_ids``
  walks it with ``wide_exact`` for integer hit ids, and the differentiable
  ``resolve_hit`` recomputes the hit from them. The ids are what each
  bounce keeps for the backward.

Gradients follow the detached-visibility convention: which primitive a ray
hits carries no derivative; t, barycentrics, normals and material
constants do, down to vertices, vertex normals, emission, albedo and
scatter. When autograd records the trace, each bounce's shading runs under
``torch.utils.checkpoint`` with the hit call outside it: the backward
recomputes the cheap elementwise shading and reuses the saved hit.

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

Not ported yet, and refused with NotImplementedError: NEE, AA jitter,
textures, the pair-binned traversal, explicit uniforms, hit overrides and
the brute-force triangle path (``accel=None`` with triangles). The
reference's TPU schedule switches (``ATRAY_*`` environment variables) are
not carried: they select film-identical variants.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from atray_tpu_torch.accel.shaded import ShadedWideBVH
from atray_tpu_torch.accel.wide import WideBVH
from atray_tpu_torch.config import RenderSettings
from atray_tpu_torch.core.camera import Camera, camera_rays
from atray_tpu_torch.core.intersect import (
    INF,
    cross,
    dot,
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
from atray_tpu_torch.kernels.wide_exact import wide_exact_first_hit
from atray_tpu_torch.kernels.wide_shade import wide_shade_planes
from atray_tpu_torch.render.rng import ray_uniform_cols, split
from atray_tpu_torch.scene.data import Scene

# primitive type codes of a hit record (the reference's)
PRIM_NONE = 0
PRIM_TRI = 1
PRIM_SPHERE = 2
PRIM_PLANE = 3


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


def _replay_hit(face_table, fid_c, ox, oy, oz, dx, dy, dz):
    """Differentiable recompute of a fused hit from its face id: t and the
    normalized barycentric normal, with the kernel's Möller–Trumbore and
    interpolation op order."""
    row = _rows(face_table, fid_c)                # one (R, 20) gather
    p0x, p0y, p0z = row[:, 0], row[:, 1], row[:, 2]
    e1x, e1y, e1z = row[:, 3], row[:, 4], row[:, 5]
    e2x, e2y, e2z = row[:, 6], row[:, 7], row[:, 8]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = torch.abs(det) > 1.0e-12
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tvx = ox - p0x
    tvy = oy - p0y
    tvz = oz - p0z
    uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    w0 = 1.0 - uu - vv
    nx = w0 * row[:, 9] + uu * row[:, 12] + vv * row[:, 15]
    ny = w0 * row[:, 10] + uu * row[:, 13] + vv * row[:, 16]
    nz = w0 * row[:, 11] + uu * row[:, 14] + vv * row[:, 17]
    return (tt, *_norm3(nx, ny, nz))


class _FusedHit(torch.autograd.Function):
    """Forward: the ``wide_shade`` kernel (t, nx, ny, nz, face id, material
    id). Backward: the hit replayed from the saved face id, ray planes and
    face table (``_replay_hit``), miss-lane cotangents zeroed; no walk."""

    @staticmethod
    def forward(ctx, accel, face_table, ox, oy, oz, dx, dy, dz, alive):
        fo = wide_shade_planes(accel, ox, oy, oz, dx, dy, dz, alive)
        ctx.mark_non_differentiable(fo["id"], fo["mat"])
        ctx.save_for_backward(face_table, ox, oy, oz, dx, dy, dz, fo["id"])
        return fo["t"], fo["nx"], fo["ny"], fo["nz"], fo["id"], fo["mat"]

    @staticmethod
    def backward(ctx, g_t, g_nx, g_ny, g_nz, _g_id, _g_mat):
        face_table, ox, oy, oz, dx, dy, dz, fid = ctx.saved_tensors
        need = ctx.needs_input_grad[1:8]
        if not any(need):
            return (None,) * 9
        hit = fid >= 0
        fid_c = torch.clamp(fid, 0, face_table.shape[0] - 1).long()
        with torch.enable_grad():
            ins = [x.detach().requires_grad_(r)
                   for x, r in zip((face_table, ox, oy, oz, dx, dy, dz), need)]
            outs = _replay_hit(ins[0], fid_c, *ins[1:])
            cot = [torch.where(hit, g, 0.0) for g in (g_t, g_nx, g_ny, g_nz)]
            grads = iter(torch.autograd.grad(outs, [x for x in ins if x.requires_grad], cot,
                                             allow_unused=True))
        return (None, *(next(grads) if r else None for r in need), None)


def fused_hit(scene: Scene, accel: Optional[ShadedWideBVH], face_table,
              ox, oy, oz, dx, dy, dz, alive):
    """Triangle-class nearest hit over a ``ShadedWideBVH``:
    (t, nx, ny, nz, face id, material id) as flat planes."""
    if scene.mesh.num_faces > 0:
        if accel is None:
            raise NotImplementedError(
                "accel=None with triangles: the brute-force triangle path is not "
                "ported yet; pass build_shaded_accel(scene) or make_accel(...)")
        return _FusedHit.apply(accel, face_table, ox, oy, oz, dx, dy, dz, alive)
    t = torch.full_like(ox, INF)
    zero = torch.zeros_like(ox)
    fid = torch.full(ox.shape, -1, dtype=torch.int32, device=ox.device)
    return t, zero, zero, zero, fid, torch.zeros_like(fid)


def _shade_fused(scene, face_table, ox, oy, oz, dx, dy, dz, t, nx, ny, nz, fid, mat):
    """Hit planes of the fused path: material constants from the material
    id, then spheres and planes patched in."""
    hit = fid >= 0
    mats = resolve_material_comps(scene, mat, hit)
    return _patch_spheres_planes(scene, ox, oy, oz, dx, dy, dz, t, nx, ny, nz, hit, *mats)


# ---------------------------------------------------------------------------
# The gather path (WideBVH): integer hit ids + differentiable resolve
# ---------------------------------------------------------------------------


@torch.no_grad()
def nearest_hit_ids(scene: Scene, orig: torch.Tensor, dirn: torch.Tensor,
                    accel: Optional[WideBVH] = None) -> HitIds:
    """Nearest primitive per ray over every class: triangles through the
    ``wide_exact`` walk of a ``WideBVH``, then spheres, then planes, a later
    class winning only on a strictly smaller t. Detached by intent."""
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
            raise NotImplementedError(
                "accel=None with triangles: the brute-force triangle path is not "
                "ported yet; pass make_accel(...)")
        if not isinstance(accel, WideBVH):
            raise TypeError(f"nearest_hit_ids takes a WideBVH, not {type(accel).__name__}")
        t, _, _, tid = wide_exact_first_hit(accel, o, d)
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


def _shade_standard(scene, face_table, ox, oy, oz, dx, dy, dz, prim_type, prim_id, t_hit):
    """Hit planes of the gather path from the saved ids."""
    o3 = torch.stack([ox, oy, oz], dim=1)
    d3 = torch.stack([dx, dy, dz], dim=1)
    t, n, mat, hit = resolve_hit(scene, o3, d3, HitIds(prim_type, prim_id, t_hit), face_table)
    return (t, n[:, 0], n[:, 1], n[:, 2], hit, *resolve_material_comps(scene, mat, hit))


# ---------------------------------------------------------------------------
# Bounces
# ---------------------------------------------------------------------------


def _shade_bounce(scene, face_table, shade_hit, key, b, ox, oy, oz, dx, dy, dz,
                  wr, wg, wb, cr, cg, cb, alive, gid, *hit):
    """Everything of a bounce after the hit query: hit planes from the
    saved hit, shading, respawn. Pure elementwise work, recomputed in the
    backward when checkpointed."""
    u0, u1, u2 = ray_uniform_cols(key, gid, b, 3)
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

    cr = cr + torch.where(live_hit, wr * emr, 0.0)
    cg = cg + torch.where(live_hit, wg * emg, 0.0)
    cb = cb + torch.where(live_hit, wb * emb, 0.0)

    # t is INF on misses: zero it so the untaken branch stays finite
    t_safe = torch.where(hit_m, t, 0.0)
    hx = ox + t_safe * dx
    hy = oy + t_safe * dy
    hz = oz + t_safe * dz

    wr = torch.where(live_hit, wr * alr * atten, wr)
    wg = torch.where(live_hit, wg * alg * atten, wg)
    wb = torch.where(live_hit, wb * alb * atten, wb)

    ndx, ndy, ndz = _bounce_dir_soa(dx, dy, dz, nxo, nyo, nzo, scat, u0, u1, u2)
    alive = live_hit
    # park dead rays far outside the scene, pointing +z
    return (torch.where(alive, hx, 1.0e7), torch.where(alive, hy, 1.0e7),
            torch.where(alive, hz, 1.0e7), torch.where(alive, ndx, 0.0),
            torch.where(alive, ndy, 0.0), torch.where(alive, ndz, 1.0),
            wr, wg, wb, cr, cg, cb, alive)


def _records(scene: Scene, *xs: torch.Tensor) -> bool:
    """Whether autograd records work on ``xs`` and the scene's float leaves."""
    return torch.is_grad_enabled() and any(
        x.requires_grad for x in (*xs, *scene.params().leaves()))


def _face_table_for(scene: Scene, accel, record: bool) -> Optional[torch.Tensor]:
    """The face table where a pass reads it: the gather path's
    ``resolve_hit`` always, the fused hit's backward replay only when
    autograd records."""
    if record or isinstance(accel, WideBVH):
        return build_face_table(scene)
    return None


def bounce_step(scene: Scene, accel, face_table, st: WaveState, b: int, key) -> WaveState:
    """One wavefront bounce over flat (R,) planes: the hit query, then
    ``_shade_bounce``, checkpointed when autograd records it."""
    ox, oy, oz, dx, dy, dz = st.ox, st.oy, st.oz, st.dx, st.dy, st.dz
    # rays cast = live paths entering the bounce
    rc = st.rc + st.alive.sum()
    if isinstance(accel, WideBVH):
        ids = nearest_hit_ids(scene, torch.stack([ox, oy, oz], dim=1),
                              torch.stack([dx, dy, dz], dim=1), accel)
        hit, shade_hit = tuple(ids), _shade_standard
    else:
        hit = fused_hit(scene, accel, face_table, ox, oy, oz, dx, dy, dz, st.alive)
        shade_hit = _shade_fused

    def shade(*planes):
        return _shade_bounce(scene, face_table, shade_hit, key, b, *planes)

    args = (*st[:14], *hit)
    if _records(scene, *st[:12]):
        out = checkpoint(shade, *args, use_reentrant=False)
    else:
        out = shade(*args)
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


def _refuse(nee=False, pair_bounces=False, anti_aliasing=False):
    for name, on in (("nee", nee), ("pair_bounces", pair_bounces),
                     ("anti_aliasing", anti_aliasing)):
        if on:
            raise NotImplementedError(f"{name}=True is not ported yet")


def _accel_on(accel, dev: torch.device):
    """A host accel uploaded to ``dev``; an uploaded one must be there."""
    if accel is None:
        return None
    if not isinstance(accel, (ShadedWideBVH, WideBVH)):
        raise TypeError(f"unknown accel type {type(accel).__name__}")
    if not isinstance(accel.cboxes, torch.Tensor):
        return accel.to(dev)
    if accel.device != dev:
        raise ValueError(f"accel is on {accel.device}, the rays on {dev}")
    return accel


def trace_radiance(scene: Scene, orig: torch.Tensor, dirn: torch.Tensor,
                   bounce_limit: int, key, accel=None,
                   sort_rays: bool = False, nee: bool = False,
                   return_stats: bool = False,
                   ray_ids: Optional[torch.Tensor] = None,
                   lane_pack: bool = True, pair_bounces: bool = False):
    """Path-trace each ray to its radiance (R, 3) on the rays' device (the
    scene and a host accel are moved there). ``accel`` is a
    ``ShadedWideBVH`` (fused hit) or a ``WideBVH`` (gather path). ``key``
    is the uint32[2] bounce key; ``ray_ids`` (default 0..R-1) are the global
    ids that key the per-ray random numbers. Differentiable with respect
    to the scene's float leaves and the rays. With ``return_stats`` also
    returns ``{"rays_cast": int64 tensor}``, the live paths summed over
    bounces."""
    _refuse(nee=nee, pair_bounces=pair_bounces)
    if scene.texture is not None:
        raise NotImplementedError("textured scenes are not ported yet")
    dev = orig.device
    scene = scene.to(dev)
    accel = _accel_on(accel, dev)
    if ray_ids is None:
        ray_ids = torch.arange(orig.shape[0], dtype=torch.int32, device=dev)
    face_table = _face_table_for(scene, accel, _records(scene, orig, dirn))
    color, rays_cast = _trace(scene, accel, face_table, orig, dirn, ray_ids,
                              bounce_limit, key, sort_rays, lane_pack)
    if return_stats:
        return color, {"rays_cast": rays_cast}
    return color


def _trace(scene, accel, face_table, orig, dirn, ray_ids, bounce_limit, key,
           sort_rays, lane_pack):
    """The bounce loop of ``trace_radiance`` on a scene and accel already on
    the rays' device: (color (R, 3), rays_cast)."""
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

    def step(st, b):
        return bounce_step(scene, accel, face_table, st, b, key)

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


def _trace_chunked(scene, orig, dirn, ray_ids, settings: RenderSettings, key, accel):
    """Trace a flat ray set in chunks of ``settings.ray_chunk`` (a Python
    loop; the last chunk is padded with parked rays), on a scene and accel
    already on the rays' device. The face table is built once for all
    chunks. Returns (color (N, 3), rays_cast)."""
    n = orig.shape[0]
    chunk = settings.ray_chunk
    face_table = _face_table_for(scene, accel, _records(scene, orig, dirn))
    bounce_args = (settings.bounce_limit, key, settings.sort_bounces, settings.lane_pack)
    if not chunk or chunk >= n:
        return _trace(scene, accel, face_table, orig, dirn, ray_ids, *bounce_args)
    pad = (-n) % chunk
    if pad:
        dev = orig.device
        orig = torch.cat([orig, torch.full((pad, 3), 1.0e7, dtype=orig.dtype, device=dev)])
        park = torch.tensor([[0.0, 0.0, 1.0]], dtype=dirn.dtype, device=dev)
        dirn = torch.cat([dirn, park.expand(pad, 3)])
        ray_ids = torch.cat([ray_ids, ray_ids[-1] + 1 + torch.arange(
            pad, dtype=ray_ids.dtype, device=dev)])
    colors, rays_cast = [], 0
    for s in range(0, orig.shape[0], chunk):
        color, rc = _trace(scene, accel, face_table, orig[s:s + chunk], dirn[s:s + chunk],
                           ray_ids[s:s + chunk], *bounce_args)
        colors.append(color)
        rays_cast = rays_cast + rc
    return torch.cat(colors)[:n], rays_cast


def clip01(x: torch.Tensor) -> torch.Tensor:
    """Clamp to [0, 1] with ``jnp.clip``'s gradient: at an exact bound each
    side of the min/max gets half (``torch.clamp`` would pass all of it),
    so black pixels at exactly 0 still carry half their emission gradient."""
    return torch.minimum(torch.maximum(x, torch.zeros_like(x)), torch.ones_like(x))


def render(scene: Scene, camera: Camera, settings: RenderSettings, key,
           accel=None, return_stats: bool = False, device=None):
    """Full render -> linear-RGB film (H, W, 3) in [0, 1] on ``device``
    (None: "cuda"; "cpu" runs the plain versions of the kernels). A host
    scene or accel is moved there. ``key`` is a uint32[2] key
    (``rng.prng_key(seed)``); it splits into an anti-aliasing key and the
    bounce key, as in the reference. Differentiable with respect to the
    scene's float leaves (``Scene.with_params``); the film clamp is
    ``clip01``."""
    _refuse(nee=settings.nee, pair_bounces=settings.pair_bounces,
            anti_aliasing=settings.anti_aliasing)
    if scene.texture is not None:
        raise NotImplementedError("textured scenes are not ported yet")
    dev = resolve_device(device)
    scene = scene.to(dev)
    accel = _accel_on(accel, dev)
    w, h = settings.resolution
    spp = settings.samples_per_pixel
    _aa_key, bounce_key = split(np.asarray(key, np.uint32))
    orig, dirn = camera_rays(camera, w, h, spp, device=dev)
    orig = to_tile_order(orig, w, h, spp)
    dirn = to_tile_order(dirn, w, h, spp)
    ray_ids = torch.arange(orig.shape[0], dtype=torch.int32, device=dev)
    color, rays_cast = _trace_chunked(scene, orig, dirn, ray_ids, settings,
                                      bounce_key, accel)
    color = from_tile_order(color, w, h, spp)
    film = color.reshape(spp, h, w, 3).mean(dim=0)
    film = clip01(film)
    if return_stats:
        return film, {"rays_cast": rays_cast}
    return film
