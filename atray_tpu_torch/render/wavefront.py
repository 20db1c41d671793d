"""Wavefront path tracer, forward pass (``atray_tpu/render/wavefront.py``).

All rays of a chunk advance together through the bounces: nearest hit
(the ``wide_shade`` kernel), sphere and plane patch-in, shading, respawn.
Every per-ray quantity is a flat (R,) plane, as in the reference. Every
random number is a pure function of (key, global ray id, bounce)
(``render/rng.py``), so chunked, compacted and whole-frame renders give the
same film bit-for-bit.

Schedule (the reference's production one): bounce 0, then the first
diffuse bounce at full width, then ONE compaction (``compact_state``: rows
sorted by origin cell with dead rays last, then live rays packed to a lane
prefix by the ``lane_take`` kernel), then the remaining bounces. Python
loops take the place of ``lax.scan`` and ``lax.map``.

Shading convention (shared with the reference and its oracle):
- miss -> color += weight * emission[0] (sky), the path ends;
- hit  -> attenuation = dot(-d, n), 0 if the normal had to be flipped;
  color += weight * emission[m]; weight *= albedo[m] * attenuation; the
  next direction blends a jittered diffuse and a mirror bounce by scatter.

Not ported yet, and refused with NotImplementedError: NEE, AA jitter,
textures, the pair-binned traversal, explicit uniforms, hit overrides,
the brute-force triangle path (``accel=None`` with triangles) and
gradients (the slice runs under ``torch.no_grad``). The reference's TPU
schedule switches (``ATRAY_*`` environment variables) are not carried:
they select film-identical variants.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from atray_tpu_torch.accel.shaded import ShadedWideBVH
from atray_tpu_torch.config import RenderSettings
from atray_tpu_torch.core.camera import Camera, camera_rays
from atray_tpu_torch.core.intersect import INF, cross, normalize
from atray_tpu_torch.kernels.lane_pack import lane_take, pack_indices, unpack_indices
from atray_tpu_torch.kernels.wide_shade import wide_shade_planes
from atray_tpu_torch.render.rng import ray_uniform_cols, split
from atray_tpu_torch.scene.data import Scene


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


def build_face_table(scene: Scene) -> Optional[torch.Tensor]:
    """(T, 20) per-face table [p0, e1, e2, n0, n1, n2, material_id, pad];
    faces without smooth normals get the flat normal in all three slots.
    The forward slice does not read it; NEE and the gradient replay will."""
    mesh = scene.mesh
    if mesh.num_faces == 0:
        return None
    v = mesh.vertices
    f = mesh.faces.long()
    p0 = v[f[:, 0]]
    e1 = v[f[:, 1]] - p0
    e2 = v[f[:, 2]] - p0
    flat_n = normalize(cross(e1, e2))
    nidx = mesh.face_normal_idx.long()
    has_smooth = (nidx[:, 0] >= 0)[:, None]
    ncl = torch.clamp(nidx, 0, mesh.normals.shape[0] - 1)
    n0 = torch.where(has_smooth, mesh.normals[ncl[:, 0]], flat_n)
    n1 = torch.where(has_smooth, mesh.normals[ncl[:, 1]], flat_n)
    n2 = torch.where(has_smooth, mesh.normals[ncl[:, 2]], flat_n)
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


def fused_hit_shade(scene: Scene, accel: Optional[ShadedWideBVH],
                    ox, oy, oz, dx, dy, dz, alive):
    """Nearest hit over every primitive class as flat planes
    (t, nx, ny, nz, hit, em_r, em_g, em_b, al_r, al_g, al_b, scatter):
    triangles through ``wide_shade_planes``, material constants from the
    returned material id, then spheres and planes patched in."""
    if scene.mesh.num_faces > 0:
        if accel is None:
            raise NotImplementedError(
                "accel=None with triangles: the brute-force triangle path is not "
                "ported yet; pass build_shaded_accel(scene).to(device)")
        fo = wide_shade_planes(accel, ox, oy, oz, dx, dy, dz, alive)
        t, nx, ny, nz = fo["t"], fo["nx"], fo["ny"], fo["nz"]
        hit = fo["id"] >= 0
        mats = resolve_material_comps(scene, fo["mat"], hit)
    else:
        t = torch.full_like(ox, INF)
        nx = ny = nz = torch.zeros_like(ox)
        hit = torch.zeros_like(alive)
        mats = (torch.zeros_like(ox),) * 7
    return _patch_spheres_planes(scene, ox, oy, oz, dx, dy, dz, t, nx, ny, nz,
                                 hit, *mats)


def bounce_step(scene: Scene, accel, st: WaveState, b: int, key) -> WaveState:
    """One wavefront bounce over flat (R,) planes."""
    ox, oy, oz, dx, dy, dz = st.ox, st.oy, st.oz, st.dx, st.dy, st.dz
    wr, wg, wb, cr, cg, cb, alive = st.wr, st.wg, st.wb, st.cr, st.cg, st.cb, st.alive
    u0, u1, u2 = ray_uniform_cols(key, st.gid, b, 3)
    # rays cast = live paths entering the bounce
    rc = st.rc + alive.sum()

    (t, nx, ny, nz, hit, emr, emg, emb, alr, alg, alb,
     scat) = fused_hit_shade(scene, accel, ox, oy, oz, dx, dy, dz, alive)

    sky = scene.materials.emission[0]
    miss_now = alive & ~hit
    cr = cr + torch.where(miss_now, wr * sky[0], 0.0)
    cg = cg + torch.where(miss_now, wg * sky[1], 0.0)
    cb = cb + torch.where(miss_now, wb * sky[2], 0.0)

    live_hit = alive & hit
    cos_in = -(dx * nx + dy * ny + dz * nz)
    backface = cos_in < 0.0
    nxo = torch.where(backface, -nx, nx)
    nyo = torch.where(backface, -ny, ny)
    nzo = torch.where(backface, -nz, nz)
    atten = torch.where(backface, 0.0, cos_in)

    cr = cr + torch.where(live_hit, wr * emr, 0.0)
    cg = cg + torch.where(live_hit, wg * emg, 0.0)
    cb = cb + torch.where(live_hit, wb * emb, 0.0)

    t_safe = torch.where(hit, t, 0.0)
    hx = ox + t_safe * dx
    hy = oy + t_safe * dy
    hz = oz + t_safe * dz

    wr = torch.where(live_hit, wr * alr * atten, wr)
    wg = torch.where(live_hit, wg * alg * atten, wg)
    wb = torch.where(live_hit, wb * alb * atten, wb)

    ndx, ndy, ndz = _bounce_dir_soa(dx, dy, dz, nxo, nyo, nzo, scat, u0, u1, u2)
    alive = live_hit
    # park dead rays far outside the scene, pointing +z
    return WaveState(
        torch.where(alive, hx, 1.0e7), torch.where(alive, hy, 1.0e7),
        torch.where(alive, hz, 1.0e7), torch.where(alive, ndx, 0.0),
        torch.where(alive, ndy, 0.0), torch.where(alive, ndz, 1.0),
        wr, wg, wb, cr, cg, cb, alive, st.gid, rc,
    )


def _spread3(x):
    """Spread up to 10 bits so bit k lands at position 3k (Morton)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


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
    """Stable live-ray packing of the state with ONE ``lane_take`` over 14
    planes of 32-bit words: the 12 float planes (bit views), liveness and
    the int32 global ray id, which therefore stays exact at any size.
    Returns the packed state and ``lane_restore(cr, cg, cb)``, which routes
    results back; rays already dead at pack time keep their radiance."""
    alive = st.alive
    pidx = pack_indices(alive)
    uidx = unpack_indices(alive)
    floats = (st.ox, st.oy, st.oz, st.dx, st.dy, st.dz,
              st.wr, st.wg, st.wb, st.cr, st.cg, st.cb)
    cols = torch.stack([x.view(torch.int32) for x in floats]
                       + [alive.to(torch.int32), st.gid.to(torch.int32)])
    pk = lane_take(cols, pidx)

    def f(k):
        return pk[k].view(torch.float32)

    alive2 = pk[12] != 0
    packed = WaveState(
        torch.where(alive2, f(0), 1.0e7), torch.where(alive2, f(1), 1.0e7),
        torch.where(alive2, f(2), 1.0e7), torch.where(alive2, f(3), 0.0),
        torch.where(alive2, f(4), 0.0), torch.where(alive2, f(5), 1.0),
        f(6), f(7), f(8), f(9), f(10), f(11), alive2, pk[13], st.rc,
    )
    c_pre = (st.cr, st.cg, st.cb)

    def lane_restore(cr, cg, cb):
        up = lane_take(torch.stack([x.view(torch.int32) for x in (cr, cg, cb)]), uidx)
        return tuple(torch.where(alive, up[k].view(torch.float32), c_pre[k])
                     for k in range(3))

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
            return x.reshape(rows, lane)[p].reshape(-1)
    else:
        perm = torch.argsort(keys, stable=True)

        def take(x, p):
            return x[p]

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


@torch.no_grad()
def trace_radiance(scene: Scene, orig: torch.Tensor, dirn: torch.Tensor,
                   bounce_limit: int, key, accel: Optional[ShadedWideBVH] = None,
                   sort_rays: bool = False, nee: bool = False,
                   return_stats: bool = False,
                   ray_ids: Optional[torch.Tensor] = None,
                   lane_pack: bool = True, pair_bounces: bool = False):
    """Path-trace each ray to its radiance (R, 3). ``key`` is the uint32[2]
    bounce key; ``ray_ids`` (default 0..R-1) are the global ids that key
    the per-ray random numbers. With ``return_stats`` also returns
    ``{"rays_cast": int64 tensor}``, the live paths summed over bounces."""
    _refuse(nee=nee, pair_bounces=pair_bounces)
    if scene.texture is not None:
        raise NotImplementedError("textured scenes are not ported yet")
    dev = orig.device
    r = orig.shape[0]
    if ray_ids is None:
        ray_ids = torch.arange(r, dtype=torch.int32, device=dev)
    ones = torch.ones(r, dtype=torch.float32, device=dev)
    zeros = torch.zeros(r, dtype=torch.float32, device=dev)
    st = WaveState(
        orig[:, 0].contiguous(), orig[:, 1].contiguous(), orig[:, 2].contiguous(),
        dirn[:, 0].contiguous(), dirn[:, 1].contiguous(), dirn[:, 2].contiguous(),
        ones, ones, ones, zeros, zeros, zeros,
        torch.ones(r, dtype=torch.bool, device=dev), ray_ids.to(torch.int32),
        torch.zeros((), dtype=torch.int64, device=dev),
    )

    start = 0
    if bounce_limit > 0:
        st = bounce_step(scene, accel, st, 0, key)
        start = 1
    restore = None
    if sort_rays and bounce_limit > start + 1:
        # the first diffuse bounce runs at full width, then compact once
        st = bounce_step(scene, accel, st, start, key)
        start += 1
        st, restore = compact_state(scene, st, lane_pack)
    for b in range(start, bounce_limit):
        st = bounce_step(scene, accel, st, b, key)

    cr, cg, cb = st.cr, st.cg, st.cb
    if restore is not None:
        cr, cg, cb = restore(cr, cg, cb)
    color = torch.stack([cr, cg, cb], dim=1)
    if return_stats:
        return color, {"rays_cast": st.rc}
    return color


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
    loop; the last chunk is padded with parked rays). Returns (color (N, 3),
    rays_cast)."""
    n = orig.shape[0]
    chunk = settings.ray_chunk
    kw = dict(accel=accel, sort_rays=settings.sort_bounces, return_stats=True,
              lane_pack=settings.lane_pack)
    if not chunk or chunk >= n:
        color, stats = trace_radiance(scene, orig, dirn, settings.bounce_limit, key,
                                      ray_ids=ray_ids, **kw)
        return color, stats["rays_cast"]
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
        color, stats = trace_radiance(scene, orig[s:s + chunk], dirn[s:s + chunk],
                                      settings.bounce_limit, key,
                                      ray_ids=ray_ids[s:s + chunk], **kw)
        colors.append(color)
        rays_cast = rays_cast + stats["rays_cast"]
    return torch.cat(colors)[:n], rays_cast


@torch.no_grad()
def render(scene: Scene, camera: Camera, settings: RenderSettings, key,
           accel: Optional[ShadedWideBVH] = None, return_stats: bool = False):
    """Full forward render -> linear-RGB film (H, W, 3) in [0, 1] on the
    scene's device. ``key`` is a uint32[2] key (``rng.prng_key(seed)``);
    it splits into an anti-aliasing key and the bounce key, as in the
    reference. Scene and accel must be on one device (``.to(device)``); a
    CPU device runs the plain versions of the kernels, a CUDA device the
    kernels."""
    _refuse(nee=settings.nee, pair_bounces=settings.pair_bounces,
            anti_aliasing=settings.anti_aliasing)
    if not isinstance(scene.materials.emission, torch.Tensor):
        scene = scene.to("cpu")
    dev = scene.device
    if accel is not None:
        if not isinstance(accel.cboxes, torch.Tensor) and dev.type == "cpu":
            accel = accel.to(dev)
        if accel.device != dev:
            raise ValueError(f"accel is on {accel.device}, scene on {dev}")
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
    film = color.reshape(spp, h, w, 3).mean(dim=0).clamp(0.0, 1.0)
    if return_stats:
        return film, {"rays_cast": rays_cast}
    return film
