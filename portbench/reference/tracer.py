"""The reference path tracer: a scene of triangles (smooth vertex
normals, a material each) and planes, lit by the sky of material 0.

Every ray starts with weight 1 and radiance 0. At each bounce the nearest
surface is found (triangles through ``bvh``; a plane wins only where it is
strictly nearer). A ray that meets nothing adds weight x sky and ends. A
ray that hits adds weight x the material's emission, takes weight x albedo
x cos (0 for a back face, whose normal is flipped), and leaves in the
direction normalize(lerp(normalize(n + u), mirror(d, n), scatter)), u the
ray's three uniforms of that bounce in [-1, 1). The hit's t, normal (the
face's vertex normals interpolated at its barycentrics) and constants are
computed again from the triangle it hit, so gradients reach the vertices
and the albedo; which triangle is hit carries no derivative.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from portbench.reference import bvh
from portbench.reference.rng import uniform_cols

INF = bvh.INF


@dataclasses.dataclass
class Scene:
    vertices: torch.Tensor      # (V, 3)
    faces: torch.Tensor         # (T, 3) int64
    normals: torch.Tensor       # (V, 3) vertex normals
    tri_mat: torch.Tensor       # (T,) int64
    emission: torch.Tensor      # (M, 3); row 0 is the sky
    albedo: torch.Tensor        # (M, 3)
    scatter: torch.Tensor       # (M,)
    plane_n: torch.Tensor       # (P, 3)
    plane_off: torch.Tensor     # (P,)
    plane_mat: torch.Tensor     # (P,) int64

    def triangles(self) -> torch.Tensor:
        """(T, 9): p0, e1, e2 of every face, differentiable in the vertices."""
        v, f = self.vertices, self.faces
        p0 = v[f[:, 0]]
        return torch.cat([p0, v[f[:, 1]] - p0, v[f[:, 2]] - p0], dim=1)

    def cast(self, dtype) -> "Scene":
        """The scene with its float tables in ``dtype``."""
        return dataclasses.replace(self, **{
            k: getattr(self, k).to(dtype) for k in
            ("vertices", "normals", "emission", "albedo", "scatter", "plane_n", "plane_off")})


def _norm3(x, y, z):
    r = torch.reciprocal(torch.sqrt(torch.clamp_min(x * x + y * y + z * z, 1.0e-20)))
    return x * r, y * r, z * r


def trace(scene: Scene, tree: bvh.Tree, orig: torch.Tensor, dirn: torch.Tensor,
          ray_ids: torch.Tensor, key, bounces: int, tri: Optional[torch.Tensor] = None):
    """Radiance (R, 3) of the rays (R, 3) whose global ids ``ray_ids``
    key their uniforms under ``key``, over ``bounces`` bounces. ``tri``
    (``scene.triangles()``) may be passed in to share it between calls."""
    tri = scene.triangles() if tri is None else tri
    dt = orig.dtype
    r = orig.shape[0]
    dev = orig.device
    ox, oy, oz = orig.unbind(1)
    dx, dy, dz = dirn.unbind(1)
    one = torch.ones(r, dtype=dt, device=dev)
    wr, wg, wb = one, one, one
    cr = cg = cb = torch.zeros(r, dtype=dt, device=dev)
    alive = torch.ones(r, dtype=torch.bool, device=dev)
    sky = scene.emission[0]
    for b in range(bounces):
        u0, u1, u2 = (u.to(dt) for u in uniform_cols(key, ray_ids, b))
        live = torch.nonzero(alive).squeeze(1)
        fid = torch.full((r,), -1, dtype=torch.int64, device=dev)
        with torch.no_grad():
            o3 = torch.stack([ox, oy, oz], dim=1)[live]
            d3 = torch.stack([dx, dy, dz], dim=1)[live]
            fid[live] = bvh.closest_hit(tree, tri, o3, d3)[1]
        fc = torch.clamp(fid, 0)
        tt, uu, vv, ok = bvh.moller_trumbore(ox, oy, oz, dx, dy, dz, tri[fc])
        hit = (fid >= 0) & ok
        t = torch.where(hit, tt, INF)
        w0 = 1.0 - uu - vv
        vn = [scene.normals[scene.faces[fc, k]] for k in range(3)]
        nx, ny, nz = _norm3(*(w0 * vn[0][:, a] + uu * vn[1][:, a] + vv * vn[2][:, a]
                              for a in range(3)))
        mat = scene.tri_mat[fc]
        em = [torch.where(hit, scene.emission[mat, a], 0.0) for a in range(3)]
        al = [torch.where(hit, scene.albedo[mat, a], 0.0) for a in range(3)]
        sc = torch.where(hit, scene.scatter[mat], 0.0)
        for p in range(scene.plane_n.shape[0]):
            pn = scene.plane_n[p]
            den = dx * pn[0] + dy * pn[1] + dz * pn[2]
            num = scene.plane_off[p] - (ox * pn[0] + oy * pn[1] + oz * pn[2])
            okp = torch.abs(den) > 1.0e-12
            tp = num / torch.where(okp, den, 1.0)
            tp = torch.where(okp & (tp > bvh.T_MIN), tp, INF)
            near = tp < t
            m = scene.plane_mat[p]
            t = torch.where(near, tp, t)
            nx, ny, nz = (torch.where(near, pn[a], c) for a, c in enumerate((nx, ny, nz)))
            em = [torch.where(near, scene.emission[m, a], c) for a, c in enumerate(em)]
            al = [torch.where(near, scene.albedo[m, a], c) for a, c in enumerate(al)]
            sc = torch.where(near, scene.scatter[m], sc)
            hit = hit | near
        miss = alive & ~hit
        cr = cr + torch.where(miss, wr * sky[0], 0.0)
        cg = cg + torch.where(miss, wg * sky[1], 0.0)
        cb = cb + torch.where(miss, wb * sky[2], 0.0)
        lh = alive & hit
        cos_in = -(dx * nx + dy * ny + dz * nz)
        back = cos_in < 0.0
        nx, ny, nz = (torch.where(back, -c, c) for c in (nx, ny, nz))
        atten = torch.where(back, 0.0, cos_in)
        cr = cr + torch.where(lh, wr * em[0], 0.0)
        cg = cg + torch.where(lh, wg * em[1], 0.0)
        cb = cb + torch.where(lh, wb * em[2], 0.0)
        ts = torch.where(hit, t, 0.0)
        hx, hy, hz = ox + ts * dx, oy + ts * dy, oz + ts * dz
        wr = torch.where(lh, wr * al[0] * atten, wr)
        wg = torch.where(lh, wg * al[1] * atten, wg)
        wb = torch.where(lh, wb * al[2] * atten, wb)
        rx, ry, rz = _norm3(nx + u0, ny + u1, nz + u2)
        dn = dx * nx + dy * ny + dz * nz
        px, py, pz = dx - 2.0 * dn * nx, dy - 2.0 * dn * ny, dz - 2.0 * dn * nz
        ndx, ndy, ndz = _norm3(rx + (px - rx) * sc, ry + (py - ry) * sc, rz + (pz - rz) * sc)
        alive = lh
        ox, oy, oz = (torch.where(alive, h, 1.0e7) for h in (hx, hy, hz))
        dx = torch.where(alive, ndx, 0.0)
        dy = torch.where(alive, ndy, 0.0)
        dz = torch.where(alive, ndz, 1.0)
    return torch.stack([cr, cg, cb], dim=1)
