"""Vector helpers and batched intersection math over (R, 3) rows
(``atray_tpu/core/intersect.py``).

The miss sentinel, the minimum hit distance, ``dot``, ``cross`` and
``normalize`` with the reference's op order
(``v * reciprocal(sqrt(max(v.v, eps)))``); ``moller_trumbore``,
``sphere_hits`` and ``plane_hits``, the forms ``render.wavefront``'s
``nearest_hit_ids`` and ``resolve_hit`` use; ``safe_inv_dir`` and the slab
test ``aabb_entry_t`` of the skip-link walk (``accel/traverse.py``). A miss
is ``t = INF``.
"""

from __future__ import annotations

import torch

INF = 3.0e38        # miss sentinel (the reference's MAX_FLOAT stand-in)
T_MIN = 1.0e-4      # minimum hit distance (self-intersection guard)
_DENOM_EPS = 1.0e-12


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product over the trailing axis."""
    return torch.sum(a * b, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def normalize(v: torch.Tensor, eps: float = 1.0e-20) -> torch.Tensor:
    """Safe normalize over the trailing axis."""
    return v * torch.reciprocal(torch.sqrt(torch.clamp_min(dot(v, v), eps)))[..., None]


def moller_trumbore(orig, dirn, p0, e1, e2, backface_cull: bool = True):
    """Möller–Trumbore over broadcast-compatible (..., 3) rows: returns
    (t, u, v, hit), t = INF where ``hit`` is false. With ``backface_cull``
    only det > 1e-12 counts (the reference's culled variant)."""
    pvec = cross(dirn, e2)
    det = dot(e1, pvec)
    valid = det > _DENOM_EPS if backface_cull else torch.abs(det) > _DENOM_EPS
    inv_det = torch.where(valid, 1.0 / torch.where(valid, det, 1.0), 0.0)
    tvec = orig - p0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(dirn, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    hit = valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN)
    return torch.where(hit, t, INF), u, v, hit


def safe_inv_dir(dirn: torch.Tensor) -> torch.Tensor:
    """1/dir with +-INF for zero components (the slab test stays right for
    finite origins)."""
    zero = dirn == 0.0
    return torch.where(zero, torch.copysign(torch.full_like(dirn, INF), dirn),
                       1.0 / torch.where(zero, 1.0, dirn))


def aabb_entry_t(orig, inv_dir, box_min, box_max):
    """Slab test over broadcast-compatible (..., 3) rows: (t_entry, t_exit,
    hit), hit where [0, inf) overlaps the box (entry <= exit, exit > 0)."""
    t0 = (box_min - orig) * inv_dir
    t1 = (box_max - orig) * inv_dir
    t_entry = torch.amax(torch.minimum(t0, t1), dim=-1)
    t_exit = torch.amin(torch.maximum(t0, t1), dim=-1)
    return t_entry, t_exit, (t_entry <= t_exit) & (t_exit > 0.0)


def sphere_hits(orig, dirn, centers, radii):
    """Nearest sphere per ray over (S,) spheres: (t (R,), sid int32), -1 on
    a miss; ties go to the lower id. ``dirn`` must be unit length."""
    oc = orig[:, None, :] - centers[None, :, :]
    b = dot(oc, dirn[:, None, :])
    c = dot(oc, oc) - (radii * radii)[None, :]
    disc = b * b - c
    ok = disc > 0.0
    # sqrt guarded on both sides: sqrt'(0) = inf would turn the zero
    # cotangent of miss lanes into NaN
    sq = torch.where(ok, torch.sqrt(torch.where(ok, disc, 1.0)), 0.0)
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > T_MIN, t0, t1)
    t = torch.where(ok & (t > T_MIN), t, INF)
    sid = torch.argmin(t, dim=1)
    t_best = t.gather(1, sid[:, None])[:, 0]
    return t_best, torch.where(t_best < INF, sid, -1).to(torch.int32)


def plane_hits(orig, dirn, normals, offsets):
    """Nearest plane per ray over (P,) planes dot(n, x) = offset:
    (t (R,), pid int32), -1 on a miss; ties go to the lower id."""
    denom = dot(dirn[:, None, :], normals[None, :, :])
    num = offsets[None, :] - dot(orig[:, None, :], normals[None, :, :])
    ok = torch.abs(denom) > _DENOM_EPS
    t = torch.where(ok, num / torch.where(ok, denom, 1.0), INF)
    t = torch.where(t > T_MIN, t, INF)
    pid = torch.argmin(t, dim=1)
    t_best = t.gather(1, pid[:, None])[:, 0]
    return t_best, torch.where(t_best < INF, pid, -1).to(torch.int32)
