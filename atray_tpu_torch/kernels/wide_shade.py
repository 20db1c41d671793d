"""Fused nearest hit + shading data over a ``ShadedWideBVH``
(``atray_tpu/kernels/wide_shade.py``).

``wide_shade_planes`` is the wrapper the renderer calls. It takes flat (R,)
float32 ray planes and a bool alive mask and returns, per ray, ``t``,
``id`` (int32 face id), the barycentric shading normal ``nx, ny, nz``
(normalized) and ``mat`` (int32 material id). A miss is (INF, -1, 0, 0, 0,
0); dead rays get the same sentinel without walking.

With ``stats=True`` it also returns two int32 (R,) planes, the
reference's traversal statistics: ``node_visits``, the nodes the ray
popped, and ``leaf_visits``, the leaves whose records it tested (0 for a
dead ray). The reference counts per pair of 8x128 lockstep blocks and
copies the count to every ray of the pair; here the walk is per ray, so
the counts are per ray. The hit planes are the same with stats on or off.

On a CUDA tensor it launches ``csrc/wide_shade.cu`` (one thread per ray,
over the accel's derived tables ``cnodes``, one 256-byte record per node,
and ``cleaves``, the leaves' geometry as planes); on a CPU tensor it runs
``wide_shade_planes_ref``, the plain PyTorch version of the same walk:
same tables, same slab and Möller–Trumbore op order, same per-ray visit
order, so the two agree bit-for-bit where the device's arithmetic is IEEE
(the kernel is built with ``--fmad=false``), counts included. The TPU
kernel's block-level knobs (``block_sub``, ``n_inter``, ``multi_pop``,
``octant_split``, ``ordered``) have no counterpart: they shape a lockstep
walk, not its result.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from atray_tpu_torch.accel.shaded import RECS_PER_ROW, STRIDE32, ShadedWideBVH
from atray_tpu_torch.core.intersect import INF
from atray_tpu_torch.kernels import _build
from atray_tpu_torch.kernels._plain import inv_dir, record_hit

STACK_CAP = 128     # per-thread stack entries; ATRAY_STACK_CAP in the .cu
OUTPUTS = ("t", "id", "nx", "ny", "nz", "mat")
STATS = ("node_visits", "leaf_visits")
COUNTER = _build.COUNTERS["wide_shade"]
_EMPTY_GUARD = -2147483647   # links <= this are empty slots (INT32_MIN)


def _check(accel: ShadedWideBVH, planes, alive) -> torch.device:
    dev = alive.device
    n = alive.shape[0]
    if alive.dtype != torch.bool or alive.dim() != 1:
        raise TypeError("alive must be a 1-D bool tensor")
    for p in planes:
        if p.dtype != torch.float32 or p.shape != (n,) or p.device != dev:
            raise TypeError("ray planes must be (R,) float32 on the alive mask's device")
        if not p.is_contiguous():
            raise ValueError("ray planes must be contiguous")
    tabs = {"cboxes": (accel.cboxes, torch.float32), "clinks": (accel.clinks, torch.int32),
            "caxis": (accel.caxis, torch.int32), "tris": (accel.tris, torch.float32)}
    for name, (tab, dtype) in tabs.items():
        if not isinstance(tab, torch.Tensor) or tab.device != dev or tab.dtype != dtype:
            raise TypeError(f"accel.{name} must be a {dtype} tensor on {dev}: "
                            "call ShadedWideBVH.to(device)")
        if not tab.is_contiguous():
            raise ValueError(f"accel.{name} must be contiguous")
    w = accel.num_nodes
    if accel.cboxes.shape != (w, 128) or accel.clinks.shape != (8, w) or accel.caxis.shape != (1, w):
        raise ValueError("accel node tables do not match num_nodes")
    if accel.tris.dim() != 2 or accel.tris.shape[1] != 128:
        raise ValueError("accel.tris must be (rows, 128)")
    if accel.leaf_size > RECS_PER_ROW and accel.leaf_size % RECS_PER_ROW:
        raise ValueError("leaf_size must be <= 4 or a multiple of 4")
    if 8 * (accel.max_depth + 2) > STACK_CAP:
        raise ValueError(
            f"wide depth {accel.max_depth} needs a stack of "
            f"{8 * (accel.max_depth + 2)} > STACK_CAP {STACK_CAP}")
    return dev


def wide_shade_planes(accel: ShadedWideBVH, ox, oy, oz, dx, dy, dz,
                      alive, stats: bool = False) -> Dict[str, torch.Tensor]:
    """Nearest hit + shading data; see the module docstring."""
    dev = _check(accel, (ox, oy, oz, dx, dy, dz), alive)
    if dev.type == "cpu":
        return wide_shade_planes_ref(accel, ox, oy, oz, dx, dy, dz, alive, stats=stats)
    if dev.type != "cuda":
        raise TypeError(f"no wide_shade kernel for device {dev}")
    lib = _build.load()
    if lib.atray_wide_shade_stack_cap() != STACK_CAP:
        raise RuntimeError("STACK_CAP disagrees with the compiled kernel")
    n = alive.shape[0]
    out = {k: torch.empty(n, dtype=torch.float32, device=dev) for k in ("t", "nx", "ny", "nz")}
    for k in ("id", "mat") + (STATS if stats else ()):
        out[k] = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.atray_wide_shade(
            ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), dx.data_ptr(), dy.data_ptr(),
            dz.data_ptr(), alive.data_ptr(), n,
            accel.cnodes.data_ptr(), accel.tris.data_ptr(), accel.cleaves.data_ptr(),
            accel.leaf_size,
            *(out[k].data_ptr() for k in OUTPUTS),
            *((out[k].data_ptr() for k in STATS) if stats else (None, None)), stream,
        )
    _build.check(rc, "wide_shade")
    COUNTER.launches += 1
    return {k: out[k] for k in OUTPUTS + (STATS if stats else ())}


def wide_shade_planes_ref(accel: ShadedWideBVH, ox, oy, oz, dx, dy, dz,
                          alive, visits: Optional[dict] = None,
                          stats: bool = False) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of the kernel: a vectorized walk in which every
    live ray keeps its own stack. Each iteration pops one node for every ray
    whose stack is not empty, tests its 8 child boxes against the ray's
    best_t, then visits the children in the kernel's per-ray order, pushing
    interior children and testing leaves (16 records at once per ray; the
    first minimal t wins, as in the kernel's sequential strict-< loop).
    With a ``visits`` dict it adds the node pops and leaf records tested
    ("nodes", "records"), the work this input needs; with ``stats`` it
    returns the kernel's per-ray ``node_visits`` and ``leaf_visits``."""
    COUNTER.plain_calls += 1
    dev = ox.device
    n = ox.shape[0]
    f32, i32 = torch.float32, torch.int32
    t_out = torch.full((n,), INF, dtype=f32, device=dev)
    id_out = torch.full((n,), -1, dtype=i32, device=dev)
    nrm = torch.zeros((n, 3), dtype=f32, device=dev)
    mat_out = torch.zeros((n,), dtype=f32, device=dev)

    ray = torch.nonzero(alive).squeeze(1)          # live rays
    m = ray.shape[0]
    o = torch.stack([ox[ray], oy[ray], oz[ray]], dim=1)
    d = torch.stack([dx[ray], dy[ray], dz[ray]], dim=1)
    inv = inv_dir(d)
    best_t = torch.full((m,), INF, dtype=f32, device=dev)
    best_id = torch.full((m,), -1, dtype=i32, device=dev)
    best_n = torch.zeros((m, 3), dtype=f32, device=dev)
    best_mat = torch.zeros((m,), dtype=f32, device=dev)
    stack = torch.zeros((m, STACK_CAP), dtype=torch.int64, device=dev)
    sp = torch.ones((m,), dtype=torch.int64, device=dev)   # root 0 pushed

    w = accel.num_nodes
    lo = accel.cboxes[:, 0:24].reshape(w, 3, 8)
    hi = accel.cboxes[:, 24:48].reshape(w, 3, 8)
    links_t = accel.clinks.t().long()                # (W, 8)
    caxis = accel.caxis.reshape(-1).long()
    recs = accel.tris.reshape(-1, STRIDE32)
    recs_i = recs.view(i32)
    ks = torch.arange(accel.leaf_size, device=dev)
    counts = {"nodes": 0, "records": 0}
    node_cnt = torch.zeros((m,), dtype=i32, device=dev)
    leaf_cnt = torch.zeros((m,), dtype=i32, device=dev)

    def leaf_test(rows, leaf_row):
        ridx = leaf_row[:, None] * RECS_PER_ROW + ks[None, :]     # (j, L)
        rec = recs[ridx]                                           # (j, L, 32)
        counts["records"] += ridx.numel()
        leaf_cnt[rows] += 1
        oc = o[rows]
        dc = d[rows]
        uu, vv, tt, hit = record_hit(oc[:, 0:1], oc[:, 1:2], oc[:, 2:3],
                                     dc[:, 0:1], dc[:, 1:2], dc[:, 2:3], rec)
        hit = hit & (tt < best_t[rows][:, None])
        k = torch.argmin(torch.where(hit, tt, float("inf")), dim=1)   # first min
        won = hit.any(dim=1)
        rw, kw = rows[won], k[won]
        sel = (won.nonzero().squeeze(1), kw)
        u1, v1 = uu[sel], vv[sel]
        w0 = 1.0 - u1 - v1
        r1 = rec[sel]                                              # (q, 32)
        best_t[rw] = tt[sel]
        best_id[rw] = recs_i[ridx[sel]][:, 9]
        best_n[rw] = torch.stack([
            w0 * r1[:, 10 + a] + u1 * r1[:, 13 + a] + v1 * r1[:, 16 + a]
            for a in range(3)], dim=1)
        best_mat[rw] = r1[:, 19]

    while True:
        cur = torch.nonzero(sp > 0).squeeze(1)
        if cur.numel() == 0:
            break
        counts["nodes"] += cur.numel()
        node_cnt[cur] += 1
        sp[cur] -= 1
        node = stack[cur, sp[cur]]
        oc = o[cur][:, :, None]
        ic = inv[cur][:, :, None]
        t0 = (lo[node] - oc) * ic                                  # (k, 3, 8)
        t1 = (hi[node] - oc) * ic
        tmin = torch.minimum(t0, t1)
        tmax = torch.maximum(t0, t1)
        t_near = torch.maximum(torch.maximum(tmin[:, 0], tmin[:, 1]), tmin[:, 2])
        t_far = torch.minimum(torch.minimum(tmax[:, 0], tmax[:, 1]), tmax[:, 2])
        bhit = (t_near <= torch.minimum(t_far, best_t[cur][:, None])) & (t_far > 0.0)
        links = links_t[node]                                      # (k, 8)
        da = d[cur].gather(1, caxis[node][:, None]).squeeze(1)
        d7 = torch.where(da > 0.0, 7, 0)
        for cc in range(8):
            c = (cc ^ d7)[:, None]
            hc = bhit.gather(1, c).squeeze(1)
            lk = links.gather(1, c).squeeze(1)
            push = hc & (lk >= 0)
            rows = cur[push]
            if rows.numel():
                stack[rows, sp[rows]] = lk[push]
                sp[rows] += 1
            leaf = hc & (lk < 0) & (lk > _EMPTY_GUARD)
            if leaf.any():
                leaf_test(cur[leaf], -(lk[leaf] + 1))

    if visits is not None:
        for k in counts:
            visits[k] = visits.get(k, 0) + counts[k]
    rlen = torch.rsqrt(torch.clamp_min(
        best_n[:, 0] * best_n[:, 0] + best_n[:, 1] * best_n[:, 1]
        + best_n[:, 2] * best_n[:, 2], 1.0e-20))
    t_out[ray] = best_t
    id_out[ray] = best_id
    nrm[ray] = best_n * rlen[:, None]
    mat_out[ray] = best_mat
    out = {"t": t_out, "id": id_out, "nx": nrm[:, 0].contiguous(),
           "ny": nrm[:, 1].contiguous(), "nz": nrm[:, 2].contiguous(),
           "mat": mat_out.to(i32)}
    if stats:
        for k, cnt in zip(STATS, (node_cnt, leaf_cnt)):
            out[k] = torch.zeros((n,), dtype=i32, device=dev)
            out[k][ray] = cnt
    return out
