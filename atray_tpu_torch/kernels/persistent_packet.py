"""Nearest triangle hit over a ``TreePack`` by the skip-link walk with exact
per-ray culling (``atray_tpu/kernels/persistent_packet.py``), the bounce
walk of a ``HybridAccel`` and the walk of ``render(accel=TreePack)``.

``ppacket_first_hit(pack, orig, dirn)`` takes (R, 3) float32 origins and
directions and returns ``(t, u, v, fid)``: distance, barycentrics and int32
face id of the nearest hit, ``(INF, 0, 0, -1)`` on a miss.

On a CUDA tensor it launches ``csrc/ppacket.cu`` (one thread per ray, one
node cursor, no stack, over the pack's derived table ``cnodes``, one
32-byte record a node, and its stride-16 leaf records); on a CPU tensor it
runs ``ppacket_ref``, the plain PyTorch version of the same walk over the
original tables (no derived table is built there): same slab and
Möller–Trumbore op order, same per-ray node order, so the two agree
bit-for-bit where the device's arithmetic is IEEE (the kernel is built with
``--fmad=false``). The TPU kernel walks blocks of rays in lockstep and
descends where any ray of the block enters a box; per ray that visits a
superset of the ray's own nodes and finds the same nearest hit, up to which
of two coincident faces wins an exact tie. ``block_sub`` and ``interpret``
are not carried.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from atray_tpu_torch.accel.pack import TRI_STRIDE, TRIS_PER_ROW, TreePack
from atray_tpu_torch.core.intersect import INF
from atray_tpu_torch.kernels import _build
from atray_tpu_torch.kernels._checks import check_treepack
from atray_tpu_torch.kernels._plain import inv_dir, record_hit

COUNTER = _build.COUNTERS["ppacket"]

Hits = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def ppacket_first_hit(pack: TreePack, orig: torch.Tensor, dirn: torch.Tensor) -> Hits:
    """Nearest hit per ray; see the module docstring."""
    dev = check_treepack(pack, orig, dirn, "ppacket", derived=True)
    if dev.type == "cpu":
        return ppacket_ref(pack, orig, dirn)
    lib = _build.load()
    n = orig.shape[0]
    t, u, v = (torch.empty(n, dtype=torch.float32, device=dev) for _ in range(3))
    fid = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.atray_ppacket(
            orig.data_ptr(), dirn.data_ptr(), n, pack.cnodes.data_ptr(), pack.tris.data_ptr(),
            pack.leaf_size,
            t.data_ptr(), u.data_ptr(), v.data_ptr(), fid.data_ptr(), stream)
    COUNTER.launches += 1
    _build.check(rc, "ppacket")
    return t, u, v, fid


def ppacket_ref(pack: TreePack, orig: torch.Tensor, dirn: torch.Tensor,
                visits: Optional[dict] = None) -> Hits:
    """Plain PyTorch version of the kernel: every ray keeps a node cursor;
    each step slab-tests the cursor's box for all rays still walking
    (``t_near < best_t`` culling), tests the leaf records where a leaf box
    is hit (all at once per ray; the first minimal t wins, as in the
    kernel's sequential strict-< loop), and advances to ``node + 1`` or the
    miss link. With a ``visits`` dict it adds the node visits and leaf
    records tested ("nodes", "records"), the work this input needs."""
    COUNTER.plain_calls += 1
    dev = orig.device
    n = orig.shape[0]
    f32, i32 = torch.float32, torch.int32
    inv = inv_dir(dirn)
    best_t = torch.full((n,), INF, dtype=f32, device=dev)
    best_u = torch.zeros((n,), dtype=f32, device=dev)
    best_v = torch.zeros((n,), dtype=f32, device=dev)
    best_id = torch.full((n,), -1, dtype=i32, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    lo = pack.nodebox[0:3].t()                  # (K, 3)
    hi = pack.nodebox[3:6].t()
    miss = pack.ctrl[0].long()
    leaf_row = pack.ctrl[1].long()
    recs = pack.tris.reshape(-1, TRI_STRIDE)
    recs_i = recs.view(i32)
    ks = torch.arange(pack.leaf_size, device=dev)
    counts = {"nodes": 0, "records": 0}
    while True:
        cur = torch.nonzero(node >= 0).squeeze(1)
        if cur.numel() == 0:
            break
        counts["nodes"] += cur.numel()
        nd = node[cur]
        o = orig[cur]
        ic = inv[cur]
        t0 = (lo[nd] - o) * ic
        t1 = (hi[nd] - o) * ic
        tmin = torch.minimum(t0, t1)
        tmax = torch.maximum(t0, t1)
        t_near = torch.maximum(torch.maximum(tmin[:, 0], tmin[:, 1]), tmin[:, 2])
        t_far = torch.minimum(torch.minimum(tmax[:, 0], tmax[:, 1]), tmax[:, 2])
        bhit = (t_near <= t_far) & (t_far > 0.0) & (t_near < best_t[cur])
        lr = leaf_row[nd]
        leaf = bhit & (lr >= 0)
        if leaf.any():
            rows = cur[leaf]
            ridx = lr[leaf][:, None] * TRIS_PER_ROW + ks[None, :]       # (j, L)
            rec = recs[ridx]                                           # (j, L, 16)
            counts["records"] += ridx.numel()
            oc, dc = orig[rows], dirn[rows]
            uu, vv, tt, hit = record_hit(oc[:, 0:1], oc[:, 1:2], oc[:, 2:3],
                                         dc[:, 0:1], dc[:, 1:2], dc[:, 2:3], rec)
            hit = hit & (tt < best_t[rows][:, None])
            k = torch.argmin(torch.where(hit, tt, float("inf")), dim=1)   # first min
            won = hit.any(dim=1)
            rw = rows[won]
            sel = (won.nonzero().squeeze(1), k[won])
            best_t[rw] = tt[sel]
            best_u[rw] = uu[sel]
            best_v[rw] = vv[sel]
            best_id[rw] = recs_i[ridx[sel]][:, 9]
        node[cur] = torch.where(bhit & (lr < 0), nd + 1, miss[nd])
    if visits is not None:
        for key in counts:
            visits[key] = visits.get(key, 0) + counts[key]
    return best_t, best_u, best_v, best_id
