"""A binary BVH over triangles in plain PyTorch, and its closest-hit walk.

Build: the triangles sorted by the 30-bit Morton code of their centroids,
cut into leaves of ``LEAF`` consecutive triangles, and a complete binary
tree over the leaves in heap order (node 1 the root, node n's children 2n
and 2n + 1, leaf j the node L + j). A leaf's box holds its triangles'
corners, widened by ``PAD`` times the scene's extent so that rounding in
the slab test never culls a hit; a parent's box is the union of its
children's. ``refit`` recomputes the boxes from moved triangles.

Walk: each ray keeps a stack; every iteration pops one node of each ray
whose stack is not empty. A leaf's triangles are tested by one-sided
Möller–Trumbore (det > 1e-12, t > ``T_MIN``), the first least t winning;
an inner node's two child boxes are tested against the ray's best t and
the ones it meets are pushed, the nearer on top. A ray whose stack runs
empty leaves the working set. The answer is the least t over every
triangle, as a test of all of them would give it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

LEAF = 8
T_MIN = 1.0e-4
INF = 3.0e38
PAD = 1.0e-5
STACK = 32


class Tree(NamedTuple):
    slot_face: torch.Tensor   # (L * LEAF,) int64 face of each leaf slot, -1 empty
    lo: torch.Tensor          # (2L, 3) node boxes in heap order (row 0 unused)
    hi: torch.Tensor
    leaves: int               # L, a power of two


def moller_trumbore(ox, oy, oz, dx, dy, dz, rec):
    """One-sided Möller–Trumbore of rays against triangles ``rec`` (..., 9)
    holding p0, e1 = p1 - p0, e2 = p2 - p0; the ray components broadcast
    against ``rec[..., 0]``. Returns (t, u, v, hit)."""
    e1x, e1y, e1z = rec[..., 3], rec[..., 4], rec[..., 5]
    e2x, e2y, e2z = rec[..., 6], rec[..., 7], rec[..., 8]
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    valid = det > 1.0e-12
    inv_det = torch.where(valid, 1.0 / torch.where(valid, det, 1.0), 0.0)
    tvx = ox - rec[..., 0]
    tvy = oy - rec[..., 1]
    tvz = oz - rec[..., 2]
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = valid & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN)
    return t, u, v, hit


def _spread(x: torch.Tensor) -> torch.Tensor:
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def build(tri: torch.Tensor) -> Tree:
    """The tree over triangles ``tri`` (T, 9)."""
    tri = tri.detach()
    t = tri.shape[0]
    c = (tri[:, 0:3] + (tri[:, 3:6] + tri[:, 6:9]) / 3.0).float()
    lo, hi = c.min(dim=0).values, c.max(dim=0).values
    q = torch.clamp((c - lo) / torch.clamp_min(hi - lo, 1e-20) * 1023.0, 0, 1023).long()
    code = (_spread(q[:, 0]) << 2) | (_spread(q[:, 1]) << 1) | _spread(q[:, 2])
    order = torch.argsort(code, stable=True)
    leaves = 1
    while leaves * LEAF < t:
        leaves *= 2
    slot = torch.full((leaves * LEAF,), -1, dtype=torch.int64, device=tri.device)
    slot[:t] = order
    return refit(Tree(slot, None, None, leaves), tri)


def refit(tree: Tree, tri: torch.Tensor) -> Tree:
    """``tree`` with its boxes recomputed from triangles ``tri``."""
    tri = tri.detach()
    leaves = tree.leaves
    ok = (tree.slot_face >= 0)[:, None]
    rec = tri[torch.clamp(tree.slot_face, 0)]
    p0 = rec[:, 0:3]
    p1 = p0 + rec[:, 3:6]
    p2 = p0 + rec[:, 6:9]
    mn = torch.where(ok, torch.minimum(torch.minimum(p0, p1), p2), INF)
    mx = torch.where(ok, torch.maximum(torch.maximum(p0, p1), p2), -INF)
    pad = PAD * float((mx.max(dim=0).values - mn.min(dim=0).values).max())
    lo = torch.empty((2 * leaves, 3), dtype=tri.dtype, device=tri.device)
    hi = torch.empty_like(lo)
    lo[leaves:] = mn.reshape(leaves, LEAF, 3).min(dim=1).values - pad
    hi[leaves:] = mx.reshape(leaves, LEAF, 3).max(dim=1).values + pad
    level = leaves // 2
    while level >= 1:
        n = torch.arange(level, 2 * level, device=tri.device)
        lo[n] = torch.minimum(lo[2 * n], lo[2 * n + 1])
        hi[n] = torch.maximum(hi[2 * n], hi[2 * n + 1])
        level //= 2
    return tree._replace(lo=lo, hi=hi)


def _slab(lo, hi, o, inv):
    """(entry, exit) t of rays through boxes; an empty box (lo > hi, as
    the boxes of empty leaves are) gets an exit before its entry."""
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    near = torch.minimum(t0, t1).max(dim=-1).values
    far = torch.maximum(t0, t1).min(dim=-1).values
    empty = (lo > hi).any(dim=-1)
    return torch.where(empty, INF, near), torch.where(empty, -INF, far)


def closest_hit(tree: Tree, tri: torch.Tensor, orig: torch.Tensor, dirn: torch.Tensor):
    """(t, face) of each ray (R, 3) against triangles ``tri`` (T, 9): the
    least t, INF and -1 where no triangle is hit. The working set is
    compacted when half of it has finished."""
    tri = tri.detach()
    n = orig.shape[0]
    dev = orig.device
    best_t = torch.full((n,), INF, dtype=orig.dtype, device=dev)
    best_f = torch.full((n,), -1, dtype=torch.int64, device=dev)
    zero = dirn == 0.0
    inv = torch.where(zero, 1.0e30, 1.0 / torch.where(zero, 1.0, dirn))
    near, far = _slab(tree.lo[1], tree.hi[1], orig, inv)
    ids = torch.nonzero((near <= far) & (far > 0.0)).squeeze(1)
    o, d, iv = orig[ids], dirn[ids], inv[ids]
    bt, bf = best_t[ids], best_f[ids]
    stack = torch.zeros((ids.shape[0], STACK), dtype=torch.int32, device=dev)
    stack[:, 0] = 1
    sp = torch.ones(ids.shape[0], dtype=torch.int64, device=dev)
    slots = torch.arange(LEAF, device=dev)
    big = tree.leaves
    while True:
        act = torch.nonzero(sp > 0).squeeze(1)
        if act.numel() * 2 < ids.numel():
            best_t[ids] = bt
            best_f[ids] = bf
            if not act.numel():
                break
            ids, o, d, iv, bt, bf = ids[act], o[act], d[act], iv[act], bt[act], bf[act]
            stack, sp = stack[act], sp[act]
            act = torch.arange(ids.shape[0], device=dev)
        top = sp[act] - 1
        sp[act] = top
        node = stack[act, top].long()
        leaf = node >= big
        li = act[leaf]
        if li.numel():
            face = tree.slot_face[(node[leaf] - big)[:, None] * LEAF + slots]    # (k, LEAF)
            rec = tri[torch.clamp(face, 0)]                                   # (k, LEAF, 9)
            ol, dl = o[li][:, None, :], d[li][:, None, :]
            t, _, _, hit = moller_trumbore(ol[..., 0], ol[..., 1], ol[..., 2],
                                           dl[..., 0], dl[..., 1], dl[..., 2], rec)
            hit = hit & (face >= 0) & (t < bt[li][:, None])
            k = torch.argmin(torch.where(hit, t, float("inf")), dim=1)
            won = hit.any(dim=1)
            w = li[won]
            bt[w] = t[won, k[won]]
            bf[w] = face[won, k[won]]
        inner = ~leaf
        ii = act[inner]
        if ii.numel():
            c0 = 2 * node[inner]
            oi, vi, bti = o[ii][:, None, :], iv[ii][:, None, :], bt[ii]
            n0, f0 = _slab(tree.lo[c0][:, None, :], tree.hi[c0][:, None, :], oi, vi)
            n1, f1 = _slab(tree.lo[c0 + 1][:, None, :], tree.hi[c0 + 1][:, None, :], oi, vi)
            n0, f0, n1, f1 = n0[:, 0], f0[:, 0], n1[:, 0], f1[:, 0]
            h0 = (n0 <= torch.minimum(f0, bti)) & (f0 > 0.0)
            h1 = (n1 <= torch.minimum(f1, bti)) & (f1 > 0.0)
            first = n1 < n0                      # child 1 nearer: push child 0 first
            far_c = torch.where(first, c0, c0 + 1)
            near_c = torch.where(first, c0 + 1, c0)
            far_h = torch.where(first, h0, h1)
            near_h = torch.where(first, h1, h0)
            s = top[inner]
            stack[ii[far_h], s[far_h]] = far_c[far_h].to(torch.int32)
            s = s + far_h
            stack[ii[near_h], s[near_h]] = near_c[near_h].to(torch.int32)
            sp[ii] = s + near_h
    return best_t, best_f
