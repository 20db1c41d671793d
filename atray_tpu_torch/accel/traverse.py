"""Stackless skip-link walk of the binary BVH in plain PyTorch
(``atray_tpu/accel/traverse.py``).

Every ray keeps one node cursor. Each step, for all rays still walking:
slab-test the cursor's node box against the ray's best t, test the leaf's
``leaf_size`` triangles (Möller–Trumbore) when the box is hit at a leaf,
then advance: a hit interior node goes to ``node + 1``, anything else to
its miss link; -1 ends the walk. The order is DFS, so the nearest hit comes
from testing every reachable leaf and pruning boxes entered past best t.
``render(accel=BVH)`` and ``nearest_hit_ids`` use it; it has no kernel
(the reference's is plain jnp too).
"""

from __future__ import annotations

from typing import Tuple

import torch

from atray_tpu_torch.accel.bvh import BVH
from atray_tpu_torch.core.intersect import INF, aabb_entry_t, moller_trumbore, safe_inv_dir


def bvh_first_hit(bvh: BVH, scene, orig: torch.Tensor,
                  dirn: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Nearest triangle hit per ray: (t, u, v, face id int32), (INF, 0, 0,
    -1) on a miss. ``scene`` is unused (the reference's call signature); a
    host ``bvh`` is moved to the rays' device."""
    dev = orig.device
    if not isinstance(bvh.node_min, torch.Tensor) or bvh.node_min.device != dev:
        bvh = bvh.to(dev)
    r = orig.shape[0]
    inv = safe_inv_dir(dirn)
    lane = torch.arange(bvh.leaf_size, device=dev)
    miss = bvh.node_miss.long()
    leaf_start = bvh.leaf_start.long()
    node = torch.zeros(r, dtype=torch.int64, device=dev)
    best_t = torch.full((r,), INF, dtype=torch.float32, device=dev)
    best_u = torch.zeros(r, dtype=torch.float32, device=dev)
    best_v = torch.zeros(r, dtype=torch.float32, device=dev)
    best_id = torch.full((r,), -1, dtype=torch.int32, device=dev)
    while True:
        cur = torch.nonzero(node >= 0).squeeze(1)
        if cur.numel() == 0:
            break
        nd = node[cur]
        t_entry, _, bhit = aabb_entry_t(orig[cur], inv[cur], bvh.node_min[nd], bvh.node_max[nd])
        bhit = bhit & (t_entry < best_t[cur])
        start = leaf_start[nd]
        is_leaf = start >= 0
        do_leaf = bhit & is_leaf
        if do_leaf.any():
            rows = cur[do_leaf]
            slot = start[do_leaf][:, None] + lane[None, :]             # (j, ls)
            t, u, v, _ = moller_trumbore(orig[rows][:, None, :], dirn[rows][:, None, :],
                                         bvh.tri_p0[slot], bvh.tri_e1[slot], bvh.tri_e2[slot])
            k = torch.argmin(t, dim=1, keepdim=True)                    # first minimum
            t_leaf = t.gather(1, k)[:, 0]
            closer = t_leaf < best_t[rows]
            rw, kw = rows[closer], k[closer]
            best_t[rw] = t_leaf[closer]
            best_u[rw] = u[closer].gather(1, kw)[:, 0]
            best_v[rw] = v[closer].gather(1, kw)[:, 0]
            best_id[rw] = bvh.tri_orig_id[slot[closer].gather(1, kw)[:, 0]]
        node[cur] = torch.where(bhit & ~is_leaf, nd + 1, miss[nd])
    return best_t, best_u, best_v, best_id
