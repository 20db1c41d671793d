"""SAH binary BVH flattened to skip-link arrays (``atray_tpu/accel/bvh.py``).

Host numpy throughout. Nodes are in DFS preorder: an interior hit advances
to ``node + 1``, a miss or a finished leaf jumps to ``node_miss[node]``
(-1 = done). Leaves hold exactly ``leaf_size`` triangle slots, padded with
degenerate triangles at 1e30 that never hit; ``tri_orig_id`` maps slots
back to face indices (-1 = pad). Same mesh, same tree: the numpy build and
the native build (``native/``) each reproduce the reference's tables for
the same backend. ``BVH.to(device)`` uploads the arrays (the skip-link walk
of ``accel/traverse.py`` reads them as tensors).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional, Tuple

import numpy as np

from atray_tpu_torch.config import KDTreeConfig
from atray_tpu_torch.scene.data import _Leaves

_FAR = 1.0e30


@dataclasses.dataclass(frozen=True)
class BVH(_Leaves):
    """Flattened skip-link BVH: K nodes, L = num_leaves * leaf_size slots."""

    node_min: np.ndarray     # (K, 3) f32
    node_max: np.ndarray     # (K, 3) f32
    node_miss: np.ndarray    # (K,) i32 skip link; -1 = traversal done
    leaf_start: np.ndarray   # (K,) i32 into tri arrays; -1 = interior node
    tri_p0: np.ndarray       # (L, 3) f32, leaf-ordered, padded
    tri_e1: np.ndarray       # (L, 3)
    tri_e2: np.ndarray       # (L, 3)
    tri_orig_id: np.ndarray  # (L,) i32 original face index; -1 = pad slot
    leaf_size: int
    max_depth: int

    @property
    def num_nodes(self) -> int:
        return self.node_min.shape[0]


def _surface(mn: np.ndarray, mx: np.ndarray) -> np.ndarray:
    d = np.maximum(mx - mn, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


def _sah_split(tri_mins, tri_maxs, centroids, idx, bins: int) -> Optional[Tuple[int, float]]:
    """Binned SAH over centroids: (axis, split_pos) or None."""
    cmin = centroids[idx].min(axis=0)
    cmax = centroids[idx].max(axis=0)
    ext = cmax - cmin
    axis = int(np.argmax(ext))
    if ext[axis] <= 0.0:
        return None
    lo = cmin[axis]
    scale = bins / ext[axis]
    b = np.minimum(((centroids[idx, axis] - lo) * scale).astype(np.int64), bins - 1)

    counts = np.bincount(b, minlength=bins)
    bmin = np.full((bins, 3), np.inf)
    bmax = np.full((bins, 3), -np.inf)
    np.minimum.at(bmin, b, tri_mins[idx])
    np.maximum.at(bmax, b, tri_maxs[idx])

    lmin = np.minimum.accumulate(bmin, axis=0)
    lmax = np.maximum.accumulate(bmax, axis=0)
    rmin = np.minimum.accumulate(bmin[::-1], axis=0)[::-1]
    rmax = np.maximum.accumulate(bmax[::-1], axis=0)[::-1]
    lcnt = np.cumsum(counts)
    rcnt = np.cumsum(counts[::-1])[::-1]

    k = np.arange(bins - 1)
    valid = (lcnt[k] > 0) & (rcnt[k + 1] > 0)
    cost = np.where(
        valid,
        _surface(lmin[k], lmax[k]) * lcnt[k]
        + _surface(rmin[k + 1], rmax[k + 1]) * rcnt[k + 1],
        np.inf,
    )
    best = int(np.argmin(cost))
    if not valid[best]:
        return None
    return axis, lo + (best + 1) / scale


def build_bvh(vertices, faces, config: KDTreeConfig = KDTreeConfig(),
              backend: str = "auto") -> BVH:
    """Build the flattened skip-link BVH from (V,3) vertices, (T,3) faces.

    ``backend``: "auto" uses the native builder when it builds here and
    the numpy build otherwise; "numpy" forces the numpy build; "native"
    requires the native library.
    """
    f_np = np.asarray(faces)
    if backend in ("auto", "native") and f_np.shape[0] > 0:
        from atray_tpu_torch.native import build_bvh_native

        nat = build_bvh_native(vertices, faces, int(config.leaf_size),
                               int(config.sah_bins), int(config.max_depth))
        if nat is not None:
            return BVH(**nat, leaf_size=int(config.leaf_size),
                       max_depth=int(config.max_depth))
        if backend == "native":
            raise RuntimeError("native BVH builder unavailable")

    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64)
    t = f.shape[0]
    if t == 0:
        raise ValueError("cannot build BVH over zero triangles")
    leaf_size = int(config.leaf_size)

    tri = v[f]                       # (T, 3, 3)
    tri_mins = tri.min(axis=1)
    tri_maxs = tri.max(axis=1)
    centroids = tri.mean(axis=1)

    # node record: (bmin, bmax, left_id, right_id, leaf_tri_idx or None)
    nodes: list = []
    sys.setrecursionlimit(max(sys.getrecursionlimit(), 100_000))

    def rec(idx: np.ndarray, depth: int) -> int:
        me = len(nodes)
        nodes.append(None)
        bmin = tri_mins[idx].min(axis=0)
        bmax = tri_maxs[idx].max(axis=0)
        if idx.size <= leaf_size or depth >= config.max_depth:
            nodes[me] = (bmin, bmax, -1, -1, idx)
            return me
        split = _sah_split(tri_mins, tri_maxs, centroids, idx, config.sah_bins)
        if split is not None:
            axis, pos = split
            sel = centroids[idx, axis] < pos
            li, ri = idx[sel], idx[~sel]
        else:
            li = ri = np.empty(0, np.int64)
        if li.size == 0 or ri.size == 0:
            # degenerate centroids: median split on the widest axis
            axis = int(np.argmax(bmax - bmin))
            order = np.argsort(centroids[idx, axis], kind="stable")
            half = idx.size // 2
            li, ri = idx[order[:half]], idx[order[half:]]
        left = rec(li, depth + 1)
        right = rec(ri, depth + 1)
        nodes[me] = (bmin, bmax, left, right, None)
        return me

    rec(np.arange(t), 0)
    k = len(nodes)

    size = np.ones(k, np.int64)

    def subtree_size(nid: int) -> int:
        _, _, left, right, idx = nodes[nid]
        if idx is None:
            size[nid] = 1 + subtree_size(left) + subtree_size(right)
        return int(size[nid])

    subtree_size(0)

    order: list = []

    def dfs(nid: int):
        order.append(nid)
        _, _, left, right, idx = nodes[nid]
        if idx is None:
            dfs(left)
            dfs(right)

    dfs(0)

    node_min = np.zeros((k, 3), np.float32)
    node_max = np.zeros((k, 3), np.float32)
    node_miss = np.full(k, -1, np.int32)
    leaf_start = np.full(k, -1, np.int32)
    cursor = 0
    tri_order: list = []
    for pos, nid in enumerate(order):
        bmin, bmax, left, right, idx = nodes[nid]
        node_min[pos] = bmin
        node_max[pos] = bmax
        after = pos + size[nid]
        node_miss[pos] = after if after < k else -1
        if idx is not None:
            leaf_start[pos] = cursor
            tri_order.append(idx)
            cursor += leaf_size

    lcap = len(tri_order) * leaf_size
    p0 = np.full((lcap, 3), _FAR, np.float32)
    e1 = np.zeros((lcap, 3), np.float32)
    e2 = np.zeros((lcap, 3), np.float32)
    oid = np.full(lcap, -1, np.int32)
    base = 0
    for idx in tri_order:
        n = idx.size
        tv = v[f[idx]]
        p0[base: base + n] = tv[:, 0]
        e1[base: base + n] = tv[:, 1] - tv[:, 0]
        e2[base: base + n] = tv[:, 2] - tv[:, 0]
        oid[base: base + n] = idx
        base += leaf_size

    return BVH(
        node_min=node_min, node_max=node_max, node_miss=node_miss,
        leaf_start=leaf_start, tri_p0=p0, tri_e1=e1, tri_e2=e2,
        tri_orig_id=oid, leaf_size=leaf_size, max_depth=int(config.max_depth),
    )
