"""8-wide collapse of the binary SAH BVH (``atray_tpu/accel/wide.py``).

Starting from the binary root, the cut node with the largest surface area
is expanded until the cut holds 8 subtrees (or only leaves remain); each
cut entry becomes a child slot. Host numpy in, numpy out.

Child-slot encoding (``clinks`` (8, W) i32):
- internal child: wide-node id (>= 0)
- leaf child:     -(leaf_row + 1)   (<= -1)
- empty slot:     INT32_MIN, with an inverted (+-3e38) box. The slab test
  neutralizes an inverted box into an everything-box, so traversal guards
  empty slots by the LINK, never by the box.

``cboxes`` (W, 128) f32 holds field f (lo x, y, z, hi x, y, z) of child c
at lane 8*f + c. ``caxis`` (1, W) i32 is the axis along which each node's
children are sorted by centroid, ascending.
"""

from __future__ import annotations

import sys
from typing import List

import numpy as np

from atray_tpu_torch.accel.bvh import BVH

EMPTY = np.int32(-2147483648)
WIDTH = 8


def _collapse_wide_np(bvh: BVH):
    """Collapse a skip-link binary BVH into 8-wide tables.

    Returns (cboxes (W,128) f32, clinks (8,W) i32, caxis (1,W) i32,
    max_depth), with leaf rows counted in the 16-float stride of the
    unshaded layout (``leaf_size // 8`` rows per leaf).
    """
    miss = np.asarray(bvh.node_miss)
    leaf_start = np.asarray(bvh.leaf_start)
    nmin = np.asarray(bvh.node_min)
    nmax = np.asarray(bvh.node_max)
    k = miss.shape[0]
    ls = bvh.leaf_size
    rows_per_leaf = max(1, ls // 8)

    # binary children from the preorder layout: interior node i has left
    # child i+1 and right child miss[i+1] (the node after the left subtree)
    left = np.full(k, -1, np.int64)
    right = np.full(k, -1, np.int64)
    interior = leaf_start < 0
    for i in range(k):
        if interior[i]:
            left[i] = i + 1
            right[i] = miss[i + 1] if miss[i + 1] >= 0 else -1

    def area(i):
        d = np.maximum(nmax[i] - nmin[i], 0.0)
        return d[0] * d[1] + d[1] * d[2] + d[2] * d[0]

    wide_children: List[list] = []

    def collapse(b: int) -> int:
        me = len(wide_children)
        wide_children.append([])
        cut = [b]
        while len(cut) < WIDTH:
            best_j, best_a = -1, -1.0
            for j, nb in enumerate(cut):
                if interior[nb]:
                    a = area(nb)
                    if a > best_a:
                        best_j, best_a = j, a
            if best_j < 0:
                break
            nb = cut.pop(best_j)
            cut.extend([left[nb], right[nb]])
        wide_children[me] = cut
        return me

    if interior[0]:
        collapse(0)
    else:
        # degenerate: the root is a single leaf
        wide_children.append([0])

    # BFS: materialize wide nodes for interior cut entries
    w = 0
    while w < len(wide_children):
        cut = wide_children[w]
        for j, nb in enumerate(cut):
            if interior[nb]:
                cut[j] = ("node", collapse(nb), nb)
            else:
                cut[j] = ("leaf", int(leaf_start[nb]) // ls * rows_per_leaf, nb)
        w += 1

    nw = len(wide_children)
    cboxes = np.zeros((nw, 128), np.float32)
    for f in range(3):
        cboxes[:, 8 * f: 8 * f + 8] = 3.0e38
        cboxes[:, 8 * (f + 3): 8 * (f + 3) + 8] = -3.0e38
    clinks = np.full((WIDTH, nw), EMPTY, np.int32)
    caxis = np.zeros((1, nw), np.int32)
    depth = np.zeros(nw, np.int64)
    for wnode, cut in enumerate(wide_children):
        # children sorted by centroid along the axis of max centroid spread
        cents = np.array([(nmin[e[2]] + nmax[e[2]]) * 0.5 for e in cut])
        if len(cut) > 1:
            axis = int(np.argmax(cents.max(axis=0) - cents.min(axis=0)))
            cut = [cut[j] for j in np.argsort(cents[:, axis], kind="stable")]
            caxis[0, wnode] = axis
        for c, (kind, idx, nb) in enumerate(cut):
            for f in range(3):
                cboxes[wnode, 8 * f + c] = nmin[nb][f]
                cboxes[wnode, 8 * (f + 3) + c] = nmax[nb][f]
            clinks[c, wnode] = idx if kind == "node" else -(idx + 1)

    def compute_depth(wnode, d):
        depth[wnode] = d
        for c in range(WIDTH):
            link = clinks[c, wnode]
            if link >= 0:
                compute_depth(link, d + 1)

    sys.setrecursionlimit(max(sys.getrecursionlimit(), 100_000))
    compute_depth(0, 1)
    return cboxes, clinks, caxis, int(depth.max())
