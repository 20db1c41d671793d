"""8-wide collapse of the binary SAH BVH and the unshaded ``WideBVH``
(``atray_tpu/accel/wide.py``).

Starting from the binary root, the cut node with the largest surface area
is expanded until the cut holds 8 subtrees (or only leaves remain); each
cut entry becomes a child slot. Host numpy in, numpy out.

``WideBVH`` pairs those node tables with the stride-16 leaf rows of
``accel/pack.py``; ``wide_exact`` (``kernels/wide_exact.py``) walks it.
``make_accel`` builds it, ``refit_wide`` moves it with the vertices of an
optimization loop, ``WideBVH.to(device)`` uploads it.

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

import dataclasses
import sys
from typing import List, Optional

import numpy as np
import torch

from atray_tpu_torch.accel.bvh import BVH, build_bvh
from atray_tpu_torch.accel.pack import TRIS_PER_ROW, pack_bvh
from atray_tpu_torch.config import KDTreeConfig
from atray_tpu_torch.scene.data import _Leaves

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


@dataclasses.dataclass(frozen=True)
class WideBVH(_Leaves):
    """Tables of the unshaded 8-wide walk. ``slot_face`` and
    ``build_vertices`` carry what ``refit_wide`` needs."""

    cboxes: np.ndarray   # f32 (W, 128): child c, field f at lane 8f + c
    clinks: np.ndarray   # i32 (8, W)
    tris: np.ndarray     # f32 (rows_per_leaf * num_leaves, 128), stride 16
    leaf_size: int
    num_nodes: int
    max_depth: int
    caxis: Optional[np.ndarray] = None            # i32 (1, W)
    slot_face: Optional[np.ndarray] = None        # i32 (slots,); -1 = pad
    build_vertices: Optional[np.ndarray] = None   # f32 (V, 3)

    @property
    def rows_per_leaf(self) -> int:
        return max(1, self.leaf_size // TRIS_PER_ROW)

    @property
    def device(self) -> torch.device:
        cb = self.cboxes
        return cb.device if isinstance(cb, torch.Tensor) else torch.device("cpu")


def build_wide_bvh(bvh: BVH, tris_packed: np.ndarray) -> WideBVH:
    """8-wide tables over a binary BVH; ``tris_packed`` is ``pack_bvh``'s
    leaf rows, reused verbatim."""
    cboxes, clinks, caxis, max_depth = _collapse_wide_np(bvh)
    return WideBVH(cboxes=cboxes, clinks=clinks, tris=tris_packed, leaf_size=bvh.leaf_size,
                   num_nodes=cboxes.shape[0], max_depth=max_depth, caxis=caxis)


def wide_from_mesh(vertices, faces, config: Optional[KDTreeConfig] = None) -> WideBVH:
    """Binary SAH build -> leaf pack -> 8-wide collapse, with refit data."""
    cfg = config or KDTreeConfig(leaf_size=8)
    bvh = build_bvh(vertices, faces, cfg)
    wide = build_wide_bvh(bvh, pack_bvh(bvh))
    return dataclasses.replace(
        wide, slot_face=np.asarray(bvh.tri_orig_id, np.int32),
        build_vertices=np.asarray(vertices, np.float32))


def make_accel(vertices, faces, config: Optional[KDTreeConfig] = None) -> WideBVH:
    """The geometry-only accel of optimization loops: its leaf rows hold
    only geometry, and shading reads the live scene through
    ``render.wavefront.resolve_hit``. Host numpy; ``.to(device)`` uploads."""
    return wide_from_mesh(vertices, faces, config)


def refit_wide(accel: WideBVH, vertices: torch.Tensor, faces: torch.Tensor) -> WideBVH:
    """The accel with its leaf records recomputed from ``vertices`` and
    every node box widened by the largest vertex move since the build, so
    the boxes still contain the moved triangles. Topology stays as built.
    Face ids (column 9, denormal floats) move only through an int32 view.
    The outputs are detached: they decide which face a ray hits, and the
    gradient reads the live vertices through ``resolve_hit``."""
    if accel.slot_face is None or accel.build_vertices is None:
        raise ValueError("accel was built without refit support")
    with torch.no_grad():
        v = vertices.detach()
        f = faces.long()
        fid = accel.slot_face.long()
        slots = fid.shape[0]
        ls = accel.leaf_size
        fcl = torch.clamp(fid, 0, max(f.shape[0] - 1, 0))
        p0 = v[f[fcl, 0]]
        e1 = v[f[fcl, 1]] - p0
        e2 = v[f[fcl, 2]] - p0
        ok = (fid >= 0)[:, None]
        flat_i = accel.tris.view(torch.int32).reshape(-1, 16).clone()
        s = torch.arange(slots, device=v.device)
        rec = (s // ls) * (accel.rows_per_leaf * TRIS_PER_ROW) + (s % ls)
        old9 = flat_i[rec, 0:9].view(torch.float32)
        new9 = torch.where(ok, torch.cat([p0, e1, e2], dim=1), old9)
        flat_i[rec, 0:9] = new9.contiguous().view(torch.int32)
        tris = flat_i.view(torch.float32).reshape(accel.tris.shape)
        delta = torch.max(torch.abs(v - accel.build_vertices))
        cb = accel.cboxes
        cboxes = torch.cat([cb[:, 0:24] - delta, cb[:, 24:48] + delta, cb[:, 48:]], dim=1)
    return dataclasses.replace(accel, tris=tris, cboxes=cboxes)
