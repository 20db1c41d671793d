"""Debug visualizations (``atray_tpu/utils/debugviz.py``): the per-pixel
cost of the BVH walk as a heatmap film, and the boxes of one level of the
tree.

- ``traversal_depth_map``: for each camera ray (one a pixel, through the
  pixel centre), the number of binary-BVH boxes its skip-link walk enters,
  normalized to [0, 1] and coloured blue (cheap) to red (dear). The camera
  rays come from ``camera_rays`` on ``device``; the walk is host numpy, as
  in the reference.
- ``bvh_level_boxes``: (K, 2, 3) world-space boxes of the tree cut at a
  level, for plots or box overlays.
- ``save_cost_heatmap``: the depth map written with ``film.save_png``.

Films are plain (H, W, 3) float32 arrays; no plotting library is needed.
"""

from __future__ import annotations

import numpy as np

from atray_tpu_torch.accel.bvh import BVH
from atray_tpu_torch.core.camera import Camera, camera_rays
from atray_tpu_torch.render.film import save_png


def traversal_depth_map(accel: BVH, scene, camera: Camera, width: int, height: int,
                        device=None) -> np.ndarray:
    """(height, width, 3) float32 film of the boxes each pixel's camera ray
    enters in ``accel`` (the skip-link ``BVH``), over the most of any
    pixel. ``device`` (None: "cuda") is where the camera rays are made."""
    if not isinstance(accel, BVH):
        raise TypeError("traversal_depth_map expects the skip-link BVH accel")
    orig, dirn = camera_rays(camera, width, height, 1, device=device)
    o = orig.cpu().numpy()
    d = dirn.cpu().numpy()
    nmin = np.asarray(accel.node_min)
    nmax = np.asarray(accel.node_max)
    miss = np.asarray(accel.node_miss)
    lstart = np.asarray(accel.leaf_start)
    with np.errstate(all="ignore"):
        inv = 1.0 / d
        counts = np.zeros(o.shape[0], np.int64)
        node = np.zeros(o.shape[0], np.int64)
        active = np.ones(o.shape[0], bool)
        # every ray's skip-link walk, counting the boxes it enters (bounded)
        for _ in range(nmin.shape[0] * 2):
            if not active.any():
                break
            n = np.maximum(node, 0)
            t0 = (nmin[n] - o) * inv
            t1 = (nmax[n] - o) * inv
            tn = np.minimum(t0, t1).max(axis=1)
            tf = np.maximum(t0, t1).min(axis=1)
            hit = (tn <= tf) & (tf > 0) & active
            counts += hit
            is_leaf = lstart[n] >= 0
            nxt = np.where(hit & ~is_leaf, n + 1, miss[n])
            node = np.where(active, nxt, node)
            active = node >= 0
    img = counts.reshape(height, width).astype(np.float64)
    img = img / max(img.max(), 1)
    film = np.stack([img, 0.2 * img, 1.0 - img], axis=-1)
    return film.astype(np.float32)


def bvh_level_boxes(accel: BVH, level: int = 3) -> np.ndarray:
    """(K, 2, 3) world-space boxes of the tree cut at ``level``: every
    node at that depth, and every leaf above it."""
    nmin = np.asarray(accel.node_min)
    nmax = np.asarray(accel.node_max)
    miss = np.asarray(accel.node_miss)
    lstart = np.asarray(accel.leaf_start)
    boxes = []

    def walk(n, depth):
        if depth == level or lstart[n] >= 0:
            boxes.append((nmin[n], nmax[n]))
            return
        # children: n + 1 and the first node after its subtree
        left = n + 1
        walk(left, depth + 1)
        right = miss[left]
        if right >= 0 and right != miss[n]:
            walk(right, depth + 1)

    walk(0, 0)
    return np.asarray(boxes)


def save_cost_heatmap(path: str, accel: BVH, scene, camera: Camera, width: int = 320,
                      height: int = 180, device=None) -> str:
    """``traversal_depth_map`` written to ``path`` as a PNG; returns the
    path written."""
    return save_png(path, traversal_depth_map(accel, scene, camera, width, height, device))
