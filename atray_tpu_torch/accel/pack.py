"""Leaf-row packing of the binary BVH (``pack_bvh`` of
``atray_tpu/kernels/traverse_pallas.py``): a host builder, numpy in and out.

Leaf triangles go into rows of 128 floats, 8 records of stride 16 per row:
``[p0.xyz, e1.xyz, e2.xyz, face id as int32 BITS, pad x6]``. A leaf of
``leaf_size`` slots takes ``max(1, leaf_size // 8)`` rows. Pad slots have
p0 = 1e30 and zero edges, so they never hit. The unshaded ``WideBVH``
(``accel/wide.py``) reuses these rows verbatim. The reference's pack also
holds the skip-link node tables of its ``TreePack`` walks; they come with
the port of those walks.
"""

from __future__ import annotations

import numpy as np

from atray_tpu_torch.accel.bvh import BVH

LANE = 128
TRI_STRIDE = 16                   # floats per leaf record
TRIS_PER_ROW = LANE // TRI_STRIDE  # 8


def pack_bvh(bvh: BVH) -> np.ndarray:
    """The leaf rows (rows_per_leaf * num_leaves, 128) f32 of a flattened
    BVH; ``leaf_size`` must be <= 8 or a multiple of 8."""
    ls = bvh.leaf_size
    if ls > TRIS_PER_ROW and ls % TRIS_PER_ROW != 0:
        raise ValueError(f"leaf_size {ls} must be <=8 or a multiple of 8")
    rows_per_leaf = max(1, ls // TRIS_PER_ROW)
    tid = np.asarray(bvh.tri_orig_id)
    slots = tid.shape[0]
    num_leaves = max(1, slots // ls)
    tris = np.zeros((num_leaves * rows_per_leaf, LANE), np.float32)
    tris[:, 0::TRI_STRIDE] = 1.0e30
    tris[:, 1::TRI_STRIDE] = 1.0e30
    tris[:, 2::TRI_STRIDE] = 1.0e30
    flat = tris.reshape(-1, TRI_STRIDE)       # one record per row
    s = np.arange(slots)
    rec = (s // ls) * (rows_per_leaf * TRIS_PER_ROW) + (s % ls)
    flat[rec, 0:3] = np.asarray(bvh.tri_p0)
    flat[rec, 3:6] = np.asarray(bvh.tri_e1)
    flat[rec, 6:9] = np.asarray(bvh.tri_e2)
    flat[rec, 9] = tid.view(np.float32)       # int32 bits
    return tris
