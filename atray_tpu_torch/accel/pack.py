"""Skip-link packing of the binary BVH (``pack_bvh`` and ``TreePack`` of
``atray_tpu/kernels/traverse_pallas.py``): a host builder, numpy in and out.

A ``TreePack`` holds the tables of the skip-link packet walk
(``kernels/persistent_packet.py``):

- ``nodebox`` (6, K) f32: min x, y, z, max x, y, z of every node, in the
  BVH's DFS preorder;
- ``ctrl`` (2, K) i32: the miss (skip) link, -1 when the walk is done, and
  the node's first leaf row, -1 for an interior node;
- ``tris``: leaf triangles in rows of 128 floats, 8 records of stride 16 per
  row: ``[p0.xyz, e1.xyz, e2.xyz, face id as int32 BITS, pad x6]``. A leaf of
  ``leaf_size`` slots takes ``max(1, leaf_size // 8)`` rows. Pad slots have
  p0 = 1e30 and zero edges, so they never hit.

The unshaded ``WideBVH`` (``accel/wide.py``) reuses ``tris`` verbatim.
``TreePack.to(device)`` uploads the tables.

``TreePack.cnodes`` is the derived table the hit kernel reads
(``pack_node_records``: one 32-byte record a node, from ``nodebox`` and
``ctrl``), built on the tables' device at first use on each object; ``to``
makes a new object, so it is never stale. The original tables stay for the
plain versions and the other walks.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from atray_tpu_torch.accel.bvh import BVH
from atray_tpu_torch.scene.data import _Leaves

LANE = 128
TRI_STRIDE = 16                   # floats per leaf record
TRIS_PER_ROW = LANE // TRI_STRIDE  # 8
PACK_NODE_WORDS = 8               # one node record: lo xyz, hi xyz, miss, leaf row


def pack_node_records(nodebox, ctrl) -> torch.Tensor:
    """(K, 8) int32 words, one 32-byte record a node in the tables' DFS
    preorder (so ``node + 1`` is the next record): words 0-5 the bits of
    ``nodebox`` (min x, y, z, max x, y, z), 6 the miss link, 7 the leaf
    row or -1. Box floats travel as their bits; a kernel reads a record
    as two 16-byte loads."""
    nodebox, ctrl = torch.as_tensor(nodebox), torch.as_tensor(ctrl)
    return torch.cat([nodebox.t().contiguous().view(torch.int32),
                      ctrl.t().to(torch.int32)], dim=1).contiguous()


@dataclasses.dataclass(frozen=True)
class TreePack(_Leaves):
    """Skip-link node tables and stride-16 leaf rows of a binary BVH."""

    nodebox: np.ndarray   # f32 (6, K)
    ctrl: np.ndarray      # i32 (2, K): miss link, leaf row or -1
    tris: np.ndarray      # f32 (rows_per_leaf * num_leaves, 128)
    leaf_size: int
    num_nodes: int

    @property
    def rows_per_leaf(self) -> int:
        return max(1, self.leaf_size // TRIS_PER_ROW)

    @property
    def device(self) -> torch.device:
        nb = self.nodebox
        return nb.device if isinstance(nb, torch.Tensor) else torch.device("cpu")

    @functools.cached_property
    def cnodes(self) -> torch.Tensor:
        """``pack_node_records`` of this pack's tables, on their device;
        built once per object (the dataclass is frozen, so its tables
        never change under it)."""
        return pack_node_records(self.nodebox, self.ctrl)


def pack_bvh(bvh: BVH) -> TreePack:
    """The ``TreePack`` of a flattened BVH; ``leaf_size`` must be <= 8 or a
    multiple of 8."""
    ls = bvh.leaf_size
    if ls > TRIS_PER_ROW and ls % TRIS_PER_ROW != 0:
        raise ValueError(f"leaf_size {ls} must be <=8 or a multiple of 8")
    nmin = np.asarray(bvh.node_min)
    nmax = np.asarray(bvh.node_max)
    nodebox = np.concatenate([nmin.T, nmax.T], axis=0).astype(np.float32)
    rows_per_leaf = max(1, ls // TRIS_PER_ROW)
    leaf_start = np.asarray(bvh.leaf_start)
    leaf_row = np.where(leaf_start >= 0, (leaf_start // ls) * rows_per_leaf, -1)
    ctrl = np.stack([np.asarray(bvh.node_miss), leaf_row]).astype(np.int32)

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
    return TreePack(nodebox=nodebox, ctrl=ctrl, tris=tris, leaf_size=ls,
                    num_nodes=int(nmin.shape[0]))
