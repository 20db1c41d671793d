"""Nearest triangle hit over a ``TreePack`` by a coherent packet walk
(``atray_tpu/kernels/traverse_pallas.py``: ``_traverse_kernel`` through
``pallas_first_hit``, the first of the four lineage kernels).

``packet_first_hit(pack, orig, dirn)`` takes (R, 3) float32 origins and
directions and returns ``(t, u, v, fid)``: distance, barycentrics and int32
face id of the nearest hit, ``(INF, 0, 0, -1)`` on a miss.

The bundle is a warp of 32 consecutive rays (the TPU kernel's block of
16 x 128). The warp keeps one node cursor over the skip links and descends
where any live ray's slab hit has ``t_near < best_t`` (``__any_sync``); at
a hit leaf every lane tests all ``leaf_size`` records. Rays past the end
(the ragged last warp) take no part in a vote: this replaces the TPU
kernel's padding with far rays. The culling is conservative, so the
nearest hit is exact; against a per-ray walk an exact tie of coincident
faces may pick the other face.

On a CUDA tensor it launches ``csrc/packet_walk.cu``, which reads the
pack's node records ``TreePack.cnodes`` (built at first use); on a CPU
tensor it runs ``packet_ref``, the plain PyTorch version of the same walk,
bundle by bundle with the kernel's votes and record order, so the two
agree bit-for-bit (the kernel is built with ``--fmad=false``).
``interpret`` and ``block_sub`` are not carried.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from atray_tpu_torch.accel.pack import TRI_STRIDE, TRIS_PER_ROW, TreePack
from atray_tpu_torch.core.intersect import INF
from atray_tpu_torch.kernels import _build
from atray_tpu_torch.kernels._checks import check_treepack
from atray_tpu_torch.kernels._plain import bundle_leaf_hits, bundles, inv_dir

COUNTER = _build.COUNTERS["packet_walk"]

Hits = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def packet_first_hit(pack: TreePack, orig: torch.Tensor, dirn: torch.Tensor) -> Hits:
    """Nearest hit per ray; see the module docstring."""
    return _first_hit(pack, orig, dirn)


def _first_hit(pack: TreePack, orig: torch.Tensor, dirn: torch.Tensor,
               visits: Optional[dict] = None) -> Hits:
    """``packet_first_hit`` that, given a ``visits`` dict, adds the walk's
    own work: "nodes" (node visits of each warp times its live rays) and
    "records" (records tested times live rays); on the card the kernel
    counts them, at the cost of one sync. For diagnostics (the chip smoke
    test and the tests)."""
    dev = check_treepack(pack, orig, dirn, "packet_walk", derived=True)
    if dev.type == "cpu":
        return packet_ref(pack, orig, dirn, visits)
    return _launch("packet_walk", COUNTER, pack, orig, dirn, visits)


def _launch(name: str, counter, pack: TreePack, orig, dirn, visits,
            keys=("nodes", "records"), node_args=()) -> Hits:
    """One launch of a ``TreePack`` lineage kernel (``packet_walk`` or
    ``frustum_walk``, C function ``atray_<name>``) over the pack's node
    records ``cnodes`` (followed by ``node_args`` in the C call) and its
    stride-16 leaf records; with ``visits``, the kernel's counts of
    ``keys`` are added to it."""
    lib = _build.load()
    n = orig.shape[0]
    dev = orig.device
    t, u, v = (torch.empty(n, dtype=torch.float32, device=dev) for _ in range(3))
    fid = torch.empty(n, dtype=torch.int32, device=dev)
    stats = torch.zeros(len(keys), dtype=torch.int64, device=dev) if visits is not None else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"atray_{name}")(
            orig.data_ptr(), dirn.data_ptr(), n, pack.cnodes.data_ptr(), *node_args,
            pack.tris.data_ptr(), pack.leaf_size,
            t.data_ptr(), u.data_ptr(), v.data_ptr(), fid.data_ptr(),
            stats.data_ptr() if stats is not None else None, stream)
    counter.launches += 1
    _build.check(rc, name)
    if stats is not None:
        for key, val in zip(keys, stats.tolist()):
            visits[key] = visits.get(key, 0) + val
    return t, u, v, fid


def unbundle(best, n: int) -> Hits:
    """(B, 32) planes of a bundle walk -> the (R,) hit contract."""
    return tuple(x.reshape(-1)[:n] for x in best)


def packet_ref(pack: TreePack, orig: torch.Tensor, dirn: torch.Tensor,
               visits: Optional[dict] = None) -> Hits:
    """Plain PyTorch version of the kernel: every bundle keeps a node
    cursor; each step slab-tests the cursor's box for the 32 lanes of all
    bundles still walking, a bundle descends where any live lane hits with
    ``t_near < best_t``, and at a leaf all its lanes test the leaf's
    records. With a ``visits`` dict it adds the walk's work ("nodes",
    "records", per live ray)."""
    COUNTER.plain_calls += 1
    n = orig.shape[0]
    o, d, live = bundles(orig, dirn)
    nb, dev = o.shape[0], orig.device
    inv = inv_dir(d)
    best = (torch.full((nb, 32), INF, dtype=torch.float32, device=dev),
            torch.zeros((nb, 32), dtype=torch.float32, device=dev),
            torch.zeros((nb, 32), dtype=torch.float32, device=dev),
            torch.full((nb, 32), -1, dtype=torch.int32, device=dev))
    nlive = live.sum(1)
    node = torch.zeros(nb, dtype=torch.int64, device=dev)
    lo = pack.nodebox[0:3].t()
    hi = pack.nodebox[3:6].t()
    miss = pack.ctrl[0].long()
    leaf_row = pack.ctrl[1].long()
    recs = pack.tris.reshape(-1, TRI_STRIDE)
    recs_i = recs.view(torch.int32)
    ks = torch.arange(pack.leaf_size, device=dev)
    nodes = torch.zeros((), dtype=torch.int64, device=dev)
    records = torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        cur = torch.nonzero(node >= 0).squeeze(1)
        if cur.numel() == 0:
            break
        nodes += nlive[cur].sum()
        nd = node[cur]
        oc, ic = o[cur], inv[cur]                                      # (c, 32, 3)
        t0 = (lo[nd][:, None, :] - oc) * ic
        t1 = (hi[nd][:, None, :] - oc) * ic
        tmin = torch.minimum(t0, t1)
        tmax = torch.maximum(t0, t1)
        t_near = torch.maximum(torch.maximum(tmin[..., 0], tmin[..., 1]), tmin[..., 2])
        t_far = torch.minimum(torch.minimum(tmax[..., 0], tmax[..., 1]), tmax[..., 2])
        bhit = live[cur] & (t_near <= t_far) & (t_far > 0.0) & (t_near < best[0][cur])
        anyh = bhit.any(1)
        lr = leaf_row[nd]
        leaf = anyh & (lr >= 0)
        if leaf.any():
            bl = cur[leaf]
            ridx = lr[leaf][:, None] * TRIS_PER_ROW + ks[None, :]      # (j, L)
            sub = tuple(x[bl] for x in best)
            bundle_leaf_hits(o[bl], d[bl], recs, recs_i, ridx, torch.ones_like(ridx, dtype=torch.bool),
                             sub)
            for x, y in zip(best, sub):
                x[bl] = y
            records += nlive[bl].sum() * pack.leaf_size
        node[cur] = torch.where(anyh & (lr < 0), nd + 1, miss[nd])
    if visits is not None:
        visits["nodes"] = visits.get("nodes", 0) + int(nodes)
        visits["records"] = visits.get("records", 0) + int(records)
    return unbundle(best, n)
