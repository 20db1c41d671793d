"""Nearest triangle hit over a ``TreePack`` by the frustum walk with a leaf
queue (``atray_tpu/kernels/frustum_pallas.py``: ``_frustum_kernel`` through
``frustum_first_hit``, the second lineage kernel).

``frustum_first_hit(pack, orig, dirn)`` takes (R, 3) float32 origins and
directions and returns ``(t, u, v, fid)``, ``(INF, 0, 0, -1)`` on a miss.

The bundle is a warp of 32 consecutive rays, summarized once by interval
bounds: the min and max of the live rays' origins and directions per axis
(12 warp reductions). The walk over the skip links is warp-uniform: each
node takes the interval test of the bundle against its box (four linear
constraints per axis, ``_plain.axis_t_bounds``) bounded by ``[0, tmax]``,
and a leaf that overlaps is queued with its entry bound ``tlo``. Every
``LEAF_BATCH = 8`` queued leaves, and at the end of the walk, a flush tests
the queued leaves' records against every lane and sets ``tmax`` to the
largest best t of the live lanes. The re-check ``tlo <= tmax`` of the
reference's flush is kept; since ``tmax`` changes only at a flush, it never
drops a leaf. Dead lanes of a ragged warp take no part in a bound (the TPU
kernel padded with copies of the last ray instead). The test is
conservative, so hits are exact; exact ties of coincident faces may pick
the other face than a per-ray walk.

On a CUDA tensor it launches ``csrc/frustum_walk.cu``, which walks the
pack's node records ``TreePack.cnodes`` (built at first use) 32 skip-link
positions a step and stages each queued leaf's records in shared memory;
on a CPU tensor it runs ``frustum_ref``, a plain PyTorch version with the
kernel's bounds, queue and flushes, bit-equal to it. ``interpret``,
``block_sub`` and ``leaf_batch`` are not carried.
"""

from __future__ import annotations

from typing import Optional

import torch

from atray_tpu_torch.accel.pack import TRI_STRIDE, TRIS_PER_ROW, TreePack
from atray_tpu_torch.core.intersect import INF
from atray_tpu_torch.kernels import _build
from atray_tpu_torch.kernels._checks import check_treepack
from atray_tpu_torch.kernels._plain import (
    BIG, axis_setup, axis_t_bounds, bundle_box, bundle_record_tests, bundles, take_first_min)
from atray_tpu_torch.kernels.packet_walk import Hits, _launch, unbundle

COUNTER = _build.COUNTERS["frustum_walk"]
LEAF_BATCH = 8      # queued leaves per flush; kLeafBatch in the .cu
_WINDOW = 128       # skip-link positions a step of the plain version (the kernel's: 32)
VISIT_KEYS = ("nodes", "records", "warp_nodes")


def frustum_first_hit(pack: TreePack, orig: torch.Tensor, dirn: torch.Tensor) -> Hits:
    """Nearest hit per ray; see the module docstring."""
    return _first_hit(pack, orig, dirn)


def _first_hit(pack: TreePack, orig: torch.Tensor, dirn: torch.Tensor,
               visits: Optional[dict] = None) -> Hits:
    """``frustum_first_hit`` with ``packet_walk._first_hit``'s ``visits``,
    for diagnostics, and a third count, "warp_nodes": the node steps of
    each warp, counted once a warp (its interval test is the warp's, not a
    lane's)."""
    dev = check_treepack(pack, orig, dirn, "frustum_walk", derived=True)
    if dev.type == "cpu":
        return frustum_ref(pack, orig, dirn, visits)
    return _launch("frustum_walk", COUNTER, pack, orig, dirn, visits, VISIT_KEYS,
                   node_args=(pack.num_nodes,))


def _node_bounds(pack: TreePack, o, d, live):
    """(B, K) entry bound ``tlo`` of every bundle against every node box,
    and the min of its three axis upper bounds (the walk's ``thi`` before
    the ``tmax`` term)."""
    ol, oh, dl, dh = bundle_box(o, d, live)
    setup = axis_setup(dl, dh)
    nb, k = ol.shape[0], pack.num_nodes
    bl, bh = pack.nodebox[0:3][None], pack.nodebox[3:6][None]       # (1, 3, K)
    tlo = torch.empty((nb, k), dtype=torch.float32, device=o.device)
    hi3 = torch.empty_like(tlo)
    step = max(1, 4_000_000 // max(k, 1))
    for s in range(0, nb, step):
        sl = slice(s, s + step)
        lo, hi = axis_t_bounds([x[sl][:, :, None] for x in setup],
                               ol[sl][:, :, None], oh[sl][:, :, None], bl, bh)
        tlo[sl] = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]),
                                torch.clamp(lo[:, 2], min=0.0))
        hi3[sl] = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
    return tlo, hi3


def _cut(tmax_after, tm, total, push, qpos):
    """Where a window of ``frustum_ref`` ends, per bundle: whether a full
    flush of the window lowers ``tmax``, the first that does, and the
    window position of the leaf that filled it (the last position where
    none does)."""
    seg = torch.arange(tmax_after.shape[1], device=tm.device)
    full = (seg[None, :] + 1) * LEAF_BATCH <= total[:, None]
    changed = full & (tmax_after < tm[:, None])
    has = changed.any(1)
    first = changed.int().argmax(1)
    at = push & (qpos == ((first + 1) * LEAF_BATCH)[:, None])
    return has, first, torch.where(has, at.int().argmax(1), push.shape[1] - 1)


def frustum_ref(pack: TreePack, orig: torch.Tensor, dirn: torch.Tensor,
                visits: Optional[dict] = None) -> Hits:
    """Plain PyTorch version of the kernel.

    The interval bounds of every bundle against every node come first.
    Then each step advances every bundle over a window of ``_WINDOW``
    skip-link positions with its current ``tmax``: the nodes the walk
    visits are those not inside the subtree of a node it skips (a culled
    node, or a leaf), found with a running max of the skipped subtrees'
    ends; the overlapping leaves join the queue, and every eighth one is a
    flush. The records of all the window's flushes are tested at once, and
    the step keeps the window up to the first flush that lowers ``tmax``
    (the nodes after it must be tested again with the new bound), or all
    of it. Records are tested against every lane with a strict t < best,
    so the first minimal t in queue order wins, as in the kernel. Any
    window width gives the same hits and visits: width 1 is the
    one-node-a-step walk, the kernel's is 32. With a ``visits`` dict it adds
    the walk's work ("nodes", "records", per live ray; "warp_nodes", node
    steps once a bundle)."""
    COUNTER.plain_calls += 1
    n = orig.shape[0]
    o, d, live = bundles(orig, dirn)
    nb, dev, k = o.shape[0], orig.device, pack.num_nodes
    tlo, hi3 = _node_bounds(pack, o, d, live)
    best = (torch.full((nb, 32), INF, dtype=torch.float32, device=dev),
            torch.zeros((nb, 32), dtype=torch.float32, device=dev),
            torch.zeros((nb, 32), dtype=torch.float32, device=dev),
            torch.full((nb, 32), -1, dtype=torch.int32, device=dev))
    nlive = live.sum(1)
    miss = pack.ctrl[0].long()
    end = torch.where(miss >= 0, miss, k)          # a skipped node's walk resumes here
    leaf_row = pack.ctrl[1].long()
    is_leaf = leaf_row >= 0
    recs = pack.tris.reshape(-1, TRI_STRIDE)
    recs_i = recs.view(torch.int32)
    ls = pack.leaf_size
    ks = torch.arange(ls, device=dev)
    ar = torch.arange(_WINDOW, device=dev)
    slots = torch.arange(LEAF_BATCH, device=dev)
    neg_inf = -float("inf")
    pos_node = torch.zeros(nb, dtype=torch.int64, device=dev)
    cnt = torch.zeros(nb, dtype=torch.int64, device=dev)
    qrow = torch.zeros((nb, LEAF_BATCH), dtype=torch.int64, device=dev)
    qtlo = torch.zeros((nb, LEAF_BATCH), dtype=torch.float32, device=dev)
    tmax = torch.full((nb,), BIG, dtype=torch.float32, device=dev)
    nodes = torch.zeros((), dtype=torch.int64, device=dev)
    warp_nodes = torch.zeros((), dtype=torch.int64, device=dev)
    records = torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        cur = torch.nonzero(pos_node < k).squeeze(1)
        if cur.numel() == 0:
            break
        c, p0, tm = cur.shape[0], pos_node[cur], tmax[cur]
        j = p0[:, None] + ar[None, :]                                  # (c, W)
        inb = j < k
        jc = j.clamp(max=k - 1)
        tl = tlo[cur[:, None], jc]
        ov = tl <= torch.minimum(hi3[cur[:, None], jc], tm[:, None])
        lf = is_leaf[jc]
        skipped_end = torch.where(inb & (~ov | lf), end[jc], 0)
        reach = torch.cummax(skipped_end, dim=1).values
        blocked = torch.cat([torch.zeros_like(reach[:, :1]), reach[:, :-1]], 1) > j
        vis = inb & ~blocked
        push = vis & ov & lf
        qpos = cnt[cur][:, None] + torch.cumsum(push, 1)              # queue size after each node
        total = qpos[:, -1]
        # the window's queue: the carried leaves, then its pushes; entries
        # [8s, 8s + 8) are flushed together as segment s
        nseg = max(1, -(-int(total.max()) // LEAF_BATCH))
        width = nseg * LEAF_BATCH
        qr = torch.zeros((c, width), dtype=torch.int64, device=dev)
        qt = torch.zeros((c, width), dtype=torch.float32, device=dev)
        qr[:, :LEAF_BATCH], qt[:, :LEAF_BATCH] = qrow[cur], qtlo[cur]
        rb, cb = push.nonzero(as_tuple=True)
        qr[rb, qpos[rb, cb] - 1] = leaf_row[jc[rb, cb]]
        qt[rb, qpos[rb, cb] - 1] = tl[rb, cb]
        entry = torch.arange(width, device=dev)
        leaf_ok = (entry[None, :] < total[:, None]) & (qt <= tm[:, None])
        ridx = (qr[:, :, None] * TRIS_PER_ROW + ks).reshape(c, -1)
        sub = tuple(x[cur] for x in best)
        tests = bundle_record_tests(o[cur], d[cur], recs, ridx,
                                    leaf_ok.repeat_interleave(ls, 1), sub[0])
        # tmax after each flush of the window, had tmax not changed before it
        seg_min = torch.where(tests[3], tests[2], float("inf")).reshape(c, 32, nseg, -1).amin(3)
        after = torch.minimum(sub[0][..., None], torch.cummin(seg_min, 2).values)
        tmax_after = torch.where(live[cur][..., None], after, neg_inf).amax(1)   # (c, nseg)
        has, first, lim = _cut(tmax_after, tm, total, push, qpos)
        steps = (vis & (ar[None, :] <= lim[:, None])).sum(1)
        nodes += (steps * nlive[cur]).sum()
        warp_nodes += steps.sum()
        nxt = torch.where(has, end[jc.gather(1, lim[:, None]).squeeze(1)],
                          torch.maximum(p0 + _WINDOW, reach[:, -1]))
        done = nxt >= k
        kept = (total // LEAF_BATCH) * LEAF_BATCH
        flushed = torch.where(has, (first + 1) * LEAF_BATCH, torch.where(done, total, kept))
        acc = leaf_ok & (entry[None, :] < flushed[:, None])
        hit_acc = tests[3] & acc.repeat_interleave(ls, 1)[:, None, :]
        take_first_min(sub, (tests[0], tests[1], tests[2], hit_acc), recs_i, ridx)
        for x, y in zip(best, sub):
            x[cur] = y
        records += (acc.sum(1) * nlive[cur]).sum() * ls
        tmax[cur] = torch.where(flushed > 0,
                                torch.where(live[cur], sub[0], neg_inf).amax(1), tm)
        carry = (kept[:, None] + slots[None, :]).clamp(max=width - 1)
        qrow[cur], qtlo[cur] = qr.gather(1, carry), qt.gather(1, carry)
        cnt[cur] = torch.where(has | done, 0, total - kept)
        pos_node[cur] = nxt
    if visits is not None:
        for key, val in zip(VISIT_KEYS, (nodes, records, warp_nodes)):
            visits[key] = visits.get(key, 0) + int(val)
    return unbundle(best, n)
