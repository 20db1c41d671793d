"""Nearest triangle hit over a ``WideBVH`` by the 8-wide frustum walk
(``atray_tpu/kernels/wide_pallas.py``: ``_wide_kernel`` through
``wide_first_hit``, the third lineage kernel).

``wide_first_hit(wbvh, orig, dirn)`` takes (R, 3) float32 origins and
directions and returns ``(t, u, v, fid)``, ``(INF, 0, 0, -1)`` on a miss.

The bundle is a warp of 32 consecutive rays with the interval bounds of
``frustum_walk`` (12 warp reductions over the live lanes). The warp keeps
one stack of wide nodes and one leaf queue in shared memory. At each
popped node lanes 0-7 each read one child's box and link from the node's
record in ``WideBVH.cnodes`` and take the interval test of its box (no
``tmax`` term, as in the reference), ``__ballot_sync`` packs the overlap
bits, and the children are pushed in slot order: interior ones onto the
stack, leaves ``-(link + 1)`` into the queue. Empty slots are skipped by
their link (``INT32_MIN``), never by their inverted boxes. The queue holds
``QCAP = 512`` leaves and is drained in mid-walk once it holds
``QCAP - 8``; at the end of the walk it is drained whole. A drain tests
every queued leaf's records against every lane in queue order, streaming
them through a ring of leaf slots in the warp's shared memory (copied by
``cp.async``, so ``tris`` must be 16-byte aligned) and testing two at a
time. The walk carries no ``tmax``, so where the drains fall does not
change the result.
The test is conservative, so hits are exact; exact ties of coincident
faces may pick the other face than a per-ray walk.

On a CUDA tensor it launches ``csrc/wide_frustum.cu``; on a CPU tensor it
runs ``wide_ref``, a plain PyTorch version with the kernel's bounds, visit
order, queue order and drains, bit-equal to it. A tree deeper than the
stack (``8 * (max_depth + 2) > STACK_CAP``) raises. ``interpret``,
``block_sub`` and ``qcap`` are not carried.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from atray_tpu_torch.accel.pack import TRI_STRIDE, TRIS_PER_ROW
from atray_tpu_torch.accel.wide import WideBVH
from atray_tpu_torch.core.intersect import INF
from atray_tpu_torch.kernels import _build
from atray_tpu_torch.kernels._checks import check_wide
from atray_tpu_torch.kernels._plain import (
    axis_setup, axis_t_bounds, bundle_box, bundle_leaf_hits, bundles)
from atray_tpu_torch.kernels.packet_walk import Hits, unbundle
from atray_tpu_torch.kernels.wide_exact import _EMPTY_GUARD

COUNTER = _build.COUNTERS["wide_frustum"]
STACK_CAP = 192     # stack entries per warp; kStackCap in the .cu
QCAP = 512          # leaf queue entries per warp; kQCap in the .cu
_SUB = 32           # queued leaves the plain version tests per step
VISIT_KEYS = ("nodes", "records", "drains", "drain_warps", "warp_nodes")


def wide_first_hit(wbvh: WideBVH, orig: torch.Tensor, dirn: torch.Tensor) -> Hits:
    """Nearest hit per ray; see the module docstring."""
    return _first_hit(wbvh, orig, dirn)


def _first_hit(wbvh: WideBVH, orig: torch.Tensor, dirn: torch.Tensor,
               visits: Optional[dict] = None) -> Hits:
    """``wide_first_hit`` that, given a ``visits`` dict, adds "nodes"
    (wide-node pops times live rays), "records" (records tested times live
    rays), "drains" (mid-walk queue drains), "drain_warps" (warps with at
    least one) and "warp_nodes" (wide-node pops, once a warp); on the card
    the kernel counts them, at the cost of one sync. For diagnostics (the
    chip smoke test and the tests)."""
    dev = check_wide(wbvh, orig, dirn, "wide_frustum", STACK_CAP, derived=True)
    if dev.type == "cpu":
        return wide_ref(wbvh, orig, dirn, visits=visits)
    return launch_wide("atray_wide_frustum", COUNTER, "wide_frustum", wbvh, orig, dirn, visits)


def launch_wide(fn: str, counter, name: str, wbvh: WideBVH, orig, dirn, visits,
                extra=()) -> Hits:
    """One launch of a ``WideBVH`` lineage kernel on ``wbvh.cnodes`` and
    ``wbvh.tris``; ``extra`` are the launcher's arguments between the visit
    stats and the stream. The launcher refuses (cudaErrorInvalidValue) a
    ``STACK_CAP`` or ``QCAP`` other than the one it was compiled with."""
    if wbvh.tris.data_ptr() % 16:
        raise ValueError("accel.tris must be 16-byte aligned")
    lib = _build.load()
    n = orig.shape[0]
    dev = orig.device
    t, u, v = (torch.empty(n, dtype=torch.float32, device=dev) for _ in range(3))
    fid = torch.empty(n, dtype=torch.int32, device=dev)
    stats = (torch.zeros(len(VISIT_KEYS), dtype=torch.int64, device=dev)
             if visits is not None else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn)(
            orig.data_ptr(), dirn.data_ptr(), n, wbvh.cnodes.data_ptr(), wbvh.tris.data_ptr(),
            wbvh.leaf_size, STACK_CAP, QCAP,
            t.data_ptr(), u.data_ptr(), v.data_ptr(), fid.data_ptr(),
            stats.data_ptr() if stats is not None else None, *extra, stream)
    counter.launches += 1
    _build.check(rc, name)
    if stats is not None:
        for key, val in zip(VISIT_KEYS, stats.tolist()):
            visits[key] = visits.get(key, 0) + val
    return t, u, v, fid


def _walk_order(clinks: np.ndarray):
    """The unculled stack walk over host links (8, W): the pop order (a
    preorder that visits a node's children in descending slot order, since
    they are pushed in ascending order), and each node's parent, slot and
    depth. A culled walk pops a subsequence of this order."""
    w = clinks.shape[1]
    parent = np.full(w, -1, np.int64)
    slot = np.full(w, -1, np.int64)
    depth = np.zeros(w, np.int64)
    order, stack = [], [0]
    while stack:
        node = stack.pop()
        order.append(node)
        for c in range(8):
            link = int(clinks[c, node])
            if link >= 0:
                parent[link], slot[link], depth[link] = node, c, depth[node] + 1
                stack.append(link)
    return np.asarray(order, np.int64), parent, slot, depth


def _child_overlap(wbvh: WideBVH, o, d, live) -> torch.Tensor:
    """(B, W, 8) interval test of every bundle against every child box."""
    ol, oh, dl, dh = bundle_box(o, d, live)
    setup = axis_setup(dl, dh)
    nb, w = ol.shape[0], wbvh.num_nodes
    lo = wbvh.cboxes[:, 0:24].reshape(w, 3, 8)[None]
    hi = wbvh.cboxes[:, 24:48].reshape(w, 3, 8)[None]
    ov = torch.empty((nb, w, 8), dtype=torch.bool, device=o.device)
    step = max(1, 8_000_000 // (24 * w))
    for s in range(0, nb, step):
        sl = slice(s, s + step)
        lb, ub = axis_t_bounds([x[sl][:, None, :, None] for x in setup],
                               ol[sl][:, None, :, None], oh[sl][:, None, :, None], lo, hi)
        tlo = torch.maximum(torch.maximum(lb[:, :, 0], lb[:, :, 1]),
                            torch.clamp(lb[:, :, 2], min=0.0))
        thi = torch.minimum(torch.minimum(ub[:, :, 0], ub[:, :, 1]), ub[:, :, 2])
        ov[sl] = tlo <= thi
    return ov


def wide_ref(wbvh: WideBVH, orig: torch.Tensor, dirn: torch.Tensor, qcap: int = QCAP,
             visits: Optional[dict] = None, counter=COUNTER) -> Hits:
    """Plain PyTorch version of the kernel with a leaf queue of ``qcap``.

    The walk needs no step loop: with no ``tmax`` term the interval test
    of a child is fixed per bundle, so a bundle pops a node when every
    test on its path from the root passed (found level by level), in the
    order of the unculled stack walk, and queues the overlapping leaf
    slots of each popped node in slot order. The queue is then cut where
    the kernel drains it (after the node that brings it to ``qcap - 8``
    leaves) and drained in that order, a block of leaves at a time; each
    record is tested against every lane with a strict t < best, so the
    first minimal t in queue order wins, as in the kernel. With a
    ``visits`` dict it adds ``VISIT_KEYS``'s counts."""
    if qcap < 16:
        raise ValueError("qcap must be at least 16")
    counter.plain_calls += 1
    n = orig.shape[0]
    o, d, live = bundles(orig, dirn)
    nb, dev, w = o.shape[0], orig.device, wbvh.num_nodes
    ov = _child_overlap(wbvh, o, d, live)
    order_np, parent, slot, depth = _walk_order(wbvh.clinks.cpu().numpy())
    visited = torch.zeros((nb, w), dtype=torch.bool, device=dev)
    visited[:, 0] = True
    for lv in range(1, int(depth.max()) + 1):
        nodes_lv = np.nonzero((depth == lv) & (parent >= 0))[0]
        nl = torch.from_numpy(nodes_lv).to(dev)
        pa = torch.from_numpy(parent[nodes_lv]).to(dev)
        sc = torch.from_numpy(slot[nodes_lv]).to(dev)
        visited[:, nl] = visited[:, pa] & ov[:, pa, sc]
    order = torch.from_numpy(order_np).to(dev)
    links = wbvh.clinks.t().long()[order]                               # (W, 8) in pop order
    is_leaf = (links < 0) & (links > _EMPTY_GUARD)
    queued = visited[:, order, None] & ov[:, order, :] & is_leaf[None]  # (B, W, 8)
    per_node = queued.sum(2)
    cum = torch.cumsum(per_node, 1)                                     # queue size after each pop
    total = cum[:, -1]
    # the queue in order, padded: (B, Q)
    flat = queued.reshape(nb, -1)
    qmax = max(int(total.max()), 1)
    qlist = torch.zeros((nb, qmax), dtype=torch.int64, device=dev)
    rb, cb = flat.nonzero(as_tuple=True)
    qlist[rb, torch.cumsum(flat, 1)[rb, cb] - 1] = (-(links.reshape(-1) + 1))[cb]
    # drain points: after the first pop that brings the queue to qcap - 8
    cuts = [torch.zeros(nb, dtype=torch.int64, device=dev)]
    while True:
        idx = torch.searchsorted(cum, (cuts[-1] + (qcap - 8))[:, None]).squeeze(1)
        more = idx < cum.shape[1]
        if not more.any():
            break
        cuts.append(torch.where(more, cum.gather(1, idx.clamp(max=w - 1)[:, None]).squeeze(1),
                                cuts[-1]))
    drains = torch.zeros(nb, dtype=torch.int64, device=dev)
    for a, b in zip(cuts, cuts[1:]):
        drains += b > a
    cuts.append(total)

    best = (torch.full((nb, 32), INF, dtype=torch.float32, device=dev),
            torch.zeros((nb, 32), dtype=torch.float32, device=dev),
            torch.zeros((nb, 32), dtype=torch.float32, device=dev),
            torch.full((nb, 32), -1, dtype=torch.int32, device=dev))
    recs = wbvh.tris.reshape(-1, TRI_STRIDE)
    recs_i = recs.view(torch.int32)
    ks = torch.arange(wbvh.leaf_size, device=dev)
    sub = torch.arange(_SUB, device=dev)
    for start, stop in zip(cuts, cuts[1:]):
        for q0 in range(0, int((stop - start).max()), _SUB):
            pos = start[:, None] + q0 + sub[None, :]
            ok = pos < stop[:, None]
            bsel = torch.nonzero(ok.any(1)).squeeze(1)
            rows = qlist[bsel].gather(1, pos[bsel].clamp(max=qmax - 1))
            ridx = (rows[:, :, None] * TRIS_PER_ROW + ks).reshape(bsel.shape[0], -1)
            valid = ok[bsel][:, :, None].expand(-1, -1, wbvh.leaf_size).reshape(bsel.shape[0], -1)
            part = tuple(x[bsel] for x in best)
            bundle_leaf_hits(o[bsel], d[bsel], recs, recs_i, ridx, valid, part)
            for x, y in zip(best, part):
                x[bsel] = y
    if visits is not None:
        nlive = live.sum(1)
        counts = {"nodes": int((visited.sum(1) * nlive).sum()),
                  "records": int((total * nlive).sum()) * wbvh.leaf_size,
                  "drains": int(drains.sum()), "drain_warps": int((drains > 0).sum()),
                  "warp_nodes": int(visited.sum())}
        for key in VISIT_KEYS:
            visits[key] = visits.get(key, 0) + counts[key]
    return unbundle(best, n)
