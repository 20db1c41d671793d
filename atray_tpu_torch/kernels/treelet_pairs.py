"""Pair-binned nearest hit over the treelet view of a ``ShadedWideBVH``
(``atray_tpu/kernels/treelet_pairs.py``), the path of
``RenderSettings.pair_bounces``.

A treelet is ``leaves_per_treelet`` consecutive leaves of the shaded records;
``accel.tboxes`` packs their boxes 8 per 128-float row (NaN for empty
treelets and row pads). Three stages:

- Phase A, ``treelet_candidates``: every live ray's ``k_slots`` nearest
  treelets by box entry distance, nearest first, and ``bound``, the entry
  distance of the next one (3e38 when there is none). Boxes stream in
  treelet order into K+1 sorted slots by a strict <, the reference's
  insertion network, so among equal distances the same ids win as there.
- Binning, ``treelet_pair_hit``: (ray, treelet) pairs in k-major slots
  (slot k*R + i is ray i's k-th candidate), one stable argsort by treelet,
  a static cap of pairs, one ``index_select`` of the six ray planes.
- Phase B, ``treelet_pair_walk``: each pair's nearest hit among its
  treelet's records, with ``wide_shade``'s arithmetic, so a winning hit is
  bit-identical to the walk's.

Results return to their slots through ``lane_take`` over the inverse
permutation, and each ray keeps the nearest of its slots (k ascending,
strict <). A ray is resolved when its hit is no farther than ``bound`` and
none of its pairs fell past the cap; the others (``unresolved``) are packed
to a prefix and re-walked by ``wide_shade``, whose result they take. So
``treelet_pair_hit`` returns what ``wide_shade_planes`` returns, up to
which of two coincident faces wins an exact tie.

On CUDA tensors Phase A launches ``csrc/treelet_phase_a.cu`` (over
``accel.tboxes_ordered``, built at first use) and Phase B
``csrc/treelet_phase_b.cu`` (over the leaf planes ``accel.cleaves``, built
at first use, and the winner's shaded record); on CPU tensors they run
``treelet_candidates_ref`` and ``treelet_pair_walk_ref``. The glue makes no
host sync. The TPU knobs (``block_sub``, ``n_inter``, ``multi_pop``,
``interpret``, ``ATRAY_PAIR_K``, ``ATRAY_PAIR_CAP``) are not carried;
``PAIR_K`` and ``PAIR_CAP`` are the renderer's constants.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from atray_tpu_torch.accel.shaded import RECS_PER_ROW, STRIDE32, ShadedWideBVH
from atray_tpu_torch.core.intersect import INF
from atray_tpu_torch.kernels import _build
from atray_tpu_torch.kernels._plain import inv_dir, record_det, record_hit
from atray_tpu_torch.kernels.lane_pack import lane_take, pack_indices, unpack_indices
from atray_tpu_torch.kernels.wide_shade import wide_shade_planes

PAIR_K = 4          # candidate slots per ray
PAIR_CAP = 0.5      # static pair budget as a fraction of the rays
MAX_K = 8           # slots the Phase A kernel is built for
_ROUND = 1024       # the cap is a multiple of this (the reference's block)
COUNTER_A = _build.COUNTERS["treelet_phase_a"]
COUNTER_B = _build.COUNTERS["treelet_phase_b"]
OUT = ("t", "id", "nx", "ny", "nz", "mat")


def _check_planes(planes, mask: torch.Tensor, mask_dtype) -> torch.device:
    dev = mask.device
    n = mask.shape[0]
    if mask.dtype != mask_dtype or mask.dim() != 1 or not mask.is_contiguous():
        raise TypeError(f"the mask must be a contiguous 1-D {mask_dtype} tensor")
    for p in planes:
        if p.dtype != torch.float32 or p.shape != (n,) or p.device != dev:
            raise TypeError("ray planes must be (R,) float32 on the mask's device")
        if not p.is_contiguous():
            raise ValueError("ray planes must be contiguous")
    if dev.type not in ("cpu", "cuda"):
        raise TypeError(f"no treelet kernel for device {dev}")
    return dev


def _check_table(accel: ShadedWideBVH, name: str, dev: torch.device) -> torch.Tensor:
    tab = getattr(accel, name)
    if not isinstance(tab, torch.Tensor) or tab.device != dev or tab.dtype != torch.float32:
        raise TypeError(f"accel.{name} must be a float32 tensor on {dev}: "
                        "call ShadedWideBVH.to(device)")
    if not tab.is_contiguous() or tab.dim() != 2 or tab.shape[1] != 128:
        raise ValueError(f"accel.{name} must be a contiguous (rows, 128) table")
    return tab


def treelet_candidates(accel: ShadedWideBVH, ox, oy, oz, dx, dy, dz, alive,
                       k_slots: int = PAIR_K) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase A: (tids (K, R) int32, -1 = none, nearest first; bound (R,)
    float32, the (K+1)-th entry distance or 3e38). Dead rays have none.
    The kernel reads ``accel.tboxes_ordered`` (built at first use) and
    takes each box's near and far plane by the signs of the ray's
    direction, which gives the plain version's min/max pairs for any
    ``tboxes``."""
    dev = _check_planes((ox, oy, oz, dx, dy, dz), alive, torch.bool)
    tboxes = _check_table(accel, "tboxes", dev)
    if accel.num_treelets <= 0 or tboxes.shape[0] * 8 < accel.num_treelets:
        raise ValueError("accel has no treelet view (num_treelets, tboxes)")
    if not 1 <= k_slots <= MAX_K:
        raise ValueError(f"k_slots must be in 1..{MAX_K}")
    if dev.type == "cpu":
        return treelet_candidates_ref(accel, ox, oy, oz, dx, dy, dz, alive, k_slots)
    tboxes = accel.tboxes_ordered                # built at first use
    if tboxes.data_ptr() % 16:
        raise ValueError("accel.tboxes_ordered must be 16-byte aligned")
    lib = _build.load()
    if lib.atray_treelet_phase_a_max_k() != MAX_K:
        raise RuntimeError("MAX_K disagrees with the compiled kernel")
    n = ox.shape[0]
    tids = torch.empty((k_slots, n), dtype=torch.int32, device=dev)
    bound = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.atray_treelet_phase_a(
            ox.data_ptr(), oy.data_ptr(), oz.data_ptr(), dx.data_ptr(), dy.data_ptr(),
            dz.data_ptr(), alive.data_ptr(), n, tboxes.data_ptr(), tboxes.shape[0],
            k_slots, tids.data_ptr(), bound.data_ptr(), stream)
    COUNTER_A.launches += 1
    _build.check(rc, "treelet_phase_a")
    return tids, bound


def treelet_candidates_ref(accel: ShadedWideBVH, ox, oy, oz, dx, dy, dz, alive,
                           k_slots: int = PAIR_K) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch Phase A: the kernel's loop over the treelet boxes in
    id order, for all live rays at once: the slab test with NaN-propagating
    ``torch.minimum``/``maximum``, then the insertion of the candidate into
    the K+1 sorted slots with a strict <, a displaced entry moving on down
    by the same rule."""
    COUNTER_A.plain_calls += 1
    dev = ox.device
    n = ox.shape[0]
    k = k_slots
    tids = torch.full((k, n), -1, dtype=torch.int32, device=dev)
    bound = torch.full((n,), INF, dtype=torch.float32, device=dev)
    ray = torch.nonzero(alive).squeeze(1)
    m = ray.shape[0]
    rox, roy, roz = ox[ray], oy[ray], oz[ray]
    idx, idy, idz = inv_dir(dx[ray]), inv_dir(dy[ray]), inv_dir(dz[ray])
    te = [torch.full((m,), INF, dtype=torch.float32, device=dev) for _ in range(k + 1)]
    tid = [torch.full((m,), -1, dtype=torch.int32, device=dev) for _ in range(k + 1)]
    tb = accel.tboxes
    for t in range(8 * tb.shape[0]):
        row, c = tb[t // 8], t % 8
        tx0 = (row[c] - rox) * idx
        tx1 = (row[24 + c] - rox) * idx
        ty0 = (row[8 + c] - roy) * idy
        ty1 = (row[32 + c] - roy) * idy
        tz0 = (row[16 + c] - roz) * idz
        tz1 = (row[40 + c] - roz) * idz
        t_near = torch.maximum(torch.maximum(torch.minimum(tx0, tx1), torch.minimum(ty0, ty1)),
                               torch.minimum(tz0, tz1))
        t_far = torch.minimum(torch.minimum(torch.maximum(tx0, tx1), torch.maximum(ty0, ty1)),
                              torch.maximum(tz0, tz1))
        hit = (t_near <= t_far) & (t_far > 0.0)
        cte = torch.where(hit, torch.clamp_min(t_near, 0.0), INF)
        ctid = torch.where(hit, t, -1).to(torch.int32)
        for j in range(k + 1):
            better = cte < te[j]
            te[j], cte = torch.where(better, cte, te[j]), torch.where(better, te[j], cte)
            tid[j], ctid = torch.where(better, ctid, tid[j]), torch.where(better, tid[j], ctid)
    tids[:, ray] = torch.stack(tid[:k])
    bound[ray] = te[k]
    return tids, bound


def treelet_pair_walk(accel: ShadedWideBVH, pox, poy, poz, pdx, pdy, pdz,
                      ptid) -> Dict[str, torch.Tensor]:
    """Phase B: per pair slot, the nearest hit among the records of treelet
    ``ptid`` (int32, -1 = dead slot): ``{t, id, nx, ny, nz, mat}`` as in
    ``wide_shade_planes``, (3e38, -1, 0, 0, 0, 0) for a dead slot or a
    miss."""
    dev = _check_planes((pox, poy, poz, pdx, pdy, pdz), ptid, torch.int32)
    tris = _check_table(accel, "tris", dev)
    lpt = accel.leaves_per_treelet
    if accel.num_treelets <= 0 or lpt <= 0:
        raise ValueError("accel has no treelet view (num_treelets, leaves_per_treelet)")
    if accel.leaf_size > RECS_PER_ROW and accel.leaf_size % RECS_PER_ROW:
        raise ValueError("leaf_size must be <= 4 or a multiple of 4")
    if tris.shape[0] < accel.num_treelets * lpt * accel.rows_per_leaf:
        raise ValueError("accel.tris is shorter than its treelets")
    if dev.type == "cpu":
        return treelet_pair_walk_ref(accel, pox, poy, poz, pdx, pdy, pdz, ptid)
    leaves = accel.cleaves                   # the leaf planes, built at first use
    rpl = accel.rows_per_leaf
    if leaves.shape != (tris.shape[0] // rpl, 9, RECS_PER_ROW * rpl):
        raise ValueError("accel.cleaves does not match accel.tris")
    if leaves.data_ptr() % 16 or tris.data_ptr() % 16:
        raise ValueError("accel.cleaves and accel.tris must be 16-byte aligned")
    lib = _build.load()
    n = pox.shape[0]
    out = {k: torch.empty(n, dtype=torch.float32, device=dev) for k in ("t", "nx", "ny", "nz")}
    out["id"] = torch.empty(n, dtype=torch.int32, device=dev)
    out["mat"] = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.atray_treelet_phase_b(
            pox.data_ptr(), poy.data_ptr(), poz.data_ptr(), pdx.data_ptr(), pdy.data_ptr(),
            pdz.data_ptr(), ptid.data_ptr(), n, leaves.data_ptr(), tris.data_ptr(),
            accel.leaf_size, lpt, out["t"].data_ptr(), out["id"].data_ptr(),
            out["nx"].data_ptr(), out["ny"].data_ptr(), out["nz"].data_ptr(),
            out["mat"].data_ptr(), stream)
    COUNTER_B.launches += 1
    _build.check(rc, "treelet_phase_b")
    return {k: out[k] for k in OUT}


def treelet_pair_walk_ref(accel: ShadedWideBVH, pox, poy, poz, pdx, pdy, pdz, ptid,
                          visits: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """Plain PyTorch Phase B: the kernel's record loop, one record position
    of the treelet per step for every live pair, with ``wide_shade``'s
    Möller–Trumbore and normal op order and a strict t < best_t. With a
    ``visits`` dict it adds the records tested ("records"), those of them
    that face the ray (det > 1e-12, "front") and those of these with u in
    [0, 1] ("u_in")."""
    COUNTER_B.plain_calls += 1
    dev = pox.device
    n = pox.shape[0]
    f32, i32 = torch.float32, torch.int32
    t_out = torch.full((n,), INF, dtype=f32, device=dev)
    id_out = torch.full((n,), -1, dtype=i32, device=dev)
    nrm = torch.zeros((3, n), dtype=f32, device=dev)
    mat_out = torch.zeros((n,), dtype=f32, device=dev)
    live = torch.nonzero(ptid >= 0).squeeze(1)
    m = live.shape[0]
    rox, roy, roz = pox[live], poy[live], poz[live]
    rdx, rdy, rdz = pdx[live], pdy[live], pdz[live]
    recs = accel.tris.reshape(-1, STRIDE32)
    recs_i = recs.view(i32)
    rpl = accel.rows_per_leaf
    first = ptid[live].long() * (rpl * accel.leaves_per_treelet)
    best_t = torch.full((m,), INF, dtype=f32, device=dev)
    best_id = torch.full((m,), -1, dtype=i32, device=dev)
    bn = torch.zeros((3, m), dtype=f32, device=dev)
    best_mat = torch.zeros((m,), dtype=f32, device=dev)
    n_front = torch.zeros((), dtype=torch.int64, device=dev)
    n_u_in = torch.zeros((), dtype=torch.int64, device=dev)
    for leaf in range(accel.leaves_per_treelet):
        for kk in range(accel.leaf_size):
            ridx = (first + leaf * rpl) * RECS_PER_ROW + kk
            rec = recs[ridx]                                       # (m, 32)
            uu, vv, tt, hit = record_hit(rox, roy, roz, rdx, rdy, rdz, rec)
            if visits is not None:
                front = record_det(rdx, rdy, rdz, rec)[3] > 1.0e-12
                n_front += front.sum()
                n_u_in += (front & (uu >= 0.0) & (uu <= 1.0)).sum()
            hit = hit & (tt < best_t)
            w0 = 1.0 - uu - vv
            best_t = torch.where(hit, tt, best_t)
            best_id = torch.where(hit, recs_i[ridx, 9], best_id)
            bn = torch.where(hit, torch.stack([
                w0 * rec[:, 10 + a] + uu * rec[:, 13 + a] + vv * rec[:, 16 + a]
                for a in range(3)]), bn)
            best_mat = torch.where(hit, rec[:, 19], best_mat)
    if visits is not None:
        visits["records"] = visits.get("records", 0) + m * accel.leaves_per_treelet * accel.leaf_size
        visits["front"] = visits.get("front", 0) + int(n_front)
        visits["u_in"] = visits.get("u_in", 0) + int(n_u_in)
    rlen = torch.rsqrt(torch.clamp_min(bn[0] * bn[0] + bn[1] * bn[1] + bn[2] * bn[2], 1.0e-20))
    t_out[live] = best_t
    id_out[live] = best_id
    nrm[:, live] = bn * rlen
    mat_out[live] = best_mat
    return {"t": t_out, "id": id_out, "nx": nrm[0].contiguous(), "ny": nrm[1].contiguous(),
            "nz": nrm[2].contiguous(), "mat": mat_out.to(i32)}


def pair_cap(r: int, k_slots: int = PAIR_K, cap_frac: float = PAIR_CAP) -> int:
    """The static pair budget: a multiple of 1024 near ``cap_frac * R``, at
    least 1024 and at most all K*R slots (the reference's)."""
    return min(k_slots * r, max(_ROUND, (int(r * cap_frac) // _ROUND) * _ROUND))


def bin_pairs(tids: torch.Tensor, num_treelets: int,
              cap: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The binning of Phase A's (K, R) candidates: k-major slot keys (the
    treelet id, ``num_treelets + 1`` for an empty slot), one stable argsort,
    and the treelet ids of the first ``cap`` sorted slots (-1 = empty):
    (keys, perm, ptid)."""
    bigk = num_treelets + 1
    keys = torch.where(tids >= 0, tids, bigk).reshape(-1)
    perm = torch.argsort(keys, stable=True)
    selkey = keys[perm[:cap]]
    return keys, perm, torch.where(selkey < bigk, selkey, -1).to(torch.int32)


def pair_slots(keys: torch.Tensor, perm: torch.Tensor, cap: int) -> torch.Tensor:
    """The ``lane_take`` map that routes pair results back to the K*R
    slots: slot j reads sorted position ``perm^-1[j]``, -1 past ``cap``."""
    inv = torch.empty_like(keys)
    inv[perm] = torch.arange(keys.shape[0], dtype=keys.dtype, device=keys.device)
    return torch.where(inv < cap, inv, -1)


def _words(planes: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The six result planes as one (6, N) int32 tensor of their bits."""
    return torch.stack([planes[k] if planes[k].dtype == torch.int32
                        else planes[k].view(torch.int32) for k in OUT])


def _unwords(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {k: w[j] if k in ("id", "mat") else w[j].view(torch.float32)
            for j, k in enumerate(OUT)}


def treelet_pair_hit(accel: ShadedWideBVH, ox, oy, oz, dx, dy, dz, alive,
                     k_slots: int = PAIR_K,
                     cap_frac: float = PAIR_CAP) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Nearest hit + shading data with ``wide_shade_planes``'s contract,
    through the pair binning; returns (planes, unresolved), where
    ``unresolved`` marks the live rays the exact fallback re-walked."""
    r = ox.shape[0]
    k = k_slots
    tids, bound = treelet_candidates(accel, ox, oy, oz, dx, dy, dz, alive, k)
    cap = pair_cap(r, k, cap_frac)
    keys, perm, ptid = bin_pairs(tids, accel.num_treelets, cap)
    rays = torch.stack([ox, oy, oz, dx, dy, dz])
    pb = torch.index_select(rays, 1, perm[:cap] % r)             # one gather of 6 planes
    res = treelet_pair_walk(accel, *pb, ptid)

    # route pair results back to their slots by the inverse permutation
    slot = pair_slots(keys, perm, cap)
    words = _words(res)
    if cap < k * r:
        words = torch.cat([words, words.new_zeros((6, k * r - cap))], dim=1)
    got = lane_take(words, slot)                                 # 0 where slot < 0
    del words, perm
    routed = slot >= 0
    dropped = (keys <= accel.num_treelets) & ~routed
    slots = _unwords(got)
    slots["t"] = torch.where(routed, slots["t"], INF)
    slots["id"] = torch.where(routed, slots["id"], -1)

    # per ray: the nearest slot, k ascending, strict <
    best = {name: slots[name][:r] for name in OUT}
    drop_any = dropped[:r]
    for j in range(1, k):
        sl = slice(j * r, (j + 1) * r)
        closer = slots["t"][sl] < best["t"]
        best = {name: torch.where(closer, slots[name][sl], best[name]) for name in OUT}
        drop_any = drop_any | dropped[sl]
    unresolved = alive & ((bound < best["t"]) | drop_any)

    # exact fallback: unresolved rays packed to a prefix, one wide_shade call
    # (the lanes past the prefix are dead, and dead rays do not walk)
    pidx = pack_indices(unresolved)
    old = wide_shade_planes(accel, *lane_take(rays, pidx), pidx >= 0)
    back = _unwords(lane_take(_words(old), unpack_indices(unresolved)))
    merged = {name: torch.where(unresolved, back[name], best[name]) for name in OUT}
    return merged, unresolved
