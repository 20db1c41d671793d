"""Arithmetic shared by the kernels' plain PyTorch versions, in the CUDA
kernels' op order, so that a plain version and its kernel (built with
``--fmad=false``, no FTZ) agree bit-for-bit."""

from __future__ import annotations

import torch

from atray_tpu_torch.core.intersect import T_MIN


def inv_dir(d: torch.Tensor) -> torch.Tensor:
    """1/d, 1e30 for a zero component (the kernels' ``inv_dir``)."""
    zero = d == 0.0
    return torch.where(zero, 1.0e30, 1.0 / torch.where(zero, 1.0, d))


def record_det(rdx, rdy, rdz, rec: torch.Tensor):
    """Möller–Trumbore's p = d x e2 and det = e1 . p of rays against leaf
    records (``record_hit``'s layout): (px, py, pz, det)."""
    e1x, e1y, e1z = rec[..., 3], rec[..., 4], rec[..., 5]
    e2x, e2y, e2z = rec[..., 6], rec[..., 7], rec[..., 8]
    pvx = rdy * e2z - rdz * e2y
    pvy = rdz * e2x - rdx * e2z
    pvz = rdx * e2y - rdy * e2x
    return pvx, pvy, pvz, e1x * pvx + e1y * pvy + e1z * pvz


def record_hit(rox, roy, roz, rdx, rdy, rdz, rec: torch.Tensor):
    """One-sided Möller–Trumbore (det > 1e-12) of rays against leaf records
    whose last axis holds p0 at 0:3, e1 at 3:6 and e2 at 6:9; the ray
    components broadcast against ``rec[..., 0]``. Returns (u, v, t, hit);
    ``hit`` leaves out the caller's t < best_t."""
    e1x, e1y, e1z = rec[..., 3], rec[..., 4], rec[..., 5]
    e2x, e2y, e2z = rec[..., 6], rec[..., 7], rec[..., 8]
    pvx, pvy, pvz, det = record_det(rdx, rdy, rdz, rec)
    valid = det > 1.0e-12
    inv_det = torch.where(valid, 1.0 / torch.where(valid, det, 1.0), 0.0)
    tvx = rox - rec[..., 0]
    tvy = roy - rec[..., 1]
    tvz = roz - rec[..., 2]
    uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    qvx = tvy * e1z - tvz * e1y
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    vv = (rdx * qvx + rdy * qvy + rdz * qvz) * inv_det
    tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    hit = valid & (uu >= 0.0) & (vv >= 0.0) & (uu + vv <= 1.0) & (tt > T_MIN)
    return uu, vv, tt, hit


# ---- bundle arithmetic of the lineage walks (kernels/packet_walk.py,
# frustum_walk.py, wide_frustum.py, persistent_wide.py). A bundle is the
# kernels' warp: 32 consecutive rays, of which the ones past the end (the
# ragged last bundle) are dead and take part in no vote or bound.

WARP = 32
BIG = 3.0e38    # the interval test's "infinite" bound (INF of the hit contract)


def bundles(orig: torch.Tensor, dirn: torch.Tensor):
    """(R, 3) rays -> (B, 32, 3) origins and directions, dead lanes zero,
    and the (B, 32) live mask."""
    n = orig.shape[0]
    nb = -(-n // WARP)
    pad = nb * WARP - n
    o = torch.cat([orig, orig.new_zeros((pad, 3))]).reshape(nb, WARP, 3)
    d = torch.cat([dirn, dirn.new_zeros((pad, 3))]).reshape(nb, WARP, 3)
    live = (torch.arange(nb * WARP, device=orig.device) < n).reshape(nb, WARP)
    return o, d, live


def bundle_box(o: torch.Tensor, d: torch.Tensor, live: torch.Tensor):
    """Per-axis min and max over each bundle's live rays of the origins and
    the directions (the TPU kernels' 12 block reductions,
    ``frustum_pallas.py:69-74``): (ol, oh, dl, dh), each (B, 3)."""
    lv = live[..., None]
    inf = float("inf")
    return (torch.where(lv, o, inf).amin(1), torch.where(lv, o, -inf).amax(1),
            torch.where(lv, d, inf).amin(1), torch.where(lv, d, -inf).amax(1))


def axis_setup(dl: torch.Tensor, dh: torch.Tensor):
    """Selectors and safe reciprocals of the interval test
    (``frustum_pallas.py:78-83``): the signs of the direction bounds and
    1/dl, 1/dh, with 0 for a bound of 0 or -0.0 (whose constraint the
    selectors then decide without a product)."""
    nzl, nzh = dl != 0.0, dh != 0.0
    idl = torch.where(nzl, 1.0 / torch.where(nzl, dl, 1.0), 0.0)
    idh = torch.where(nzh, 1.0 / torch.where(nzh, dh, 1.0), 0.0)
    return dl > 0.0, dl < 0.0, idl, dh > 0.0, dh < 0.0, idh


def _or_fill(x: torch.Tensor, fill: float) -> torch.Tensor:
    return torch.where(torch.isnan(x), fill, x)


def axis_t_bounds(setup, ol, oh, bl, bh):
    """The t-interval of one axis in which the bundle's reachable set
    [ol + t*dl, oh + t*dh] can meet the slab [bl, bh]
    (``frustum_pallas.py:89-101``): constraint 1, ol + t*dl <= bh, and
    constraint 2, oh + t*dh >= bl, each a bound chosen by the sign of its
    direction bound. Returns (lo, hi), the larger lower and the smaller
    upper bound.

    A product c * (1/d) is NaN where c is 0 and 1/d overflowed (a denormal
    direction bound). The reference's ``jnp.maximum``/``minimum`` would
    carry that NaN into the overlap test and cull a box a ray can hit; here
    a NaN bound is no constraint (-BIG for a lower, BIG for an upper
    bound), so the test stays conservative, and the max/min see no NaN
    (which is what lets the CUDA kernels use ``fmaxf``/``fminf``)."""
    dl_pos, dl_neg, idl, dh_pos, dh_neg, idh = setup
    c1 = bh - ol
    ub1 = torch.where(dl_pos, _or_fill(c1 * idl, BIG),
                      torch.where(dl_neg, BIG, torch.where(c1 >= 0.0, BIG, -BIG)))
    lb1 = torch.where(dl_neg, _or_fill(c1 * idl, -BIG), -BIG)
    c2 = bl - oh
    lb2 = torch.where(dh_pos, _or_fill(c2 * idh, -BIG),
                      torch.where(dh_neg, -BIG, torch.where(c2 <= 0.0, -BIG, BIG)))
    ub2 = torch.where(dh_neg, _or_fill(c2 * idh, BIG), BIG)
    return torch.maximum(lb1, lb2), torch.minimum(ub1, ub2)


def bundle_record_tests(o, d, recs: torch.Tensor, ridx: torch.Tensor, valid: torch.Tensor,
                        best_t: torch.Tensor):
    """Records ``ridx`` (j, M) against every lane of bundles (j, 32, 3):
    (u, v, t, hit), each (j, 32, M); ``hit`` holds only the ``valid``
    records that beat the lane's ``best_t`` (j, 32)."""
    rec = recs[ridx][:, None]                                         # (j, 1, M, 16)
    uu, vv, tt, hit = record_hit(o[..., 0:1], o[..., 1:2], o[..., 2:3],
                                 d[..., 0:1], d[..., 1:2], d[..., 2:3], rec)
    return uu, vv, tt, hit & valid[:, None, :] & (tt < best_t[..., None])


def take_first_min(best, tests, recs_i: torch.Tensor, ridx: torch.Tensor) -> None:
    """Update the running best (t, u, v, id), each (j, 32), in place from
    ``bundle_record_tests``'s output. The kernels test record by record
    with a strict t < best; the first minimal t of the list wins, as here."""
    t_b, u_b, v_b, id_b = best
    uu, vv, tt, hit = tests
    k = torch.argmin(torch.where(hit, tt, float("inf")), dim=2)      # (j, 32)
    won = hit.any(dim=2)

    def take(x):
        return torch.gather(x, 2, k[..., None]).squeeze(2)

    t_b.copy_(torch.where(won, take(tt), t_b))
    u_b.copy_(torch.where(won, take(uu), u_b))
    v_b.copy_(torch.where(won, take(vv), v_b))
    fid = recs_i[torch.gather(ridx, 1, k), 9]
    id_b.copy_(torch.where(won, fid, id_b))


def bundle_leaf_hits(o, d, recs: torch.Tensor, recs_i: torch.Tensor, ridx: torch.Tensor,
                     valid: torch.Tensor, best) -> None:
    """Test records ``ridx`` (j, M), in the kernels' order (``valid``
    marking the real ones), against every lane of bundles (j, 32, 3) and
    update their running best (t, u, v, id) in place."""
    take_first_min(best, bundle_record_tests(o, d, recs, ridx, valid, best[0]), recs_i, ridx)
