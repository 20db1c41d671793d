#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``atray_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, one printed line each (a failing phase raises, exit code != 0):

1. environment: torch and CUDA versions, the card's name and power limit
   (nvidia-smi), then the nvcc build of every kernel in
   ``atray_tpu_torch/csrc/`` and its wall time, every kernel's ptxas
   resources, and ``wide_exact``'s registers, stack frame and spills;
2. ``lane_take`` kernel vs ``lane_take_ref`` at N = 4,147,200 (one chunk of
   the slice) and a ragged N = 65,553 (phase 13's primaries): pack, unpack
   and a scattered map with 5% -1, for C = 15, 14 (the state pack) and 3
   (the colour restore), and C = 3 planes that start 4 bytes past a 16-byte
   boundary; results must be equal; kernel, plain and ``index_select`` (the
   library yardstick) times; the pair path's own routing maps are held the
   same way in phases 10 and 11, where their candidates exist;
3. the slice's host build (scene, 139k-triangle shaded accel), then
   ``wide_shade`` kernel vs ``wide_shade_planes_ref`` on it: 65,536 rays
   (camera primaries and bounce-like rays from their hit points, 10% dead)
   and, at the main path's shape, one 4,147,200-ray chunk of primaries,
   its bounce rays, and the two launches ``render()`` makes at bounces 1
   (full width) and 2 (sorted, live rays packed to a prefix) of that chunk
   in phase 4's frame, captured: a differing id must be a coincident face,
   t within 1 ulp, normals within 1e-6, materials equal, dead lanes give
   the miss sentinel; with ``stats=True`` the hit planes must not change
   and, on every ray whose t, id and material are bit-equal (at least 99%
   of the live rays), the per-ray node and leaf visits must equal the plain
   version's; each set's visits per live ray and warp
   efficiency (mean over max node pops in each 32-ray warp's live lanes);
4. the slice, through ``render()``: 1920x1080, 8 spp, 5 bounces, chunks of
   2*1920*1080 rays, the RenderSettings defaults (sort + lane pack on);
   one warm-up frame, then the launch counters are reset and two frames
   with fresh keys are timed; the film must be finite, in [0, 1], with
   std > 0.01, each chunk must have launched ``wide_shade`` >= 5 times,
   ``lane_take`` must have launched, and no plain version may have run;
   one more frame runs under torch.profiler for device time by kernel;
   a small render on the same scene must agree with the port's CPU render
   (values within 1e-4 except at most 0.2%: a grazing hit decided by one
   ulp forks a path);
5. within the port on the card: at 256x144, 2 spp, 5 bounces the film with
   sort + lane pack on is bit-equal to the film with both off;
6. ``lane_scatter`` kernel vs ``lane_scatter_ref`` at N = 2,073,600 (the
   gradient config's chunk), 4,147,200 and a ragged 65,553, C = 12 and 3,
   on pack and unpack maps (torch.equal) and on a map where every target
   is hit twice (allclose 1e-6: the atomics sum in varying order), and at
   2,073,600 on C = 12 planes that start 4 bytes past a 16-byte boundary;
   kernel, plain and ``index_add_`` times;
7. the unshaded ``make_accel`` of the slice's 139k-triangle mesh, then
   ``wide_exact`` kernel vs ``wide_exact_ref`` on 65,536 mixed rays, on
   the gradient config's 2,073,600 primaries and their bounce rays, and on
   the trainer's own two launches of its first step (phase 9's 16 orbit
   views x 64x64 primaries and their bounce rays, captured from
   ``trace_radiance`` on phase 9's scene at its first vertices, over the
   accel refit to them as the step refits it), under phase 3's rules: t within 1 ulp, u and v
   within 1e-6, a differing id only where the plain version hits
   (coincident faces); each set's kernel time and its bound from the plain
   version's visits;
8. the gradient of ``sum(render(...))`` at ``bench.py``'s backward config
   (960x540, 4 spp, 3 bounces, one chunk, sort + lane pack on) on the
   slice scene's shaded accel: forward and forward+backward seconds, their
   ratio, peak memory; gradients finite, nonzero for albedo and vertices;
   ``lane_scatter`` launched at least twice; ``wide_shade`` launches of
   forward+backward equal to the forward's; no plain version; a profile
   of one forward+backward; then a 48x27 gradient on the card against the
   port's CPU plain versions;
9. the trainer at BASELINE config 5's model width: ``dragon_proxy(139_000)``
   seen from 16 orbit views at 64x64 px, 1 spp, 2 bounces, albedo and
   vertices corrupted as ``examples/inverse_render.py`` does, Adam 3e-2
   (albedo) and 5e-4 (vertices), ``refit=True``: 4 steps on ``make_accel``,
   then 2 on the shaded accel; the loss of the last step must be below the
   first's, ``wide_exact`` and ``wide_shade`` must have launched; then
   ``wide_shade`` on the shaded accel refit to the trained vertices (its
   node records and leaf planes rebuilt) against the plain version under
   phase 3's rules, ``wide_exact`` on the ``make_accel`` refit to them
   under phase 7's rules, the device time of rebuilding the refit
   ``make_accel``'s derived tables, and a profiled ``make_accel`` step;
10. the pair-binned traversal's kernels, each with its ptxas registers and
    spills (Phase A at K = 1, 4, 8), against their plain versions, equal
    (torch.equal), no pad lane a candidate: Phase A (``treelet_candidates``)
    and Phase B (``treelet_pair_walk``, on the binned and capped pairs) on
    the slice accel (776 treelets) at one chunk's bounce rays (phase 3's
    hemisphere rays from the 4,147,200 primaries' hit points), timed, and
    on a small accel whose last treelet row has NaN pad lanes; Phase A at
    K = 1 and 8 on 65,536 of the chunk's live bounce rays, and at K = 1, 4,
    8 on those rays with about a third of their direction components zero
    and, in another set, denormal (1 / d infinite; held on the card only,
    where nothing flushes them), and at K = 4 on boxes with a third of
    their lo and hi planes swapped (the candidates must not change); both
    kernels' bounds count float32 instructions at the issue rate, Phase
    B's from the plain version's counts; both kernels on the pair frame's own
    launches at bounces 1 (full width) and 2 (sorted, packed) of one chunk,
    captured from ``render()``; Phase B on the chunk's pairs shuffled with
    an eighth of the slots dead; both on the slice mesh at 2 leaves a
    treelet, whose box rows span several shared-memory tiles;
    ``lane_take`` on the pair path's routing map (the slot map
    ``treelet_pair_hit`` builds from the chunk's candidates, C = 6, N = K x
    4,147,200) under phase 2's rules; then ``treelet_pair_hit`` against
    ``wide_shade`` on the chunk's bounce rays under phase 3's rules;
11. the slice with ``pair_bounces=True``: one warm-up frame and two timed
    ones with phase 4's keys; the film must equal phase 4's film of the
    same key (pixels that differ are counted, at most 0.05%: an exact tie
    may pick a coincident face), Phase A and Phase B must have launched 16
    times a frame (4 chunks x bounces 1-4), no plain version may run; a
    profiled frame; then phase 8's gradient with ``pair_bounces=True``:
    the pair kernels launch in the forward only, and the gradient equals
    the default path's (within 1e-4 of max |g| but for 0.2% of values);
    ``lane_take`` on the gradient's own routing map (captured from its
    forward: C = 6, N = K x 2,073,600) under phase 2's rules; a profiled
    pair forward+backward;
12. ``ppacket`` (the ``TreePack`` walk), with its ptxas registers and
    spills, against ``ppacket_ref`` on 65,536 mixed rays and on the
    gradient config's 2,073,600 primaries and their bounce rays (phase 7's
    rules, and none of the rays' (t, u, v, id) may differ bit for bit),
    over a ``HybridAccel`` of the slice mesh at leaf_size 8; then
    ``render`` at the gradient config with that ``HybridAccel`` and with
    ``make_accel`` (leaf_size 8), timed, the films equal but for counted
    tie pixels (at most 0.05%), each film's sha256, ``wide_exact``
    launched once and ``ppacket`` twice per render, no plain version; a
    profiled ``HybridAccel`` render;
13. the four lineage walks (``packet_walk``, ``frustum_walk`` over phase
    12's ``TreePack``; ``wide_frustum``, ``persistent_wide`` over its leaf-8
    ``WideBVH``) against their plain versions (bit for bit on every ray),
    with the kernels' own visit counts equal to the plain versions', on phase
    12's 65,536 mixed rays (whose incoherent warps overflow the 8-wide
    walks' leaf queue) and on 65,553 ragged primaries; then timed at full
    width on phase 12's 2,073,600 primaries and bounce rays (the three
    frustum walks on a 262,144-ray prefix of the bounce rays, whose launch
    on all of them takes a second or more) beside ``ppacket`` and
    ``wide_exact`` (held to ``wide_exact_ref`` on the leaf-8 ``WideBVH``
    there under phase 7's rules), each with its bound from the per-ray need
    (``ppacket_ref`` or ``wide_exact_ref`` visits), the ratio of the warp's
    lockstep work to that need, a second bound from that work (the interval
    test once a warp: ``frustum_walk``'s of a node, the wide walks' of each
    of a popped node's 8 child boxes), at the float32 peak and at the issue
    rate, and the shared memory a block, launches and ptxas resources; the timed
    outputs are held against ``ppacket`` or ``wide_exact`` on the same
    rays (phase 7's rules), and ``persistent_wide``, whose warps take
    several bundles at that width (checked against the grid's warps),
    against ``wide_frustum`` bit for bit, visits included, and on the
    primaries against its plain version;
14. the lane-routing probes (``atray_tpu_torch/probes``, P1-P11, the TPU
    kernels of ``scripts/probe_r18.py``-``probe_r22.py``): each kernel
    against its plain version (``check()`` of each probe module: the
    float32 products within rtol 1e-5, atol 1e-5 x reps at reps cut to 64
    or 8, everything else equal; the route probes at the scripts' trip
    counts, the takes at 2,073,600 lanes x 14 planes on the maps of every
    occupancy and a scattered one); then, counted, each probe's table at
    the script's shapes and reps, every line with its bound on the card and
    (for the one-block kernels P1-P9) on one SM; then the plain version's
    and the library call's time (``torch.matmul`` for P1-P5,
    ``index_select`` for P10-P11) at one variant of each.

Each path's launch counts are set to 0 just before it runs and read just
after. Every profile (phases 4, 8, 9, 11, 12) prints device time by kernel
and, where they ran, the lane kernels' device time and launches. Then a
JSON line of per-kernel results (times, launches, bound), and as the last
line ``{"ok": true, "device": {...}}``. The script needs a
CUDA device and the repository checkout; without either it exits non-zero
and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time


HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12        # H100 SXM float32 peak outside the tensor cores
OPS_PER_CHILD_BOX = 25        # slab test of one child box (subs, muls, min/max, compares)
OPS_PER_RECORD = 52           # Moller-Trumbore test of one leaf record
# Phases A and B count float32 instructions, each taken at the card's issue
# rate of one a lane a clock (half the FMA peak, which counts an FMA as two
# operations); their reciprocal runs on its own pipe and counts as one.
FP32_INSTR_PER_S = FP32_OPS_PER_S / 2
INSTR_PER_TREELET = 19        # Phase A, a (live ray, treelet) test: 6 sub, 6 mul, 4 min/max, 3 hit and last-slot
INSTR_PER_RECORD = 15         # Phase B, every record: d x e2 (6 mul, 3 sub), det (3 mul, 2 add), its test
INSTR_PER_FRONT = 12          # a record facing the ray: o - p0 (3 sub), 1 / det, u (4 mul, 2 add), its test (2)
INSTR_PER_U_IN = 26           # u in [0, 1]: q (6 mul, 3 sub), v and t (4 mul, 2 add each), the hit test (5)
OPS_PER_NODE = 25             # slab test of one binary node box (ppacket)
# the frustum walk's interval test of one node box (once a warp):
# axis_t_bounds x 3, each 2 subtractions, 2 products, 2 sign compares, 2 NaN
# tests, a max and a min; then tlo (3 max), hi3 (2 min) and the overlap
# test (a min and a compare)
OPS_PER_INTERVAL = 3 * 10 + 3 + 2 + 2
TIE_PIXELS = 0.0005           # share of film pixels an exact tie may change
FRAME_CHUNK = 2               # phase 3's chunk of the slice frame
FRAME_BOUNCES = (1, 2)        # bounce 1 runs at full width; bounce 2 on, sorted and packed


def _bound(nbytes: float, ops: float = 0.0, instr: float = 0.0):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the float32 operations over the peak rate, or the
    float32 instructions over their issue rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3 + instr / FP32_INSTR_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _walk_ops(visits) -> float:
    return visits["nodes"] * 8 * OPS_PER_CHILD_BOX + visits["records"] * OPS_PER_RECORD


def _reset_counts():
    from atray_tpu_torch.kernels import _build

    for c in _build.COUNTERS.values():
        c.reset()


def _read_counts():
    from atray_tpu_torch.kernels import _build

    return {k: (c.launches, c.plain_calls) for k, c in _build.COUNTERS.items()}


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def _events_ms(fn, reps: int) -> float:
    """Mean ms of ``reps`` calls of ``fn`` between two CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _cuda_ms(fn, reps: int) -> float:
    """``_events_ms`` after one warm-up call."""
    fn()
    return _events_ms(fn, reps)


def _host_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _slice_scene():
    import numpy as np

    from atray_tpu_torch.scene import build_scene, procedural
    from atray_tpu_torch.scene.data import Planes, make_materials
    from atray_tpu_torch.scene.transforms import translate

    mats = make_materials([
        ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.75, 0.55, 0.35), 0.15),
        ((0.0, 0.0, 0.0), (0.6, 0.6, 0.65), 0.0),
    ])
    dragon = translate(procedural.dragon_proxy(target_tris=139_000, material=1),
                       (0.0, 0.0, -4.0))
    planes = Planes(normals=np.asarray([[0.0, 1.0, 0.0]], np.float32),
                    offsets=np.asarray([-1.8], np.float32),
                    material_id=np.asarray([2], np.int32))
    return build_scene([dragon], planes=planes, materials=mats)


def _take_case(cols, idx, label, gpu, phase=2):
    """``lane_take`` against ``lane_take_ref`` (torch.equal) on one map, then
    the kernel's, the plain version's and ``index_select``'s times (the
    library yardstick: one ``index_select`` of the planes with a zero lane
    appended, to which the -1 entries point); returns (ms, plain ms,
    library ms)."""
    import torch

    from atray_tpu_torch.kernels.lane_pack import lane_take, lane_take_ref

    c, n = cols.shape
    got = lane_take(cols, idx)
    want = lane_take_ref(cols, idx)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"lane_take != lane_take_ref (C={c}, N={n}, {label})")
    del got
    ms = _cuda_ms(lambda: lane_take(cols, idx), 20)
    plain_ms = _cuda_ms(lambda: lane_take_ref(cols, idx), 5)
    cols_z = torch.cat([cols, torch.zeros_like(cols[:, :1])], 1)
    idx_z = torch.where(idx >= 0, idx, n).long()
    if not torch.equal(torch.index_select(cols_z, 1, idx_z), want):
        raise AssertionError(f"index_select != lane_take_ref (C={c}, N={n}, {label})")
    lib_ms = _cuda_ms(lambda: torch.index_select(cols_z, 1, idx_z), 20)
    print(f"phase {phase} lane_take C={c} N={n} {label}: equal, kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, index_select {lib_ms:.4f} ms [{gpu}]")
    return ms, plain_ms, lib_ms


def _offset_view(rng, c, n, dev, dtype):
    """(C, N) planes on the card whose first word sits 4 bytes past a
    16-byte boundary (a contiguous view of a larger buffer)."""
    import numpy as np
    import torch

    if dtype == torch.int32:
        flat = rng.integers(-2**31, 2**31, size=c * n + 1, dtype=np.int32)
    else:
        flat = rng.normal(size=c * n + 1).astype(np.float32)
    view = torch.from_numpy(flat).to(dev)[1:].view(c, n)
    assert view.data_ptr() % 16 == 4
    return view


def phase_lane_take(dev, gpu):
    import numpy as np
    import torch

    from atray_tpu_torch.kernels.lane_pack import pack_indices, unpack_indices

    rng = np.random.default_rng(11)
    res = {}
    for n in (4_147_200, 65_553):           # a slice chunk; phase 13's ragged primaries
        alive = torch.from_numpy(rng.random(n) < 0.7).to(dev)
        scat = rng.permutation(n).astype(np.int32)
        scat[rng.random(n) < 0.05] = -1
        maps = {"pack": pack_indices(alive), "unpack": unpack_indices(alive),
                "scattered": torch.from_numpy(scat).to(dev)}
        for c in (15, 14, 3):
            cols = torch.from_numpy(
                rng.integers(-2**31, 2**31, size=(c, n), dtype=np.int32)).to(dev)
            for name, idx in maps.items():
                res[(c, n, name)] = _take_case(cols, idx, name, gpu)
        if n == 4_147_200:
            for name in ("pack", "scattered"):
                view = _offset_view(rng, 3, n, dev, torch.int32)
                res[(3, n, f"{name} offset view")] = _take_case(
                    view, maps[name], f"{name}, planes 4 bytes past a 16-byte boundary", gpu)
    return res


def _planes_rules(got, want, alive, label):
    """Phase 3's rules for two sets of hit planes: dead lanes give the miss
    sentinel, t within 1 ulp, normals within 1e-6, materials equal, a
    differing id only where ``want`` hits (a coincident face). Returns
    (id differences, max |dt| over hits, max normal error, hits)."""
    import numpy as np
    import torch

    from atray_tpu_torch.core.intersect import INF

    torch.cuda.synchronize()
    g = {k: v.cpu().numpy() for k, v in got.items()}
    w = {k: v.cpu().numpy() for k, v in want.items()}
    dead = ~alive.cpu().numpy()
    if not (np.all(g["t"][dead] == np.float32(INF)) and np.all(g["id"][dead] == -1)
            and all(np.all(g[k][dead] == 0) for k in ("nx", "ny", "nz", "mat"))):
        raise AssertionError(f"{label}: dead lanes do not give the miss sentinel")
    hit = w["id"] >= 0
    ulp = np.spacing(np.abs(w["t"]).astype(np.float32))
    dt = np.abs(g["t"] - w["t"])
    id_diff = g["id"] != w["id"]
    nerr = max(float(np.abs(g[k] - w[k]).max()) for k in ("nx", "ny", "nz"))
    if np.any(dt > ulp):
        raise AssertionError(f"{label}: t differs by more than 1 ulp on "
                             f"{int((dt > ulp).sum())} rays")
    if nerr > 1e-6 or not np.array_equal(g["mat"], w["mat"]):
        raise AssertionError(f"{label}: normal error {nerr} or material mismatch")
    if np.any(id_diff & ~hit):
        raise AssertionError(f"{label}: a miss of the reference planes is a hit")
    return int(id_diff.sum()), float(dt[hit].max()) if hit.any() else 0.0, nerr, hit


def _walk_stats(st, alive):
    """(node pops and leaf visits per live ray, the largest node pops, warp
    efficiency, warps) of a stats launch. Warp efficiency: over each
    32-ray warp of the launch that holds a live ray, the mean of its live
    lanes' node pops over their maximum, averaged over those warps: the
    share of a warp's lockstep time its rays use."""
    import torch

    nv, lv = st["node_visits"], st["leaf_visits"]
    live = int(alive.sum())
    if live == 0:
        return 0.0, 0.0, 0, 0.0, 0
    pad = (-nv.shape[0]) % 32
    m = torch.cat([alive, alive.new_zeros(pad)]).reshape(-1, 32)
    v = torch.where(m, torch.cat([nv, nv.new_zeros(pad)]).reshape(-1, 32).double(), 0.0)
    cnt = m.sum(1)
    keep = cnt > 0
    eff = v.sum(1)[keep] / cnt[keep] / v.max(1).values[keep]
    return (float(nv[alive].double().mean()), float(lv[alive].double().mean()),
            int(nv.max()), float(eff.mean()), int(keep.sum()))


def _compare_hits(accel, planes, alive, label, gpu):
    """Kernel vs plain version on one ray set, stats off and on; returns
    (max error, kernel ms, plain ms, kernel output, bound). With stats on
    the kernel's hit planes must equal its planes with stats off, and on
    every ray whose t, id and material equal the plain version's bit for
    bit (at least 99% of the live rays), so must its per-ray node and leaf
    visits: a ray's walk depends on no other ray."""
    import torch

    from atray_tpu_torch.kernels.wide_shade import (
        OUTPUTS, STATS, wide_shade_planes, wide_shade_planes_ref)

    got = wide_shade_planes(accel, *planes, alive)
    got_st = wide_shade_planes(accel, *planes, alive, stats=True)
    visits = {}
    want = wide_shade_planes_ref(accel, *planes, alive, visits=visits, stats=True)
    n_diff, max_abs_t, nerr, hit = _planes_rules(got, want, alive, f"wide_shade {label}")
    if not all(torch.equal(got_st[k], got[k]) for k in OUTPUTS):
        raise AssertionError(f"wide_shade {label}: stats=True changes the hit planes")
    same = ((got["t"].view(torch.int32) == want["t"].view(torch.int32))
            & (got["id"] == want["id"]) & (got["mat"] == want["mat"]))
    n_same = int((same & alive).sum())
    if n_same < 0.99 * int(alive.sum()):
        raise AssertionError(f"wide_shade {label}: only {n_same} live rays bit-equal, "
                             "too few to hold the visit counts to")
    for k in STATS:
        if not torch.equal(got_st[k][same], want[k][same]):
            raise AssertionError(f"wide_shade {label}: per-ray {k} differ on bit-equal rays")
    al = alive.cpu().numpy()
    ms = _cuda_ms(lambda: wide_shade_planes(accel, *planes, alive), 20)
    ms_st = _cuda_ms(lambda: wide_shade_planes(accel, *planes, alive, stats=True), 20)
    plain_ms = _host_ms(lambda: wide_shade_planes_ref(accel, *planes, alive))
    print(f"phase 3 wide_shade {label}: {alive.shape[0]} rays ({int(al.sum())} live, "
          f"{int(hit.sum())} hits): ids differ on {n_diff} (coincident faces), "
          f"max |dt| {max_abs_t:.3g}, max normal err {nerr:.3g}; kernel {ms:.4f} ms, "
          f"with stats {ms_st:.4f} ms, plain {plain_ms:.1f} ms [{gpu}]")
    tab = sum(getattr(accel, k).nbytes for k in ("cboxes", "clinks", "caxis", "tris"))
    io = sum(p.nbytes for p in planes) + alive.nbytes + sum(v.nbytes for v in got.values())
    bound = _bound(io + tab, _walk_ops(visits))
    print(f"phase 3 wide_shade {label}: bound {bound[0]:.4f} ms by {bound[1]} "
          f"({(io + tab) / 1e6:.1f} MB; {visits['nodes']} node pops, "
          f"{visits['records']} records tested)")
    nv, lv, nv_max, eff, warps = _walk_stats(got_st, alive)
    print(f"phase 3 wide_shade {label} stats: per live ray {nv:.3f} node pops (max {nv_max}), "
          f"{lv:.3f} leaf visits; warp efficiency {eff:.4f} over {warps} warps with a live "
          f"ray; kernel counts == plain version's on the {int(same.sum())} of "
          f"{alive.shape[0]} rays with bit-equal t, id and material")
    return max(max_abs_t, nerr), ms, plain_ms, got, bound


def _chunk_rays(dev):
    """Chunk ``FRAME_CHUNK`` (the third) of the slice's four 4,147,200-ray
    chunks (tile order): its camera rays, which cross the dragon."""
    from atray_tpu_torch.core.camera import camera_rays, look_at_camera
    from atray_tpu_torch.render.wavefront import to_tile_order

    cam = look_at_camera((0.0, 1.0, 0.8), (0.0, 0.0, -4.0), h_fov=0.9, aspect=16 / 9)
    o, d = camera_rays(cam, 1920, 1080, 8, device=dev)
    n = 2 * 1920 * 1080
    part = slice(FRAME_CHUNK * n, (FRAME_CHUNK + 1) * n)
    o = to_tile_order(o, 1920, 1080, 8)[part]
    d = to_tile_order(d, 1920, 1080, 8)[part]
    return o, d


def _hemisphere_rays(o, d, hit_out, rng, dev):
    """Rays leaving the hit points of (o, d) over the hemisphere of the hit
    normal (origins nudged off the surface); misses leave from t = 5."""
    import numpy as np
    import torch

    hit = hit_out["id"] >= 0
    t = torch.where(hit, hit_out["t"], 5.0)
    org = o + t[:, None] * d
    nrm = torch.stack([hit_out["nx"], hit_out["ny"], hit_out["nz"]], dim=1)
    u = torch.from_numpy(rng.normal(size=tuple(o.shape)).astype(np.float32)).to(dev)
    u = u / u.norm(dim=1, keepdim=True)
    u = torch.where(((u * nrm).sum(1) < 0)[:, None], -u, u)
    org = org + 1.0e-3 * torch.where(hit[:, None], nrm, 0.0)
    return org, u, hit


def _planes_of(o, d):
    return [o[:, k].contiguous() for k in range(3)] + [d[:, k].contiguous() for k in range(3)]


def phase_wide_shade(scene, accel, dev, gpu):
    """Phase 3; returns (max error, chunk bounce ms, plain ms, bound)."""
    import numpy as np
    import torch

    from atray_tpu_torch.core.camera import camera_rays, look_at_camera

    rng = np.random.default_rng(12)
    # 65,536 rays: 32,768 camera primaries and 32,768 bounce-like rays from
    # their hit points; 10% dead
    cam = look_at_camera((0.0, 1.0, 0.8), (0.0, 0.0, -4.0), h_fov=0.9, aspect=16 / 9)
    o, d = camera_rays(cam, 1920, 1080, 1, device=dev)
    pick = torch.from_numpy(rng.choice(o.shape[0], 32_768, replace=False)).to(dev)
    o, d = o[pick], d[pick]
    ones = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
    _, _, _, prim, _ = _compare_hits(accel, _planes_of(o, d), ones, "primaries 32768", gpu)
    bo, bd, _ = _hemisphere_rays(o, d, prim, rng, dev)
    alive = torch.from_numpy(rng.random(2 * o.shape[0]) >= 0.1).to(dev)
    err1, _, _, _, _ = _compare_hits(accel, _planes_of(torch.cat([o, bo]), torch.cat([d, bd])),
                                     alive, "65536 mixed", gpu)
    # the main path's shape: one chunk of 4,147,200 rays
    o, d = _chunk_rays(dev)
    ones = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
    err2, _, _, prim, _ = _compare_hits(accel, _planes_of(o, d), ones, "chunk primaries", gpu)
    bo, bd, hit = _hemisphere_rays(o, d, prim, rng, dev)
    err3, ms, plain_ms, _, bound = _compare_hits(accel, _planes_of(bo, bd), hit, "chunk bounce",
                                                 gpu)
    del o, d, bo, bd, prim
    # the frame's own launches: what render() hands wide_shade in one chunk
    errs = [err1, err2, err3]
    for b, args in _frame_launches(scene, accel).items():
        errs.append(_compare_hits(accel, args[:6], args[6], f"frame bounce {b}", gpu)[0])
    return max(errs), ms, plain_ms, bound


def _slice_settings():
    from atray_tpu_torch.config import RenderSettings
    from atray_tpu_torch.core.camera import look_at_camera

    w, h = 1920, 1080
    settings = RenderSettings(resolution=(w, h), samples_per_pixel=8, bounce_limit=5,
                              ray_chunk=2 * 1920 * 1080)
    cam = look_at_camera((0.0, 1.0, 0.8), (0.0, 0.0, -4.0), h_fov=0.9, aspect=w / h)
    return settings, cam


def _frame_launches(scene, accel):
    """The arguments ``render()`` hands ``wide_shade`` at ``FRAME_BOUNCES``
    of chunk ``FRAME_CHUNK`` of one slice frame (phase 4's settings, key 0),
    cloned: {bounce: [ox, oy, oz, dx, dy, dz, alive]}. Bounce 1 traces the
    camera bounce's survivors at full width, in tile order; after it the
    state is sorted and its live rays packed to a prefix
    (``wavefront.trace_radiance``), so bounce 2 is the first sorted, packed
    launch."""
    import torch

    from atray_tpu_torch.render import wavefront
    from atray_tpu_torch.render.rng import prng_key

    settings, cam = _slice_settings()
    real = wavefront.wide_shade_planes
    calls, got = [], {}

    def spy(acc, *args, **kw):
        chunk, b = divmod(len(calls), settings.bounce_limit)
        calls.append(b)
        if chunk == FRAME_CHUNK and b in FRAME_BOUNCES:
            got[b] = [a.clone() for a in args]
        return real(acc, *args, **kw)

    wavefront.wide_shade_planes = spy
    try:
        wavefront.render(scene, cam, settings, prng_key(0), accel=accel)
        torch.cuda.synchronize()
    finally:
        wavefront.wide_shade_planes = real
    (w, h), spp = settings.resolution, settings.samples_per_pixel
    chunks = -(-(w * h * spp) // settings.ray_chunk)
    if len(calls) != chunks * settings.bounce_limit or sorted(got) != list(FRAME_BOUNCES):
        raise AssertionError(f"the frame launched wide_shade {len(calls)} times")
    return got


def _pair_frame_launches(scene, accel):
    """The arguments ``render(..., pair_bounces=True)`` hands Phase A and
    Phase B at ``FRAME_BOUNCES`` of chunk ``FRAME_CHUNK`` (phase 11's
    settings, key 0), cloned: {bounce: ([ox, oy, oz, dx, dy, dz, alive],
    [pox, poy, poz, pdx, pdy, pdz, ptid])}. The pair path takes bounces 1
    to 4 of each chunk; bounce 1 is at full width, bounce 2 sorted and
    packed."""
    import torch

    from atray_tpu_torch.kernels import treelet_pairs
    from atray_tpu_torch.render import wavefront
    from atray_tpu_torch.render.rng import prng_key

    settings, cam = _slice_settings()
    settings = dataclasses.replace(settings, pair_bounces=True)
    per_chunk = settings.bounce_limit - 1
    real_a, real_b = treelet_pairs.treelet_candidates, treelet_pairs.treelet_pair_walk
    calls, got = [], {}

    def spy_a(acc, *args, **kw):
        chunk, b = divmod(len(calls), per_chunk)
        calls.append((chunk, b + 1))
        if chunk == FRAME_CHUNK and b + 1 in FRAME_BOUNCES:
            got[b + 1] = ([a.clone() for a in args[:7]],)
        return real_a(acc, *args, **kw)

    def spy_b(acc, *args, **kw):
        chunk, b = calls[-1]
        if chunk == FRAME_CHUNK and b in FRAME_BOUNCES:
            got[b] += ([a.clone() for a in args[:7]],)
        return real_b(acc, *args, **kw)

    treelet_pairs.treelet_candidates, treelet_pairs.treelet_pair_walk = spy_a, spy_b
    try:
        wavefront.render(scene, cam, settings, prng_key(0), accel=accel)
        torch.cuda.synchronize()
    finally:
        treelet_pairs.treelet_candidates, treelet_pairs.treelet_pair_walk = real_a, real_b
    (w, h), spp = settings.resolution, settings.samples_per_pixel
    chunks = -(-(w * h * spp) // settings.ray_chunk)
    if len(calls) != chunks * per_chunk or sorted(got) != list(FRAME_BOUNCES):
        raise AssertionError(f"the pair frame launched Phase A {len(calls)} times")
    return got


def phase_slice(scene, accel, dev, gpu):
    import numpy as np
    import torch

    from atray_tpu_torch.render.film import save_png
    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.render.wavefront import render

    settings, cam = _slice_settings()
    (w, h), spp, bounces = settings.resolution, settings.samples_per_pixel, settings.bounce_limit
    t0 = time.perf_counter()
    film, _ = render(scene, cam, settings, prng_key(0), accel=accel, return_stats=True)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0

    _reset_counts()
    frames = []
    for seed in (1, 2):
        t0 = time.perf_counter()
        film, stats = render(scene, cam, settings, prng_key(seed), accel=accel,
                             return_stats=True)
        live = int(stats["rays_cast"])       # synchronizes
        frames.append((time.perf_counter() - t0, live))
    counts = _read_counts()
    chunks = -(-(w * h * spp) // settings.ray_chunk)
    if counts["wide_shade"][0] < 5 * chunks * len(frames):
        raise AssertionError(f"wide_shade launched {counts['wide_shade'][0]} times")
    if counts["lane_take"][0] <= 0:
        raise AssertionError("lane_take never launched on the main path")
    if any(c[1] for c in counts.values()):
        raise AssertionError(f"a plain version ran on the main path: {counts}")
    f = film.cpu().numpy()
    if f.shape != (h, w, 3) or not np.isfinite(f).all() or f.min() < 0 or f.max() > 1:
        raise AssertionError("film is not finite (H, W, 3) in [0, 1]")
    if not f.std() > 0.01:
        raise AssertionError(f"film std {f.std()} <= 0.01")
    os.makedirs("out", exist_ok=True)
    save_png("out/chip_smoke.png", film, srgb=True, avoid_collision=False)
    for i, (sec, live) in enumerate(frames):
        print(f"phase 4 slice frame {i + 1}: 1920x1080 x {spp} spp x {bounces} bounces, "
              f"{chunks} chunks: {sec:.4f} s, live rays {live}, "
              f"{live / sec:.6g} live rays/s [{gpu}]")
    print(f"phase 4 slice: warm-up frame {warm_s:.4f} s; launches over the 2 timed frames "
          f"wide_shade {counts['wide_shade'][0]}, lane_take {counts['lane_take'][0]}, "
          f"plain calls 0; film std {f.std():.4f}; wrote out/chip_smoke.png")
    frame_s = sum(sec for sec, _ in frames) / len(frames)
    _profile_frame(lambda: render(scene, cam, settings, prng_key(3), accel=accel), frame_s, gpu)
    return counts, film, frames


_KERNEL_NAMES = ("wide_shade", "lane_take", "lane_scatter", "wide_exact", "treelet_phase_a",
                 "treelet_phase_b", "ppacket")


def _profile_frame(run, frame_s, gpu, label="phase 4", what="one slice frame"):
    """Device time of one run by kernel, from torch.profiler; the busy
    share is kernel time over the un-profiled wall time ``frame_s``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    groups = {k: [0.0, 0] for k in _KERNEL_NAMES + ("torch ops",)}
    top = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = float(getattr(e, "self_device_time_total", 0.0))
        name = next((k for k in _KERNEL_NAMES if f"{k}_kernel" in e.key), "torch ops")
        groups[name][0] += us
        groups[name][1] += e.count
        if name == "torch ops":
            top.append((us, e.count, e.key))
    total = sum(g[0] for g in groups.values())
    if total <= 0:
        print(f"{label} profile: the profiler recorded no device time (not measured)")
        return
    parts = ", ".join(f"{k} {v[0] / 1e3:.3f} ms ({100 * v[0] / total:.1f}%, {v[1]} launches)"
                      for k, v in groups.items() if v[1])
    print(f"{label} profile of {what}: device kernel time {total / 1e3:.3f} ms = "
          f"{parts}; busy share {total / 1e6 / frame_s:.3f} of the {frame_s:.4f} s run [{gpu}]")
    lanes = [f"{k} {groups[k][0] / 1e3:.4f} ms over {groups[k][1]} launches"
             for k in ("lane_take", "lane_scatter") if groups[k][1]]
    if lanes:
        print(f"{label} profile lane kernels: {', '.join(lanes)} [{gpu}]")
    for us, count, key in sorted(top, reverse=True)[:6]:
        print(f"{label} profile top torch kernel: {us / 1e3:.3f} ms, {count} launches, {key[:90]}")


def phase_small_vs_cpu(scene, accel_host, dev, gpu):
    import numpy as np
    import torch

    from atray_tpu_torch.config import RenderSettings
    from atray_tpu_torch.core.camera import look_at_camera
    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.render.wavefront import render

    s = RenderSettings(resolution=(48, 27), samples_per_pixel=1, bounce_limit=5)
    cam = look_at_camera((0.0, 1.0, 0.8), (0.0, 0.0, -4.0), h_fov=0.9, aspect=16 / 9)
    gpu_film = render(scene, cam, s, prng_key(3), accel=accel_host, device=dev).cpu().numpy()
    cpu_film = render(scene, cam, s, prng_key(3), accel=accel_host, device="cpu").numpy()
    bad = np.abs(gpu_film - cpu_film) > 1e-4
    if bad.mean() > 0.002:
        raise AssertionError(f"small render: {int(bad.sum())} of {bad.size} values differ "
                             "from the CPU render by more than 1e-4")
    print(f"phase 4 small render 48x27 x 1 spp x 5 bounces: card vs CPU plain versions "
          f"{int(bad.sum())} of {bad.size} values beyond 1e-4, max |diff| "
          f"{float(np.abs(gpu_film - cpu_film).max()):.3g}")


def phase_identity(scene, accel, gpu):
    import torch

    from atray_tpu_torch.config import RenderSettings
    from atray_tpu_torch.core.camera import look_at_camera
    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.render.wavefront import render

    cam = look_at_camera((0.0, 1.0, 0.8), (0.0, 0.0, -4.0), h_fov=0.9, aspect=16 / 9)

    def go(on):
        s = RenderSettings(resolution=(256, 144), samples_per_pixel=2, bounce_limit=5,
                           sort_bounces=on, lane_pack=on)
        return render(scene, cam, s, prng_key(4), accel=accel)

    a, b = go(True), go(False)
    if not torch.equal(a, b):
        raise AssertionError("sorted + packed film != unsorted film")
    print(f"phase 5 identity 256x144 x 2 spp x 5 bounces: sort+pack film == plain film "
          f"(torch.equal) [{gpu}]")


def _scatter_case(cols, dst, label, gpu, exact=True):
    """``lane_scatter`` against ``lane_scatter_ref`` (torch.equal, or within
    1e-6 where duplicates sum in varying order), then the kernel's, the
    plain version's and ``index_add_``'s times; returns (ms, plain ms,
    library ms, bound, max |err|)."""
    import torch

    from atray_tpu_torch.kernels.lane_pack import lane_scatter, lane_scatter_ref

    c, n = cols.shape
    got = lane_scatter(cols, dst)
    want = lane_scatter_ref(cols, dst)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not exact:
        if not torch.allclose(got, want, rtol=1e-6, atol=1e-6):
            raise AssertionError(f"lane_scatter != lane_scatter_ref beyond 1e-6 "
                                 f"(C={c}, N={n}, {label}): {err}")
    elif not torch.equal(got, want):
        raise AssertionError(f"lane_scatter != lane_scatter_ref (C={c}, N={n}, {label})")
    ok = dst >= 0
    d_ok, v_ok = dst[ok].long(), cols[:, ok].contiguous()
    ms = _cuda_ms(lambda: lane_scatter(cols, dst), 20)
    plain_ms = _cuda_ms(lambda: lane_scatter_ref(cols, dst), 3)
    lib_ms = _cuda_ms(lambda: torch.zeros_like(cols).index_add_(1, d_ok, v_ok), 20)
    bound = _bound(2 * cols.nbytes + dst.nbytes)
    print(f"phase 6 lane_scatter C={c} N={n} {label}: "
          f"{'equal' if exact else 'allclose'} (max |err| {err:.3g}), "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, "
          f"bound {bound[0]:.4f} ms by {bound[1]} [{gpu}]")
    return ms, plain_ms, lib_ms, bound, err


def phase_lane_scatter(dev, gpu):
    import numpy as np
    import torch

    from atray_tpu_torch.kernels.lane_pack import pack_indices, unpack_indices

    rng = np.random.default_rng(13)
    res = {}
    for n in (2_073_600, 4_147_200, 65_553):
        alive = torch.from_numpy(rng.random(n) < 0.7).to(dev)
        dup = (np.arange(n) // 2).astype(np.int32)
        dup[rng.random(n) < 0.05] = -1
        maps = {"pack": pack_indices(alive), "unpack": unpack_indices(alive),
                "duplicates": torch.from_numpy(dup).to(dev)}
        for c in (12, 3):
            cols = torch.from_numpy(rng.normal(size=(c, n)).astype(np.float32)).to(dev)
            for name, dst in maps.items():
                res[(c, n, name)] = _scatter_case(cols, dst, name, gpu, name != "duplicates")
        if n == 2_073_600:
            view = _offset_view(rng, 12, n, dev, torch.float32)
            res[(12, n, "pack offset view")] = _scatter_case(
                view, maps["pack"], "pack, planes 4 bytes past a 16-byte boundary", gpu)
    return res


def _exact_compare(accel, o, d, label, gpu, phase=7):
    """wide_exact kernel vs plain version on one ray set: t within 1 ulp,
    u and v within 1e-6 where the ids agree, a differing id only where the
    plain version hits. Returns (max error, kernel ms, plain ms, bound)."""
    import numpy as np
    import torch

    from atray_tpu_torch.kernels.wide_exact import wide_exact_first_hit, wide_exact_ref

    got = wide_exact_first_hit(accel, o, d)
    visits = {}
    want = wide_exact_ref(accel, o, d, visits=visits)
    torch.cuda.synchronize()
    (gt, gu, gv, gi), (wt, wu, wv, wi) = ([x.cpu().numpy() for x in r] for r in (got, want))
    hit = wi >= 0
    dt = np.abs(gt - wt)
    if np.any(dt > np.spacing(np.abs(wt).astype(np.float32))):
        raise AssertionError(f"wide_exact {label}: t differs by more than 1 ulp")
    same = gi == wi
    if np.any(~same & ~hit):
        raise AssertionError(f"wide_exact {label}: a plain-version miss is a kernel hit")
    uverr = max(float(np.abs(gu - wu)[same].max(initial=0.0)),
                float(np.abs(gv - wv)[same].max(initial=0.0)))
    if uverr > 1e-6:
        raise AssertionError(f"wide_exact {label}: u/v error {uverr}")
    ms = _cuda_ms(lambda: wide_exact_first_hit(accel, o, d), 20)
    plain_ms = _host_ms(lambda: wide_exact_ref(accel, o, d))
    tab = sum(getattr(accel, k).nbytes for k in ("cboxes", "clinks", "tris"))
    io = o.nbytes + d.nbytes + sum(x.nbytes for x in got)
    bound = _bound(io + tab, _walk_ops(visits))
    max_dt = float(dt[hit].max()) if hit.any() else 0.0
    print(f"phase {phase} wide_exact {label}: {o.shape[0]} rays ({int(hit.sum())} hits): ids differ "
          f"on {int((~same).sum())} (coincident faces), max |dt| {max_dt:.3g}, max u/v err "
          f"{uverr:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound {bound[0]:.4f} ms "
          f"by {bound[1]} ({visits['nodes']} node pops, {visits['records']} records) [{gpu}]")
    return max(max_dt, uverr), ms, plain_ms, bound


def _bwd_camera():
    from atray_tpu_torch.core.camera import look_at_camera

    return look_at_camera((0.0, 1.0, 0.8), (0.0, 0.0, -4.0), h_fov=0.9, aspect=16 / 9)


def _trainer_scene():
    """BASELINE config 5's scene: ``dragon_proxy(139_000)`` at (0, 0, -4)."""
    from atray_tpu_torch.scene import build_scene, procedural
    from atray_tpu_torch.scene.data import make_materials
    from atray_tpu_torch.scene.transforms import translate

    mats = make_materials([
        ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.8, 0.45, 0.25), 0.2),
    ])
    body = translate(procedural.dragon_proxy(target_tris=139_000, material=1), (0, 0, -4))
    return build_scene([body], materials=mats)


TRAIN_VIEWS, TRAIN_RES = 16, 64


def _trainer_rays(dev):
    """The trainer's primaries: 16 orbit views x 64x64 px x 1 spp, view by view."""
    import numpy as np
    import torch

    from atray_tpu_torch.core.camera import camera_rays, look_at_camera

    origs, dirns = [], []
    for v in range(TRAIN_VIEWS):
        ang = 2 * np.pi * v / TRAIN_VIEWS
        cam = look_at_camera((2.5 * np.sin(ang), 0.8, -4 + 2.5 * np.cos(ang)), (0, 0, -4),
                             h_fov=0.8, aspect=1.0)
        o, d = camera_rays(cam, TRAIN_RES, TRAIN_RES, 1, device=dev)
        origs.append(o)
        dirns.append(d)
    return torch.cat(origs), torch.cat(dirns)


def _trainer_start(vertices):
    """The trainer's first vertices: ``vertices`` corrupted by seeded noise
    (std 0.004), as ``examples/inverse_render.py`` does."""
    import numpy as np
    import torch

    noise = np.random.default_rng(3).normal(0, 0.004, tuple(vertices.shape))
    return vertices + torch.from_numpy(noise.astype(np.float32)).to(vertices.device)


def _trainer(scene_host, accels, orig, dirn, dev):
    """Phase 9's trainer over the primaries (``orig``, ``dirn``): the target
    traced at the true parameters on the first of ``accels`` (name ->
    accel), albedo (x 0.4 + 0.2) and vertices (``_trainer_start``)
    corrupted, one Adam, and a ``make_train_step`` (2 bounces,
    ``refit=True``) for each accel. Returns (scene, true params, params,
    target, steps by name)."""
    import dataclasses

    import torch

    from atray_tpu_torch.dist.train import make_train_step
    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.render.wavefront import trace_radiance

    scene = scene_host.to(dev)
    with torch.no_grad():
        target = trace_radiance(scene, orig, dirn, 2, prng_key(0),
                                accel=next(iter(accels.values())))
    true = scene.params()
    p = dataclasses.replace(true, albedo=(true.albedo * 0.4 + 0.2).requires_grad_(),
                            vertices=_trainer_start(true.vertices).requires_grad_())
    opt = torch.optim.Adam([{"params": [p.albedo], "lr": 3e-2},
                            {"params": [p.vertices], "lr": 5e-4}])
    steps = {name: make_train_step(scene_host, 2, opt, accel=acc, refit=True, device=dev)
             for name, acc in accels.items()}
    return scene, true, p, target, steps


def _trainer_launches(scene, accel, orig, dirn):
    """The (orig, dirn) that one trainer step's ``trace_radiance`` (2
    bounces) hands ``wide_exact``: the primaries, then the bounce rays at
    full width (dead lanes included, as the gather path walks them), cloned."""
    import torch

    from atray_tpu_torch.render import wavefront
    from atray_tpu_torch.render.rng import prng_key

    real = wavefront.wide_exact_first_hit
    got = []

    def spy(acc, o, d):
        got.append((o.clone(), d.clone()))
        return real(acc, o, d)

    wavefront.wide_exact_first_hit = spy
    try:
        with torch.no_grad():
            wavefront.trace_radiance(scene, orig, dirn, 2, prng_key(0), accel=accel)
        torch.cuda.synchronize()
    finally:
        wavefront.wide_exact_first_hit = real
    if len(got) != 2:
        raise AssertionError(f"a 2-bounce trainer trace launched wide_exact {len(got)} times")
    return got


def _exact_sets(shaded, accel, trainer, dev):
    """Phase 7's ray sets, label -> (accel, orig, dirn): over ``accel``,
    65,536 mixed rays (camera primaries and bounce-like rays from their hit
    points on ``shaded``), the gradient config's one chunk of 2,073,600
    primaries (tile order) and their bounce rays; then the trainer's two
    launches of its first step (``trainer`` = (scene, primaries' orig,
    dirn)) over ``accel`` refit to the trainer's first vertices, as the step
    walks them (``refit_wide`` widens every box by the largest vertex move)."""
    import dataclasses

    import numpy as np
    import torch

    from atray_tpu_torch.accel.wide import refit_wide
    from atray_tpu_torch.core.camera import camera_rays
    from atray_tpu_torch.kernels.wide_shade import wide_shade_planes
    from atray_tpu_torch.render.wavefront import to_tile_order

    def hemisphere(o, d, rng):
        fo = wide_shade_planes(shaded, *_planes_of(o, d),
                               torch.ones(o.shape[0], dtype=torch.bool, device=dev))
        bo, bd, _ = _hemisphere_rays(o, d, fo, rng, dev)
        return bo.contiguous(), bd.contiguous()

    rng = np.random.default_rng(14)
    o, d = camera_rays(_bwd_camera(), 960, 540, 1, device=dev)
    pick = torch.from_numpy(rng.choice(o.shape[0], 32_768, replace=False)).to(dev)
    o, d = o[pick], d[pick]
    bo, bd = hemisphere(o, d, rng)
    sets = {"65536 mixed": (accel, torch.cat([o, bo]).contiguous(),
                            torch.cat([d, bd]).contiguous())}
    o, d = camera_rays(_bwd_camera(), 960, 540, 4, device=dev)
    o = to_tile_order(o, 960, 540, 4).contiguous()
    d = to_tile_order(d, 960, 540, 4).contiguous()
    sets["chunk primaries"] = (accel, o, d)
    sets["chunk bounce"] = (accel, *hemisphere(o, d, rng))
    scene, orig, dirn = trainer
    start = _trainer_start(scene.mesh.vertices)
    refit = refit_wide(accel, start, scene.mesh.faces)
    moved = scene.with_params(dataclasses.replace(scene.params(), vertices=start))
    for label, od in zip(("trainer primaries", "trainer bounce"),
                         _trainer_launches(moved, refit, orig, dirn)):
        sets[label] = (refit, *od)
    return sets


def phase_wide_exact(scene_host, shaded, trainer, dev, gpu):
    from atray_tpu_torch.accel.wide import make_accel
    from atray_tpu_torch.config import KDTreeConfig

    t0 = time.perf_counter()
    host = make_accel(scene_host.mesh.vertices, scene_host.mesh.faces, KDTreeConfig(leaf_size=16))
    t_build = time.perf_counter() - t0
    tbytes = sum(getattr(host, k).nbytes for k in ("cboxes", "clinks", "tris"))
    print(f"phase 7 host build: make_accel {t_build:.2f} s ({host.num_nodes} wide nodes, "
          f"wide depth {host.max_depth}, tables {tbytes / 1e6:.1f} MB)")
    accel = host.to(dev)
    res = {label: _exact_compare(acc, o, d, label, gpu)
           for label, (acc, o, d) in _exact_sets(shaded, accel, trainer, dev).items()}
    _, ms, plain_ms, bound = res["65536 mixed"]
    return host, max(r[0] for r in res.values()), ms, plain_ms, bound


def _grad_leaves(scene):
    from atray_tpu_torch.scene.data import SceneParams

    return SceneParams(*(x.detach().clone().requires_grad_() for x in scene.params().leaves()))


def phase_gradient(scene, accel, scene_host, accel_host, dev, gpu):
    import numpy as np
    import torch

    from atray_tpu_torch.config import RenderSettings
    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.render.wavefront import render

    settings = RenderSettings(resolution=(960, 540), samples_per_pixel=4, bounce_limit=3,
                              ray_chunk=0)
    cam = _bwd_camera()
    p = _grad_leaves(scene)

    def loss_of(k):
        return render(scene.with_params(p), cam, settings, prng_key(k), accel=accel).sum()

    def fwd(k):
        with torch.no_grad():
            return float(loss_of(k))

    def fwd_bwd(k):
        loss = loss_of(k)
        return torch.autograd.grad(loss, p.leaves())

    fwd(100)
    fwd_bwd(100)
    torch.cuda.synchronize()
    f_runs = [_host_ms(lambda k=k: fwd(k)) / 1e3 for k in (1, 2, 3)]
    b_runs = [_host_ms(lambda k=k: fwd_bwd(k)) / 1e3 for k in (1, 2, 3)]
    t_f, t_b = min(f_runs), min(b_runs)
    torch.cuda.reset_peak_memory_stats()

    _reset_counts()
    loss = loss_of(3)
    torch.cuda.synchronize()
    fwd_counts = _read_counts()
    grads = torch.autograd.grad(loss, p.leaves())
    torch.cuda.synchronize()
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    if counts["wide_shade"][0] != fwd_counts["wide_shade"][0]:
        raise AssertionError(f"the backward launched wide_shade: {fwd_counts} -> {counts}")
    if counts["lane_scatter"][0] < 2:
        raise AssertionError(f"lane_scatter launched {counts['lane_scatter'][0]} times")
    if any(c[1] for c in counts.values()):
        raise AssertionError(f"a plain version ran on the gradient path: {counts}")
    names = ("vertices", "normals", "emission", "albedo", "scatter")
    g = {k: v.cpu().numpy() for k, v in zip(names, grads)}
    if not all(np.isfinite(v).all() for v in g.values()):
        raise AssertionError("non-finite gradient")
    if not (np.abs(g["albedo"]).max() > 0 and np.abs(g["vertices"]).max() > 0):
        raise AssertionError("albedo or vertex gradient is zero")
    print(f"phase 8 gradient 960x540 x 4 spp x 3 bounces (2,073,600 rays, one chunk, sort + "
          f"lane pack): forward {t_f:.4f} s, forward+backward {t_b:.4f} s, ratio "
          f"{t_b / t_f:.3f} (best of 3: forward {', '.join(f'{x:.4f}' for x in f_runs)}; "
          f"forward+backward {', '.join(f'{x:.4f}' for x in b_runs)}), "
          f"max_memory_allocated {peak / 2**30:.3f} GiB [{gpu}]")
    print(f"phase 8 gradient launches: forward wide_shade {fwd_counts['wide_shade'][0]}, "
          f"lane_take {fwd_counts['lane_take'][0]}; after backward wide_shade "
          f"{counts['wide_shade'][0]}, lane_take {counts['lane_take'][0]}, lane_scatter "
          f"{counts['lane_scatter'][0]}; plain calls 0; max |g|: "
          + ", ".join(f"{k} {float(np.abs(v).max()):.4g}" for k, v in g.items()))
    _profile_frame(lambda: fwd_bwd(4), t_b, gpu, "phase 8", "one forward+backward")

    # a small gradient on the card against the CPU plain versions
    small = RenderSettings(resolution=(48, 27), samples_per_pixel=1, bounce_limit=3)
    out = {}
    for where, sc, ac in (("cuda", scene, accel), ("cpu", scene_host.to("cpu"), accel_host)):
        q = _grad_leaves(sc)
        loss = render(sc.with_params(q), cam, small, prng_key(5), accel=ac, device=where).sum()
        out[where] = [x.cpu().numpy() for x in torch.autograd.grad(loss, q.leaves())]
    worst = []
    for k, a, b in zip(names, out["cuda"], out["cpu"]):
        scale = max(float(np.abs(b).max()), 1e-30)
        bad = np.abs(a - b) > 1e-4 * scale
        if bad.mean() > 0.002:
            raise AssertionError(f"48x27 gradient: {k} differs beyond 1e-4 of max |g| on "
                                 f"{int(bad.sum())} of {bad.size} values")
        worst.append(f"{k} {float(np.abs(a - b).max()) / scale:.3g} ({int(bad.sum())} beyond)")
    print("phase 8 gradient 48x27 x 1 spp x 3 bounces, card vs CPU plain versions, max |diff| "
          "/ max |g|: " + ", ".join(worst))
    return counts, (t_f, t_b, peak)


def _device_ms(fn):
    """(ms, kernels) of device kernel time of one call of ``fn``, from
    torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(float(getattr(e, "self_device_time_total", 0.0)) for e in evs) / 1e3,
            sum(e.count for e in evs))


def phase_trainer(wide_host, scene_host, orig, dirn, dev, gpu):
    import torch

    from atray_tpu_torch.accel.pack import TRI_STRIDE
    from atray_tpu_torch.accel.shaded import build_shaded_accel, refit_shaded
    from atray_tpu_torch.accel.wide import leaf_planes, node_records, refit_wide
    from atray_tpu_torch.config import KDTreeConfig
    from atray_tpu_torch.kernels.wide_shade import wide_shade_planes, wide_shade_planes_ref
    from atray_tpu_torch.render.rng import fold_in, prng_key

    t0 = time.perf_counter()
    shaded = build_shaded_accel(scene_host, KDTreeConfig(leaf_size=16))
    t_shaded = time.perf_counter() - t0
    views, res = TRAIN_VIEWS, TRAIN_RES
    scene, true, p, target, steps = _trainer(
        scene_host, {"make_accel": wide_host, "shaded accel": shaded}, orig, dirn, dev)
    _reset_counts()
    losses, secs, plan = [], [], ["make_accel"] * 4 + ["shaded accel"] * 2
    for s, name in enumerate(plan):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(steps[name](p, orig, dirn, target, fold_in(prng_key(0), s))))
        secs.append(time.perf_counter() - t0)
    counts = _read_counts()
    if counts["wide_exact"][0] < 4 * 2 or counts["wide_shade"][0] < 2 * 2:
        raise AssertionError(f"trainer launches {counts}")
    if any(c[1] for c in counts.values()):
        raise AssertionError(f"a plain version ran on the trainer path: {counts}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"trainer loss did not fall: {losses}")
    # the kernel on a refit accel (fresh node records and leaf planes) against
    # the plain version on the moved mesh, under phase 3's rules
    with torch.no_grad():
        moved = refit_shaded(shaded.to(dev), scene.with_params(p))
        planes = _planes_of(orig, dirn)
        alive = torch.ones(orig.shape[0], dtype=torch.bool, device=dev)
        got = wide_shade_planes(moved, *planes, alive)
        want = wide_shade_planes_ref(moved, *planes, alive)
        n_diff, dt, nerr, hit = _planes_rules(got, want, alive, "wide_shade after refit_shaded")
        moved_by = float((p.vertices - true.vertices).abs().max())
    print(f"phase 9 wide_shade after refit_shaded (vertices moved by "
          f"{moved_by:.3g}): {orig.shape[0]} rays "
          f"({int(hit.sum())} hits), ids differ on {n_diff}, max |dt| {dt:.3g}, max normal err "
          f"{nerr:.3g}, t bit-equal {torch.equal(got['t'], want['t'])}")
    # wide_exact on the make_accel refit to the trained vertices (its node
    # records and leaf planes rebuilt from the widened boxes), phase 7's rules
    with torch.no_grad():
        refit = refit_wide(wide_host, p.vertices, scene.mesh.faces)
        err, _, _, _ = _exact_compare(refit, orig, dirn, "after refit_wide", gpu, phase=9)
        tab_ms, tab_kernels = _device_ms(lambda: (
            node_records(refit.cboxes, refit.clinks, refit.caxis),
            leaf_planes(refit.tris, refit.leaf_size, TRI_STRIDE)))
    print(f"phase 9 derived tables of the refit make_accel (rebuilt every step): cnodes + "
          f"cleaves {tab_ms:.4f} ms of device time in {tab_kernels} kernels [{gpu}]")
    print(f"phase 9 trainer: dragon_proxy(139_000), {views} views x {res}x{res} px = "
          f"{orig.shape[0]} rays, 1 spp, 2 bounces, refit=True; shaded accel build "
          f"{t_shaded:.2f} s; losses {', '.join(f'{x:.6g}' for x in losses)}")
    print(f"phase 9 trainer step seconds: make_accel "
          f"{', '.join(f'{x:.4f}' for x in secs[:4])}; shaded accel "
          f"{', '.join(f'{x:.4f}' for x in secs[4:])}; launches wide_exact "
          f"{counts['wide_exact'][0]}, wide_shade {counts['wide_shade'][0]}, plain calls 0 [{gpu}]")
    key = fold_in(prng_key(0), len(plan))
    _profile_frame(lambda: steps["make_accel"](p, orig, dirn, target, key),
                   sum(secs[1:4]) / 3, gpu, "phase 9", "one make_accel trainer step")
    return counts, err

def _nan_lane_case(dev, rng):
    """A small shaded accel whose last treelet row has NaN pad lanes
    (dragon_proxy(1200), leaf_size 16, 2 leaves per treelet) and 65,536
    rays around it, 10% dead."""
    import numpy as np
    import torch

    from atray_tpu_torch.accel.shaded import build_shaded_accel
    from atray_tpu_torch.config import KDTreeConfig
    from atray_tpu_torch.scene import build_scene, procedural
    from atray_tpu_torch.scene.data import make_materials
    from atray_tpu_torch.scene.transforms import translate

    mats = make_materials([((0.3, 0.4, 0.6), (0.0, 0.0, 0.0), 0.0),
                           ((0.0, 0.0, 0.0), (0.7, 0.6, 0.5), 0.1)])
    mesh = translate(procedural.dragon_proxy(target_tris=1200, material=1), (0.0, 0.0, -4.0))
    host = build_shaded_accel(build_scene([mesh], materials=mats),
                              KDTreeConfig(leaf_size=16, leaves_per_treelet=2))
    if not (host.num_treelets % 8 and np.isnan(host.tboxes[:, :48]).any()):
        raise AssertionError("the small accel has no NaN pad lanes")
    n = 65_536
    o = (rng.normal(size=(n, 3)) * 0.8 + [0.0, 0.0, -4.0]).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    alive = torch.from_numpy(rng.random(n) >= 0.1).to(dev)
    return host.to(dev), _planes_of(torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)), alive


def _phase_a_case(acc, planes, alive, label, gpu, k=None, time_plain=True):
    """Phase A kernel vs its plain version on one ray set (torch.equal, no
    pad lane a candidate); returns (tids, (ms, plain ms, bound))."""
    import torch

    from atray_tpu_torch.kernels.treelet_pairs import (
        PAIR_K, treelet_candidates, treelet_candidates_ref)

    k = PAIR_K if k is None else k
    n = alive.shape[0]
    tids, bound = treelet_candidates(acc, *planes, alive, k)
    want = treelet_candidates_ref(acc, *planes, alive, k)
    torch.cuda.synchronize()
    if not (torch.equal(tids, want[0]) and torch.equal(bound, want[1])):
        raise AssertionError(f"treelet_phase_a {label}: kernel != plain version")
    if int(tids.max()) >= acc.num_treelets:
        raise AssertionError(f"treelet_phase_a {label}: a pad lane became a candidate")
    ms = _cuda_ms(lambda: treelet_candidates(acc, *planes, alive, k), 20)
    plain = _host_ms(lambda: treelet_candidates_ref(acc, *planes, alive, k)) if time_plain else None
    live = int(alive.sum())
    t_pad = 8 * acc.tboxes.shape[0]
    bnd = _bound(sum(p.nbytes for p in planes) + alive.nbytes + acc.tboxes.nbytes
                 + tids.nbytes + bound.nbytes,
                 instr=live * acc.num_treelets * INSTR_PER_TREELET)
    plain_txt = f"plain {plain:.1f} ms, " if plain is not None else ""
    print(f"phase 10 treelet_phase_a {label}: {n} rays ({live} live), {acc.num_treelets} "
          f"treelets ({t_pad} with pads, {acc.tboxes.shape[0]} rows), K={k}: equal, "
          f"{int((tids >= 0).sum())} candidates, {int((bound < 1e30).sum())} rays with a "
          f"(K+1)-th; kernel {ms:.4f} ms, {plain_txt}bound {bnd[0]:.4f} ms by {bnd[1]} [{gpu}]")
    return tids, (ms, plain, bnd)


def _phase_b_case(acc, pairs, ptid, label, gpu, time_plain=True):
    """Phase B kernel vs its plain version on one set of pair slots
    (torch.equal on all six planes); returns (planes, (ms, plain ms, bound))."""
    import torch

    from atray_tpu_torch.kernels.treelet_pairs import treelet_pair_walk, treelet_pair_walk_ref

    got = treelet_pair_walk(acc, *pairs, ptid)
    visits = {}
    ref = treelet_pair_walk_ref(acc, *pairs, ptid, visits=visits)
    torch.cuda.synchronize()
    for key in got:
        if not torch.equal(got[key], ref[key]):
            raise AssertionError(f"treelet_phase_b {label}: kernel != plain version ({key})")
    ms = _cuda_ms(lambda: treelet_pair_walk(acc, *pairs, ptid), 20)
    plain = _host_ms(lambda: treelet_pair_walk_ref(acc, *pairs, ptid)) if time_plain else None
    bnd = _bound(sum(p.nbytes for p in pairs) + ptid.nbytes + acc.tris.nbytes
                 + sum(v.nbytes for v in got.values()),
                 instr=visits["records"] * INSTR_PER_RECORD + visits["front"] * INSTR_PER_FRONT
                 + visits["u_in"] * INSTR_PER_U_IN)
    plain_txt = f"plain {plain:.1f} ms, " if plain is not None else ""
    print(f"phase 10 treelet_phase_b {label}: {ptid.shape[0]} pair slots "
          f"({int((ptid >= 0).sum())} live, {int((got['id'] >= 0).sum())} hits, "
          f"{visits['records']} records tested, {visits['front']} facing, {visits['u_in']} with u in "
          f"[0, 1]): equal; kernel {ms:.4f} ms, {plain_txt}bound "
          f"{bnd[0]:.4f} ms by {bnd[1]} [{gpu}]")
    return got, (ms, plain, bnd)


def _pair_kernels(acc, planes, alive, label, gpu, time_plain=True):
    """Phase A and Phase B kernels vs their plain versions on one ray set
    (Phase B on the binned, capped pairs of Phase A's candidates); returns
    {"a": (ms, plain ms, bound), "b": (...), "route": (slot keys, sort
    permutation, cap, Phase B's pair planes, pair treelets, result planes)}."""
    import torch

    from atray_tpu_torch.kernels.treelet_pairs import bin_pairs, pair_cap

    n = alive.shape[0]
    tids, a = _phase_a_case(acc, planes, alive, label, gpu, time_plain=time_plain)
    cap = pair_cap(n)
    keys, perm, ptid = bin_pairs(tids, acc.num_treelets, cap)
    pairs = list(torch.index_select(torch.stack(planes), 1, perm[:cap] % n))
    got, b = _phase_b_case(acc, pairs, ptid, label, gpu, time_plain=time_plain)
    return {"a": a, "b": b, "route": (keys, perm, cap, pairs, ptid, got)}


def _edge_directions(planes, alive, rng, value):
    """The rays ``planes`` with about a third of their direction components
    set to ``value`` (0: zero components; 1e-40: denormals, whose inverse
    is infinite), never all three of a ray."""
    import numpy as np
    import torch

    n = alive.shape[0]
    m = rng.random((n, 3)) < 0.34
    m[m.all(axis=1), 0] = False
    sign = np.where(rng.random((n, 3)) < 0.5, -1.0, 1.0).astype(np.float32)
    out = list(planes[:3])
    for a in range(3):
        sub = torch.from_numpy(np.float32(value) * sign[:, a]).to(alive.device)
        out.append(torch.where(torch.from_numpy(m[:, a]).to(alive.device), sub,
                               planes[3 + a]).contiguous())
    return out


def _swapped_boxes(acc, rng):
    """``acc`` with the lo and hi planes of about a third of its (row, axis,
    lane) box entries swapped: Phase A gives the same result for any box."""
    import torch

    tb = acc.tboxes.clone()
    swap = torch.from_numpy(rng.random((tb.shape[0], 24)) < 0.33).to(tb.device)
    lo, hi = tb[:, 0:24].clone(), tb[:, 24:48].clone()
    tb[:, 0:24] = torch.where(swap, hi, lo)
    tb[:, 24:48] = torch.where(swap, lo, hi)
    return dataclasses.replace(acc, tboxes=tb.contiguous())


def phase_pair_kernels(scene_host, scene, accel, dev, gpu):
    import numpy as np
    import torch

    from atray_tpu_torch.accel.shaded import build_shaded_accel
    from atray_tpu_torch.config import KDTreeConfig
    from atray_tpu_torch.kernels.treelet_pairs import (
        _words, pair_slots, treelet_candidates, treelet_pair_hit)
    from atray_tpu_torch.kernels.wide_shade import wide_shade_planes

    for k in (1, 4, 8):
        print(f"phase 10 treelet_phase_a K={k} ptxas: {_ptxas('treelet_phase_a', f'ILi{k}E')}")
    print(f"phase 10 treelet_phase_b ptxas: {_ptxas('treelet_phase_b')}")
    rng = np.random.default_rng(15)
    o, d = _chunk_rays(dev)
    prim = wide_shade_planes(accel, *_planes_of(o, d),
                             torch.ones(o.shape[0], dtype=torch.bool, device=dev))
    bo, bd, alive = _hemisphere_rays(o, d, prim, rng, dev)
    planes = _planes_of(bo, bd)
    del o, d, prim, bo, bd
    res = _pair_kernels(accel, planes, alive, "chunk bounce", gpu)
    _pair_kernels(*_nan_lane_case(dev, rng), "NaN-lane accel", gpu)

    # the template's ends, K = 1 and 8, on 65,536 of the chunk's live bounce
    # rays; then the same rays with zero and with denormal direction
    # components (1 / d is infinite for a denormal, so t can be NaN); these
    # are held on the card only, where nothing flushes denormals
    live = torch.nonzero(alive).squeeze(1)[:65_536]
    sub = [p[live].contiguous() for p in planes]
    ones = torch.ones(live.shape[0], dtype=torch.bool, device=dev)
    for k in (1, 8):
        _phase_a_case(accel, sub, ones, "live bounce rays", gpu, k=k)
    for name, value in (("zero", 0.0), ("denormal", 1.0e-40)):
        edge = _edge_directions(sub, ones, rng, value)
        for k in (1, 4, 8):
            _phase_a_case(accel, edge, ones, f"live bounce rays, {name} direction components",
                          gpu, k=k, time_plain=False)
    # boxes with lo and hi swapped: the kernel reads their tboxes_ordered
    tids_sw, _ = _phase_a_case(_swapped_boxes(accel, rng), sub, ones,
                               "live bounce rays, a third of the box planes swapped", gpu,
                               time_plain=False)
    if not torch.equal(tids_sw, treelet_candidates(accel, *sub, ones)[0]):
        raise AssertionError("treelet_phase_a: swapped box planes changed the candidates")
    del tids_sw

    # the pair frame's own launches: Phase A and Phase B at bounces 1 (full
    # width) and 2 (sorted and packed) of one chunk
    for b, (args_a, args_b) in _pair_frame_launches(scene, accel).items():
        _phase_a_case(accel, args_a[:6], args_a[6], f"frame bounce {b}", gpu, time_plain=False)
        _phase_b_case(accel, args_b[:6], args_b[6], f"frame bounce {b}", gpu, time_plain=False)

    # Phase B on the chunk's pairs in a shuffled order, an eighth of the
    # slots dead, interleaved
    keys, perm, cap, pairs, ptid, walked = res.pop("route")
    shuffle = torch.from_numpy(rng.permutation(cap)).to(dev)
    dead = torch.from_numpy(rng.random(cap) < 0.125).to(dev)
    _phase_b_case(accel, [p[shuffle].contiguous() for p in pairs],
                  torch.where(dead, -1, ptid[shuffle]).to(torch.int32).contiguous(),
                  "shuffled slots, 1/8 dead", gpu, time_plain=False)
    del pairs, ptid, shuffle, dead

    # boxes over more than one shared-memory tile: the slice mesh at 2
    # leaves a treelet
    t0 = time.perf_counter()
    fine = build_shaded_accel(scene_host, KDTreeConfig(leaf_size=16, leaves_per_treelet=2))
    t_fine = time.perf_counter() - t0
    fine = fine.to(dev)
    print(f"phase 10 host build: shaded accel at 2 leaves a treelet {t_fine:.2f} s "
          f"({fine.num_treelets} treelets, {fine.tboxes.shape[0]} box rows)")
    sub_alive = torch.from_numpy(rng.random(live.shape[0]) >= 0.1).to(dev)
    _pair_kernels(fine, sub, sub_alive, "bounce rays 10% dead, 2 leaves a treelet", gpu,
                  time_plain=False)
    del fine, sub, sub_alive

    # phase 2's check on the pair path's own routing map: the slot map
    # treelet_pair_hit builds from these candidates over Phase B's result
    # words, zero-padded to the K*R slots as the path pads them
    words = _words(walked)
    words = torch.cat([words, words.new_zeros((6, keys.shape[0] - cap))], dim=1)
    slot = pair_slots(keys, perm, cap)
    _take_case(words, slot, f"pair routing ({int((slot >= 0).sum())} routed, cap {cap})", gpu,
               phase=10)
    del keys, perm, walked, words, slot

    got, unres = treelet_pair_hit(accel, *planes, alive)
    walk = wide_shade_planes(accel, *planes, alive)
    n_diff, max_dt, nerr, _ = _planes_rules(got, walk, alive, "treelet_pair_hit vs wide_shade")
    pair_ms = _cuda_ms(lambda: treelet_pair_hit(accel, *planes, alive), 10)
    walk_ms = _cuda_ms(lambda: wide_shade_planes(accel, *planes, alive), 10)
    print(f"phase 10 treelet_pair_hit vs wide_shade, chunk bounce ({int(alive.sum())} live of "
          f"{alive.shape[0]}): ids differ on {n_diff} (coincident faces), max |dt| {max_dt:.3g}, "
          f"max normal err {nerr:.3g}, {int(unres.sum())} unresolved rays re-walked; "
          f"treelet_pair_hit {pair_ms:.4f} ms, wide_shade {walk_ms:.4f} ms [{gpu}]")
    return res


def phase_pair_slice(scene, accel, walk_film, walk_frames, dev, gpu):
    import numpy as np
    import torch

    from atray_tpu_torch.config import RenderSettings
    from atray_tpu_torch.core.camera import look_at_camera
    from atray_tpu_torch.kernels.treelet_pairs import PAIR_K
    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.render.wavefront import render

    settings = RenderSettings(resolution=(1920, 1080), samples_per_pixel=8, bounce_limit=5,
                              ray_chunk=2 * 1920 * 1080, pair_bounces=True)
    w, h, spp, bounces = settings.width, settings.height, 8, 5
    cam = look_at_camera((0.0, 1.0, 0.8), (0.0, 0.0, -4.0), h_fov=0.9, aspect=16 / 9)
    t0 = time.perf_counter()
    render(scene, cam, settings, prng_key(0), accel=accel)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    _reset_counts()
    frames = []
    for seed in (1, 2):
        t0 = time.perf_counter()
        film, stats = render(scene, cam, settings, prng_key(seed), accel=accel,
                             return_stats=True)
        live = int(stats["rays_cast"])       # synchronizes
        frames.append((time.perf_counter() - t0, live))
    counts = _read_counts()
    chunks = -(-(w * h * spp) // settings.ray_chunk)
    per_frame = chunks * (bounces - 1)
    for name in ("treelet_phase_a", "treelet_phase_b"):
        if counts[name][0] != per_frame * len(frames):
            raise AssertionError(f"{name} launched {counts[name][0]} times, not "
                                 f"{per_frame} a frame")
    if any(c[1] for c in counts.values()):
        raise AssertionError(f"a plain version ran on the pair path: {counts}")
    differ = (film != walk_film).any(dim=-1)
    n_px = int(differ.sum())
    if n_px > TIE_PIXELS * w * h:
        raise AssertionError(f"pair film != walk film on {n_px} pixels")
    for i, ((sec, live), (wsec, _)) in enumerate(zip(frames, walk_frames)):
        print(f"phase 11 pair slice frame {i + 1}: {sec:.4f} s, live rays {live}, "
              f"{live / sec:.6g} live rays/s (phase 4's walk frame {wsec:.4f} s, "
              f"{live / wsec:.6g} live rays/s) [{gpu}]")
    print(f"phase 11 pair slice: warm-up frame {warm_s:.4f} s; launches over the 2 timed frames "
          f"treelet_phase_a {counts['treelet_phase_a'][0]}, treelet_phase_b "
          f"{counts['treelet_phase_b'][0]}, wide_shade {counts['wide_shade'][0]}, lane_take "
          f"{counts['lane_take'][0]}, plain calls 0; film of key 2 vs the walk film: "
          f"{'torch.equal' if n_px == 0 else f'{n_px} pixels differ (ties)'}")
    frame_s = sum(sec for sec, _ in frames) / len(frames)
    _profile_frame(lambda: render(scene, cam, settings, prng_key(3), accel=accel), frame_s, gpu,
                   "phase 11", "one pair slice frame")

    # phase 8's gradient with pair_bounces: the pair kernels run in the forward only
    gset = RenderSettings(resolution=(960, 540), samples_per_pixel=4, bounce_limit=3,
                          ray_chunk=0)
    cam = _bwd_camera()
    out = {}
    for pair in (True, False):
        s = dataclasses.replace(gset, pair_bounces=pair)
        p = _grad_leaves(scene)

        def warm():
            render(scene.with_params(p), cam, s, prng_key(100), accel=accel).sum().backward()

        if pair:
            route = _first_routing_take(warm)
        else:
            warm()
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        loss = render(scene.with_params(p), cam, s, prng_key(6), accel=accel).sum()
        torch.cuda.synchronize()
        t_f = time.perf_counter() - t0
        fwd = _read_counts()
        grads = torch.autograd.grad(loss, p.leaves())
        torch.cuda.synchronize()
        t_fb = time.perf_counter() - t0
        out[pair] = (grads, fwd, _read_counts(), t_f, t_fb)
    grads, fwd, after, t_f, t_fb = out[True]
    for name in ("treelet_phase_a", "treelet_phase_b"):
        if fwd[name][0] != 2 or after[name][0] != fwd[name][0]:
            raise AssertionError(f"{name}: forward {fwd[name][0]}, after backward "
                                 f"{after[name][0]} launches")
    if any(c[1] for c in after.values()):
        raise AssertionError(f"a plain version ran on the pair gradient: {after}")
    worst = []
    for name, a, b in zip(("vertices", "normals", "emission", "albedo", "scatter"),
                          grads, out[False][0]):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if not np.isfinite(a).all():
            raise AssertionError(f"pair gradient of {name} is not finite")
        scale = max(float(np.abs(b).max()), 1e-30)
        bad = np.abs(a - b) > 1e-4 * scale
        if bad.mean() > 0.002:
            raise AssertionError(f"pair gradient of {name} differs from the default beyond "
                                 f"1e-4 of max |g| on {int(bad.sum())} values")
        worst.append(f"{name} {float(np.abs(a - b).max()) / scale:.3g}")
    print(f"phase 11 pair gradient 960x540 x 4 spp x 3 bounces: forward {t_f:.4f} s, "
          f"forward+backward {t_fb:.4f} s (default path {out[False][3]:.4f} s, "
          f"{out[False][4]:.4f} s); treelet_phase_a/b launches forward "
          f"{fwd['treelet_phase_a'][0]}/{fwd['treelet_phase_b'][0]}, after backward "
          f"{after['treelet_phase_a'][0]}/{after['treelet_phase_b'][0]}; vs the default "
          f"gradient, max |diff| / max |g|: {', '.join(worst)} [{gpu}]")

    # phase 2's check on the gradient's own routing map (one 2,073,600-ray
    # chunk: N = K x 2,073,600, where one plane and the index overflow L2),
    # then the pair forward+backward's device time
    words, slot = route
    if slot.shape[0] != PAIR_K * gset.width * gset.height * gset.samples_per_pixel:
        raise AssertionError(f"the pair gradient's routing take has {slot.shape[0]} lanes")
    _take_case(words, slot, f"pair gradient routing ({int((slot >= 0).sum())} routed)", gpu,
               phase=11)
    del words, slot, route
    s = dataclasses.replace(gset, pair_bounces=True)
    p = _grad_leaves(scene)

    def fwd_bwd():
        loss = render(scene.with_params(p), cam, s, prng_key(6), accel=accel).sum()
        torch.autograd.grad(loss, p.leaves())

    _profile_frame(fwd_bwd, t_fb, gpu, "phase 11", "one pair forward+backward")
    return counts


def _first_routing_take(run):
    """Runs ``run()`` and returns the arguments of the pair path's first
    ``lane_take`` (the routing take of ``treelet_pair_hit``'s first call:
    its result words and slot map), cloned."""
    import torch

    from atray_tpu_torch.kernels import treelet_pairs

    real, got = treelet_pairs.lane_take, []

    def spy(words, slot):
        if not got:
            got.append((words.clone(), slot.clone()))
        return real(words, slot)

    treelet_pairs.lane_take = spy
    try:
        run()
        torch.cuda.synchronize()
    finally:
        treelet_pairs.lane_take = real
    if not got:
        raise AssertionError("the pair path made no routing take")
    return got[0]


def _bit_diffs(got, want) -> int:
    """Rays whose (t, u, v, id) differ bit for bit between two hit tuples."""
    import numpy as np

    pairs = [(a.cpu().numpy().view(np.int32), b.cpu().numpy().view(np.int32))
             for a, b in zip(got, want)]
    return int(np.any([a != b for a, b in pairs], axis=0).sum())


def _packet_compare(pack, o, d, label, gpu):
    """ppacket kernel vs plain version under phase 7's rules; returns (max
    error, kernel ms, plain ms, bound)."""
    import numpy as np
    import torch

    from atray_tpu_torch.kernels.persistent_packet import ppacket_first_hit, ppacket_ref

    got = ppacket_first_hit(pack, o, d)
    visits = {}
    want = ppacket_ref(pack, o, d, visits=visits)
    torch.cuda.synchronize()
    n_bits = _bit_diffs(got, want)
    (gt, gu, gv, gi), (wt, wu, wv, wi) = ([x.cpu().numpy() for x in r] for r in (got, want))
    hit = wi >= 0
    dt = np.abs(gt - wt)
    if np.any(dt > np.spacing(np.abs(wt).astype(np.float32))):
        raise AssertionError(f"ppacket {label}: t differs by more than 1 ulp")
    same = gi == wi
    if np.any(~same & ~hit):
        raise AssertionError(f"ppacket {label}: a plain-version miss is a kernel hit")
    uverr = max(float(np.abs(gu - wu)[same].max(initial=0.0)),
                float(np.abs(gv - wv)[same].max(initial=0.0)))
    if uverr > 1e-6:
        raise AssertionError(f"ppacket {label}: u/v error {uverr}")
    if n_bits:
        raise AssertionError(f"ppacket {label}: (t, u, v, id) differ bit for bit from "
                             f"ppacket_ref on {n_bits} rays")
    ms = _cuda_ms(lambda: ppacket_first_hit(pack, o, d), 20)
    plain_ms = _host_ms(lambda: ppacket_ref(pack, o, d))
    tab = sum(getattr(pack, k).nbytes for k in ("nodebox", "ctrl", "tris"))
    io = o.nbytes + d.nbytes + sum(x.nbytes for x in got)
    bound = _bound(io + tab, visits["nodes"] * OPS_PER_NODE + visits["records"] * OPS_PER_RECORD)
    max_dt = float(dt[hit].max()) if hit.any() else 0.0
    print(f"phase 12 ppacket {label}: {o.shape[0]} rays ({int(hit.sum())} hits): ids differ on "
          f"{int((~same).sum())} (coincident faces), max |dt| {max_dt:.3g}, max u/v err "
          f"{uverr:.3g}, (t, u, v, id) differ bit for bit on {n_bits} rays; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.1f} ms, bound {bound[0]:.4f} ms by {bound[1]} ({visits['nodes']} "
          f"node visits, {visits['records']} records) [{gpu}]")
    return max(max_dt, uverr), ms, plain_ms, bound, visits


def phase_ppacket(scene, scene_host, shaded, dev, gpu):
    import numpy as np
    import torch

    from atray_tpu_torch.accel.wide import hybrid_from_mesh, make_accel
    from atray_tpu_torch.config import KDTreeConfig, RenderSettings
    from atray_tpu_torch.core.camera import camera_rays
    from atray_tpu_torch.kernels.wide_shade import wide_shade_planes
    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.render.wavefront import render, to_tile_order

    v, f = scene_host.mesh.vertices, scene_host.mesh.faces
    cfg = KDTreeConfig(leaf_size=8)
    t0 = time.perf_counter()
    hybrid = hybrid_from_mesh(v, f, cfg)
    t_build = time.perf_counter() - t0
    pack_bytes = sum(getattr(hybrid.pack, k).nbytes for k in ("nodebox", "ctrl", "tris"))
    print(f"phase 12 host build: HybridAccel (leaf_size 8) {t_build:.2f} s "
          f"({hybrid.pack.num_nodes} binary nodes, TreePack tables {pack_bytes / 1e6:.1f} MB, "
          f"{hybrid.wide.num_nodes} wide nodes)")
    hybrid = hybrid.to(dev)
    wide = make_accel(v, f, cfg).to(dev)
    print(f"phase 12 ppacket ptxas: {_ptxas('ppacket')}")

    def hemisphere(o, d, rng):
        fo = wide_shade_planes(shaded, *_planes_of(o, d),
                               torch.ones(o.shape[0], dtype=torch.bool, device=dev))
        bo, bd, _ = _hemisphere_rays(o, d, fo, rng, dev)
        return bo.contiguous(), bd.contiguous()

    rng = np.random.default_rng(16)
    o, d = camera_rays(_bwd_camera(), 960, 540, 1, device=dev)
    pick = torch.from_numpy(rng.choice(o.shape[0], 32_768, replace=False)).to(dev)
    o, d = o[pick], d[pick]
    bo, bd = hemisphere(o, d, rng)
    sets = {"65536 mixed": (torch.cat([o, bo]).contiguous(), torch.cat([d, bd]).contiguous())}
    err1, _, _, _, _ = _packet_compare(hybrid.pack, *sets["65536 mixed"], "65536 mixed", gpu)
    o, d = camera_rays(_bwd_camera(), 960, 540, 4, device=dev)
    o = to_tile_order(o, 960, 540, 4).contiguous()
    d = to_tile_order(d, 960, 540, 4).contiguous()
    err2, pr_ms, _, _, pr_need = _packet_compare(hybrid.pack, o, d, "chunk primaries", gpu)
    bo, bd = hemisphere(o, d, rng)
    err3, ms, plain_ms, bound, bo_need = _packet_compare(hybrid.pack, bo, bd, "chunk bounce", gpu)
    sets["chunk primaries"], sets["chunk bounce"] = (o, d), (bo, bd)
    walks = {"pack": hybrid.pack, "wide": wide, "sets": sets,
             "ppacket": {"chunk primaries": (pr_ms, pr_need), "chunk bounce": (ms, bo_need)}}

    settings = RenderSettings(resolution=(960, 540), samples_per_pixel=4, bounce_limit=3,
                              ray_chunk=0)
    cam = _bwd_camera()
    secs = {}
    for name, acc in (("make_accel", wide), ("HybridAccel", hybrid), ("HybridAccel", hybrid),
                      ("make_accel", wide)):
        render(scene, cam, settings, prng_key(100), accel=acc)
        _reset_counts()
        t0 = time.perf_counter()
        film = render(scene, cam, settings, prng_key(8), accel=acc)
        torch.cuda.synchronize()
        secs.setdefault(name, []).append(time.perf_counter() - t0)
        counts = _read_counts()
        if name == "HybridAccel":
            h_film, h_counts = film, counts
            if counts["wide_exact"][0] != 1 or counts["ppacket"][0] != 2:
                raise AssertionError(f"HybridAccel render launches {counts}")
        else:
            w_film = film
        if any(c[1] for c in counts.values()):
            raise AssertionError(f"a plain version ran on the {name} render: {counts}")
    n_px = int((h_film != w_film).any(dim=-1).sum())
    if n_px > TIE_PIXELS * h_film.shape[0] * h_film.shape[1]:
        raise AssertionError(f"HybridAccel film != make_accel film on {n_px} pixels")
    print(f"phase 12 render 960x540 x 4 spp x 3 bounces, one chunk: HybridAccel "
          f"{', '.join(f'{x:.4f}' for x in secs['HybridAccel'])} s, make_accel (leaf_size 8) "
          f"{', '.join(f'{x:.4f}' for x in secs['make_accel'])} s; HybridAccel launches "
          f"wide_exact {h_counts['wide_exact'][0]}, ppacket {h_counts['ppacket'][0]}, plain "
          f"calls 0; films {'torch.equal' if n_px == 0 else f'differ on {n_px} pixels (ties)'}; "
          f"film sha256 HybridAccel {_digest(h_film)}, make_accel {_digest(w_film)} [{gpu}]")
    _profile_frame(lambda: render(scene, cam, settings, prng_key(8), accel=hybrid),
                   sum(secs["HybridAccel"]) / 2, gpu, "phase 12", "one HybridAccel render")
    return h_counts, max(err1, err2, err3), ms, plain_ms, bound, walks


def _digest(film) -> str:
    """The first 16 hex digits of the sha256 of a film's float32 bytes."""
    import hashlib

    return hashlib.sha256(film.detach().cpu().numpy().tobytes()).hexdigest()[:16]


LINEAGE_CUT = 262_144     # the bounce rays' prefix timed for CUT_WALKS
# the walks whose one launch on all the bounce rays takes a second or more:
# timed on the prefix, so that their times compare across commits
CUT_WALKS = ("frustum_walk", "wide_frustum", "persistent_wide")
# held to their plain versions bit for bit (all four lineage walks)
BIT_EQUAL = ("packet_walk", "frustum_walk", "wide_frustum", "persistent_wide")
LINEAGE = (               # (counter, table, TPU kernel it replaces)
    ("packet_walk", "pack", "atray_tpu/kernels/traverse_pallas.py:137"),
    ("frustum_walk", "pack", "atray_tpu/kernels/frustum_pallas.py:57"),
    ("wide_frustum", "wide", "atray_tpu/kernels/wide_pallas.py:48"),
    ("persistent_wide", "wide", "atray_tpu/kernels/persistent_pallas.py:37"),
)


def _lineage_fns():
    """name -> (public entry point, its diagnostic twin that counts the
    walk's own visits, plain version)."""
    from atray_tpu_torch.kernels import frustum_walk, packet_walk, persistent_wide, wide_frustum

    return {"packet_walk": (packet_walk.packet_first_hit, packet_walk._first_hit,
                            packet_walk.packet_ref),
            "frustum_walk": (frustum_walk.frustum_first_hit, frustum_walk._first_hit,
                             frustum_walk.frustum_ref),
            "wide_frustum": (wide_frustum.wide_first_hit, wide_frustum._first_hit,
                             wide_frustum.wide_ref),
            "persistent_wide": (persistent_wide.persistent_first_hit, persistent_wide._first_hit,
                                persistent_wide.persistent_ref)}


def _ptxas(name: str, template: str = "") -> str:
    """The ``-Xptxas -v`` stack frame and spills, and registers, of
    ``<name>_kernel`` (the instance whose mangled template arguments begin
    with ``template``) in this process's build."""
    from atray_tpu_torch.kernels import _build

    lines = _build._loaded.log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and f"{name}_kernel{template}" in line:
            frame = ""
            for nxt in lines[i + 1:]:
                if "stack frame" in nxt:
                    frame = nxt.strip() + "; "
                if "registers" in nxt:
                    return frame + nxt.split(":", 1)[-1].strip()
    return "not in this process's build log"


def _lineage_ops(kind: str, v) -> float:
    per_node = 8 * OPS_PER_CHILD_BOX if kind == "wide" else OPS_PER_NODE
    return v["nodes"] * per_node + v["records"] * OPS_PER_RECORD


def _warp_ops(name: str, work) -> float:
    """Operations of a lineage walk's own work: every live lane's record
    tests, and the node tests as the walk takes them: a slab test a lane
    (``packet_walk``), or the interval test once a warp ("warp_nodes": a
    node of ``frustum_walk``, each of the 8 child boxes of a popped wide
    node)."""
    if name == "packet_walk":
        return _lineage_ops("pack", work)
    boxes = 1 if name == "frustum_walk" else 8      # interval tests a warp node step
    return work["warp_nodes"] * boxes * OPS_PER_INTERVAL + work["records"] * OPS_PER_RECORD


def _smem_line(name: str, acc) -> str:
    """Dynamic shared memory a block of a lineage walk's launch on the
    tables ``acc``."""
    from atray_tpu_torch.kernels import _build

    if name == "packet_walk":
        return "0 B dynamic"
    return f"{getattr(_build.load(), f'atray_{name}_smem')(acc.leaf_size)} B dynamic"


def _hold(got, want, what):
    """Phase 7's rules for hits ``got`` against ``want`` (plain version or
    per-ray kernel): t within 1 ulp, u and v within 1e-6 where the ids
    agree, a differing id only where ``want`` hits (a coincident face).
    Returns (max |dt| on hits, max u/v error, ids that differ, hits)."""
    import numpy as np

    (gt, gu, gv, gi), (wt, wu, wv, wi) = ([x.cpu().numpy() for x in r] for r in (got, want))
    hit = wi >= 0
    dt = np.abs(gt - wt)
    if np.any(dt > np.spacing(np.abs(wt).astype(np.float32))):
        raise AssertionError(f"{what}: t differs by more than 1 ulp")
    same = gi == wi
    if np.any(~same & ~hit):
        raise AssertionError(f"{what}: a miss of the reference is a hit")
    uverr = max(float(np.abs(gu - wu)[same].max(initial=0.0)),
                float(np.abs(gv - wv)[same].max(initial=0.0)))
    if uverr > 1e-6:
        raise AssertionError(f"{what}: u/v error {uverr}")
    return (float(dt[hit].max()) if hit.any() else 0.0), uverr, int((~same).sum()), int(hit.sum())


def _lineage_compare(name, acc, o, d, label, gpu):
    """Lineage kernel vs its plain version, bit for bit on every ray for the
    walks of ``BIT_EQUAL``, under phase 7's rules for any other, and the
    kernel's own visit counts equal to the plain version's. Returns
    (max error, plain ms, visits)."""
    import torch

    _, counted, ref = _lineage_fns()[name]
    kv, pv = {}, {}
    got = counted(acc, o, d, visits=kv)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = ref(acc, o, d, visits=pv)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if name in BIT_EQUAL:
        n_bits = _bit_diffs(got, want)
        if n_bits:
            raise AssertionError(f"{name} {label}: (t, u, v, id) differ bit for bit from the "
                                 f"plain version on {n_bits} rays")
        nhit, err = int((want[3] >= 0).sum()), 0.0
        held = "(t, u, v, id) == plain version bit for bit on every ray"
    else:
        max_dt, uverr, ndiff, nhit = _hold(got, want, f"{name} {label} vs plain")
        err = max(max_dt, uverr)
        held = (f"ids differ on {ndiff} (coincident faces), max |dt| {max_dt:.3g}, max u/v err "
                f"{uverr:.3g}")
    if kv != pv:
        raise AssertionError(f"{name} {label}: kernel visits {kv} != plain visits {pv}")
    drained = (f", {kv['drain_warps']} of {-(-o.shape[0] // 32)} warps drained the leaf queue "
               f"in mid-walk ({kv['drains']} drains)" if "drains" in kv else "")
    warp = f", {kv['warp_nodes']} warp node steps" if "warp_nodes" in kv else ""
    print(f"phase 13 {name} {label}: {o.shape[0]} rays ({nhit} hits): {held}, kernel visits "
          f"== plain visits ({kv['nodes']} nodes, {kv['records']} records{warp}){drained}; "
          f"plain {plain_ms:.1f} ms [{gpu}]")
    return err, plain_ms, kv


PLAIN_PIECE = 131_072     # rays per call of the plain version at full width


def _persistent_at_width(wide, o, d, got, work, same, same_work, label, gpu):
    """``persistent_wide`` at a timed shape, where warps take several
    bundles: the set must have more bundles than the grid has warps, the
    hits and visits must equal ``wide_frustum``'s (one bundle a warp) bit
    for bit, and on the primaries the plain version's too (in pieces of
    whole bundles: bundles are independent)."""
    import torch

    from atray_tpu_torch.kernels.persistent_wide import grid_warps, persistent_ref

    bundles, warps = -(-o.shape[0] // 32), grid_warps(o.device, wide.leaf_size)
    if bundles <= warps:
        raise AssertionError(f"persistent_wide {label}: {bundles} bundles for {warps} warps")
    if not all(torch.equal(a, b) for a, b in zip(got, same)) or work != same_work:
        raise AssertionError(f"persistent_wide {label}: != wide_frustum's hits or visits")
    msg = ""
    if label == "chunk primaries":
        pv, parts = {}, []
        t0 = time.perf_counter()
        for s in range(0, o.shape[0], PLAIN_PIECE):
            parts.append(persistent_ref(wide, o[s:s + PLAIN_PIECE], d[s:s + PLAIN_PIECE], pv))
        want = tuple(torch.cat(x) for x in zip(*parts))
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        max_dt, uverr, ndiff, _ = _hold(got, want, f"persistent_wide {label} vs plain")
        if pv != work:
            raise AssertionError(f"persistent_wide {label}: visits {work} != plain {pv}")
        msg = (f"; == plain version (ids differ on {ndiff}, max |dt| {max_dt:.3g}, max u/v err "
               f"{uverr:.3g}, visits equal; plain {plain_s:.1f} s)")
    print(f"phase 13 persistent_wide {label}: {o.shape[0]} rays, {bundles} bundles for "
          f"{warps} resident warps; hits and visits == wide_frustum's bit for bit{msg} [{gpu}]")


def phase_lineage(walks, gpu):
    """Phase 13: the four lineage walks against their plain versions on
    phase 12's mixed rays, a ragged set and (the 8-wide ones) warps that
    overflow the leaf queue; then timed at full width on the gradient
    config's primaries and bounce rays beside ``ppacket`` and ``wide_exact``
    on the same tables, with bounds from the per-ray need, and held at that
    shape against the per-ray kernels (and ``persistent_wide``, whose warps
    loop there, against ``wide_frustum`` and its plain version)."""
    import torch

    from atray_tpu_torch.kernels.persistent_packet import ppacket_first_hit, ppacket_ref
    from atray_tpu_torch.kernels.wide_exact import wide_exact_first_hit, wide_exact_ref

    t_phase = time.perf_counter()
    tabs = {"pack": walks["pack"], "wide": walks["wide"]}
    sets = walks["sets"]
    po, pd = sets["chunk primaries"]
    # the ragged set: the 65,553 consecutive primaries (render order) with
    # the most hits, so that its warps cross the dragon
    width = 65_553
    hits = torch.cumsum((wide_exact_first_hit(tabs["wide"], po, pd)[3] >= 0).long(), 0)
    start = int(torch.argmax(hits[width:] - hits[:-width])) + 1
    ragged = (po[start:start + width].contiguous(), pd[start:start + width].contiguous())
    res = {}
    for name, kind, _ in LINEAGE:
        acc = tabs[kind]
        err1, plain_ms, kv = _lineage_compare(name, acc, *sets["65536 mixed"], "65536 mixed", gpu)
        if kind == "wide" and not kv["drain_warps"]:
            raise AssertionError(f"{name}: no warp of the mixed set drained the leaf queue")
        err2, _, _ = _lineage_compare(name, acc, *ragged, f"65553 ragged primaries from {start}",
                                      gpu)
        res[name] = {"err": max(err1, err2), "plain_ms": plain_ms,
                     "plain_rays": sets["65536 mixed"][0].shape[0]}

    # full width: the per-ray need of each set, then the lineage kernels
    need_fn = {"pack": ppacket_ref, "wide": wide_exact_ref}
    timed, outs = {}, {}
    _reset_counts()
    for label in ("chunk primaries", "chunk bounce"):
        o, d = sets[label]
        we_err, we_ms, _, _ = _exact_compare(tabs["wide"], o, d, f"leaf-8 WideBVH {label}", gpu,
                                             phase=13)
        res["wide_exact_err"] = max(res.get("wide_exact_err", 0.0), we_err)
        print(f"phase 13 lineup {label}: {o.shape[0]} rays; ppacket {walks['ppacket'][label][0]:.4f} "
              f"ms (phase 12), wide_exact on the leaf-8 WideBVH {we_ms:.4f} ms [{gpu}]")
        for name, kind, _ in LINEAGE:
            entry, counted, _ = _lineage_fns()[name]
            acc = tabs[kind]
            oo, dd, cut = o, d, ""
            one = _events_ms(lambda: entry(acc, oo, dd), 1)
            if label == "chunk bounce" and name in CUT_WALKS:
                oo, dd = o[:LINEAGE_CUT].contiguous(), d[:LINEAGE_CUT].contiguous()
                cut = f" (a prefix; one launch on all {o.shape[0]} rays took {one:.1f} ms)"
                one = _events_ms(lambda: entry(acc, oo, dd), 1)
            reps = max(1, min(20, int(1000.0 / max(one, 1e-3))))
            ms = one if reps == 1 else _events_ms(lambda: entry(acc, oo, dd), reps)
            work = {}
            outs[(name, label)] = (counted(acc, oo, dd, visits=work), work, oo, dd)
            need = {}
            if cut or kind == "wide":
                need_fn[kind](acc, oo, dd, visits=need)
            else:
                need = walks["ppacket"][label][1]
            tab = acc.cnodes.nbytes + acc.tris.nbytes
            io = oo.nbytes + dd.nbytes + 4 * 4 * oo.shape[0]
            bound = _bound(io + tab, _lineage_ops(kind, need))
            ratio = _lineage_ops(kind, work) / max(_lineage_ops(kind, need), 1.0)
            # the warp's own work: at the float32 peak (an FMA two operations),
            # and at the issue rate, since --fmad=false fuses no product
            warp_bound = _bound(io + tab, _warp_ops(name, work))
            issue = _bound(io + tab, instr=_warp_ops(name, work))
            own = (f"; bound from the warp's own work {warp_bound[0]:.4f} ms by "
                   f"{warp_bound[1]}, kernel at {ms / warp_bound[0]:.3f}x it; at the issue "
                   f"rate {issue[0]:.4f} ms, kernel at {ms / issue[0]:.3f}x it")
            timed[(name, label)] = (ms, bound, oo.shape[0], warp_bound)
            steps = f", {work['warp_nodes']} warp node steps" if "warp_nodes" in work else ""
            print(f"phase 13 {name} {label}: {oo.shape[0]} rays{cut}, kernel {ms:.4f} ms (mean of "
                  f"{reps}), bound {bound[0]:.4f} ms by {bound[1]} (per-ray need "
                  f"{need['nodes']} nodes, {need['records']} records); the warp's own work "
                  f"{work['nodes']} nodes, {work['records']} records{steps}, {ratio:.3f}x the "
                  f"need in operations{own} [{gpu}]")
    counts = _read_counts()
    for name, kind, _ in LINEAGE:
        launches, plain = counts[name]
        if launches <= 0 or plain:
            raise AssertionError(f"{name} at full width: {launches} launches, {plain} plain calls")
        ms, bound, rays, warp_bound = timed[(name, "chunk bounce")]
        res[name].update(launches=launches, ms=ms, bound=bound, rays=rays, warp_bound=warp_bound)
        print(f"phase 13 {name}: {launches} launches at full width, plain calls 0; ptxas: "
              f"{_ptxas(name)}; shared memory a block {_smem_line(name, tabs[kind])}")

    # the timed outputs against the per-ray kernels (which phases 7 and 12
    # hold to their plain versions at these shapes) under phase 7's rules
    per_ray = {"pack": ppacket_first_hit, "wide": wide_exact_first_hit}
    for label in ("chunk primaries", "chunk bounce"):
        for name, kind, _ in LINEAGE:
            got, work, oo, dd = outs[(name, label)]
            max_dt, uverr, ndiff, nhit = _hold(got, per_ray[kind](tabs[kind], oo, dd),
                                               f"{name} {label} vs the per-ray kernel")
            res[name]["err"] = max(res[name]["err"], max_dt, uverr)
            print(f"phase 13 {name} {label}: {oo.shape[0]} rays ({nhit} hits) == "
                  f"{'ppacket' if kind == 'pack' else 'wide_exact'} but for {ndiff} ids "
                  f"(coincident faces), max |dt| {max_dt:.3g}, max u/v err {uverr:.3g} [{gpu}]")
        got, work, oo, dd = outs[("persistent_wide", label)]
        same, same_work, so, _ = outs[("wide_frustum", label)]
        if so.shape != oo.shape:
            raise AssertionError(f"{label}: wide_frustum and persistent_wide timed other rays")
        _persistent_at_width(tabs["wide"], oo, dd, got, work, same, same_work, label, gpu)
    print(f"phase 13 lineage walks: {time.perf_counter() - t_phase:.1f} s")
    return res


# phase 14: counter name, CUDA source, the TPU kernel it replaces, and the
# label of the variant its ``kernels`` entry reports
PROBES = (
    ("probe_dot_t", "probe_dot.cu", "scripts/probe_r18.py:22", "M=14"),
    ("probe_dot_n", "probe_dot.cu", "scripts/probe_r18.py:31", "M=14"),
    ("probe_dot_bf16", "probe_dot.cu", "scripts/probe_r18.py:82", "M=14"),
    ("probe_dot_k", "probe_dot.cu", "scripts/probe_r19.py:25", "M=14 K=512"),
    ("probe_dot_indep", "probe_dot.cu", "scripts/probe_r19.py:34", "M=14 K=512"),
    ("probe_route_loop", "probe_route.cu", "scripts/probe_r20.py:34", "build+dot x1"),
    ("probe_route_dyn", "probe_route.cu", "scripts/probe_r20.py:118", "dyn"),
    ("probe_route_nested", "probe_route.cu", "scripts/probe_r20.py:163",
     "inner<=7 when_store=1 carry6=1"),
    ("probe_route_bigread", "probe_route.cu", "scripts/probe_r20.py:235", "store_dyn=1"),
    ("probe_take_rm", "probe_take_rm.cu", "scripts/probe_r21.py:26", "occ=0.15"),
    ("probe_stream_take", "probe_stream_take.cu", "scripts/probe_r22.py:26", "occ=0.15 full"),
)


def _probe_plain_and_library(dev):
    """name -> (plain ms, library ms or None) at each entry's variant. The
    library call computes the same function in one call: the reps-fold sum
    of products as one product over the reps-fold contraction (a tiled
    along K, b along K), and the takes as one ``index_select`` with a zero
    word appended, to which dead lanes point."""
    import numpy as np
    import torch

    from atray_tpu_torch.probes import (
        _timing, probe_r18, probe_r19, probe_r20, probe_r21, probe_r22)

    ms = lambda fn, reps=1: _timing.events_ms(fn, reps, warm=False)  # noqa: E731
    res = {}
    reps = probe_r18.REPS
    a, b = probe_r18.inputs(dev)
    wide_a, wide_bt, wide_b = a.repeat(1, reps), b.repeat(1, reps), b.repeat(reps, 1)
    res["probe_dot_t"] = (ms(lambda: probe_r18.dot_ref(a, b, reps, "probe_dot_t", True)),
                          ms(lambda: torch.matmul(wide_a, wide_bt.t()), 3))
    res["probe_dot_n"] = (ms(lambda: probe_r18.dot_ref(a, b, reps)),
                          ms(lambda: torch.matmul(wide_a, wide_b), 3))
    del wide_a, wide_bt, wide_b
    ha, hb = probe_r18.bf16_inputs(dev, 14, np.random.default_rng(1))
    wide_a, wide_b = ha.repeat(1, reps), hb.repeat(reps, 1)
    res["probe_dot_bf16"] = (ms(lambda: probe_r18.dot_ref(ha, hb, reps, "probe_dot_bf16")),
                             ms(lambda: torch.matmul(wide_a, wide_b), 3))
    del wide_a, wide_b
    a, b = probe_r19.inputs(dev, 14, probe_r19.INDEP_K, np.random.default_rng(0), 0.002)
    wide_a, wide_b = a.repeat(1, reps), b.repeat(reps, 1)
    lib = ms(lambda: torch.matmul(wide_a, wide_b), 3)
    del wide_a, wide_b
    res["probe_dot_k"] = (ms(lambda: probe_r19.dot_k_ref(a, b, reps)), lib)
    res["probe_dot_indep"] = (ms(lambda: probe_r19.dot_indep_ref(a, b, reps)), lib)
    win, rel = probe_r20.inputs(dev)
    n = probe_r20.trips(dev, probe_r20.STEPS)
    res["probe_route_loop"] = (ms(lambda: probe_r20.route_loop_ref(n, win, rel, "build+dot", 1)),
                               None)
    res["probe_route_dyn"] = (ms(lambda: probe_r20.route_dyn_ref(n, win, rel)), None)
    n = probe_r20.trips(dev, probe_r20.OUTER_ROWS)
    res["probe_route_nested"] = (ms(lambda: probe_r20.route_nested_ref(n, win, rel, 7, True, True)),
                                 None)
    idx = probe_r20.bigread_idx(dev)
    res["probe_route_bigread"] = (ms(lambda: probe_r20.route_bigread_ref(n, idx, win, True)), None)

    rng = np.random.default_rng(0)
    rows, c, lane = probe_r21.ROWS, probe_r21.C, probe_r21.LANE
    base = torch.from_numpy(rng.normal(size=(rows, c, lane)).astype(np.float32)).to(dev)
    idx = probe_r21.occupancy_map(dev, 0.15, rng)
    ok = idx >= 0
    s = torch.where(ok, idx, 0).long()
    src = ((s // lane) * c * lane + s % lane).view(rows, 1, lane) + \
        (torch.arange(c, device=dev) * lane).view(1, c, 1)
    flat = torch.cat([base.reshape(-1), base.new_zeros(1)])
    fidx = torch.where(ok.view(rows, 1, lane), src, flat.numel() - 1).reshape(-1)
    if not torch.equal(torch.index_select(flat, 0, fidx).view(rows, c, lane),
                       probe_r21.take_rm_ref(base, idx)):
        raise AssertionError("phase 14: index_select != the ray-major take")
    res["probe_take_rm"] = (ms(lambda: probe_r21.take_rm_ref(base, idx), 3),
                            ms(lambda: torch.index_select(flat, 0, fidx), 10))
    del flat, fidx, src
    planes = base.permute(1, 0, 2).contiguous()
    cols_z = torch.cat([planes.reshape(c, -1), planes.new_zeros(c, 1)], 1)
    idx_z = torch.where(ok, idx, rows * lane).long()
    res["probe_stream_take"] = (ms(lambda: probe_r22.stream_take_ref(planes, idx), 3),
                                ms(lambda: torch.index_select(cols_z, 1, idx_z), 10))
    return res


def phase_probes(dev, gpu):
    """Phase 14: the probe kernels against their plain versions, then each
    probe's table (the counted run), then plain and library times."""
    from atray_tpu_torch.probes import probe_r18, probe_r19, probe_r20, probe_r21, probe_r22

    t_phase = time.perf_counter()
    mods = (probe_r18, probe_r19, probe_r20, probe_r21, probe_r22)
    say = lambda line: print(f"phase 14 {line} [{gpu}]")  # noqa: E731
    errs = {}
    for mod in mods:
        errs.update(mod.check(dev, out=say))
    t_check = time.perf_counter() - t_phase
    _reset_counts()
    timed = [t for mod in mods for t in mod.table(dev, out=say)]
    counts = _read_counts()
    res = {}
    for name, _, _, label in PROBES:
        launches = counts[name][0]
        if launches <= 0:
            raise AssertionError(f"{name}: no launch in the probes' run")
        (t,) = [t for t in timed if t.kernel == name and t.label == label]
        res[name] = {"launches": launches, "err": errs[name], "t": t}
    t_table = time.perf_counter() - t_phase - t_check
    for name, (plain_ms, lib_ms) in _probe_plain_and_library(dev).items():
        res[name].update(plain_ms=plain_ms, library_ms=lib_ms)
        t = res[name]["t"]
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        say(f"{name} {t.label}: kernel {t.ms:.4f} ms, {t.bound_text()}, plain {plain_ms:.4f} ms, "
            f"library {lib}, {res[name]['launches']} launches in the probes' run")
    print(f"phase 14 probes: checks {t_check:.1f} s, tables {t_table:.1f} s, all "
          f"{time.perf_counter() - t_phase:.1f} s")
    return res


def _entry(name, source, replaces, launches, err, ms, plain_ms, bound, library_ms, **rays):
    """One entry of the ``kernels`` line; the lineage walks add ``rays``
    (the rays of ``ms`` and ``bound_ms``) and ``plain_rays`` (of
    ``plain_ms``), since their timed set is cut, and ``warp_bound_ms``
    (the bound from the warp's own work); the
    probes add the ``variant`` timed and, for one-block kernels,
    ``one_sm_bound_ms``."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms, **rays}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from atray_tpu_torch.accel.shaded import build_shaded_accel
    from atray_tpu_torch.config import KDTreeConfig
    from atray_tpu_torch.kernels import _build

    dev = torch.device("cuda:0")
    gpu = _gpu_line()
    print(f"phase 1 env: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    print(gpu)
    t0 = time.perf_counter()
    _build.load()
    print(f"phase 1 build: nvcc {' '.join(_build.NVCC_FLAGS)} (one process per source) -> "
          f"{os.path.relpath(_build.library_path())} in {time.perf_counter() - t0:.2f} s")
    for line in _build._loaded.log.splitlines():
        if "registers" in line or "stack frame" in line or "Compiling entry" in line:
            print(f"phase 1 {line.strip()}")
    print(f"phase 1 wide_exact ptxas: {_ptxas('wide_exact')}")

    lt = phase_lane_take(dev, gpu)

    t0 = time.perf_counter()
    scene_host = _slice_scene()
    t_scene = time.perf_counter() - t0
    t0 = time.perf_counter()
    accel_host = build_shaded_accel(scene_host, KDTreeConfig(leaf_size=16))
    t_accel = time.perf_counter() - t0
    tbytes = sum(getattr(accel_host, k).nbytes for k in ("cboxes", "clinks", "caxis", "tris"))
    print(f"phase 3 host build: scene {t_scene:.2f} s, shaded accel {t_accel:.2f} s "
          f"({scene_host.mesh.num_faces} tris, {accel_host.num_nodes} wide nodes, wide depth "
          f"{accel_host.max_depth}, tables {tbytes / 1e6:.1f} MB)")
    scene = scene_host.to(dev)
    accel = accel_host.to(dev)

    ws_err, ws_ms, ws_plain, ws_bound = phase_wide_shade(scene, accel, dev, gpu)
    counts, walk_film, walk_frames = phase_slice(scene, accel, dev, gpu)
    phase_small_vs_cpu(scene_host, accel_host, dev, gpu)
    phase_identity(scene, accel, gpu)
    ls = phase_lane_scatter(dev, gpu)
    t_scene_host = _trainer_scene()
    t_orig, t_dirn = _trainer_rays(dev)
    wide_host, we_err, we_ms, we_plain, we_bound = phase_wide_exact(
        scene_host, accel, (t_scene_host.to(dev), t_orig, t_dirn), dev, gpu)
    g_counts, _ = phase_gradient(scene, accel, scene_host, accel_host, dev, gpu)
    t_counts, t_err = phase_trainer(wide_host.to(dev), t_scene_host, t_orig, t_dirn, dev, gpu)
    pk = phase_pair_kernels(scene_host, scene, accel, dev, gpu)
    p_counts = phase_pair_slice(scene, accel, walk_film, walk_frames, dev, gpu)
    del walk_film
    h_counts, pp_err, pp_ms, pp_plain, pp_bound, walks = phase_ppacket(
        scene, scene_host, accel, dev, gpu)
    lineage = phase_lineage(walks, gpu)
    probes = phase_probes(dev, gpu)

    lt_ms, lt_plain, lt_lib = lt[(14, 4_147_200, "pack")]
    n_chunk = 4_147_200
    ls_ms, ls_plain, ls_lib, ls_bound, _ = ls[(12, 2_073_600, "pack")]
    ls_err = max(v[4] for v in ls.values())
    print(json.dumps({"kernels": [
        _entry("wide_shade", "atray_tpu_torch/csrc/wide_shade.cu",
               "atray_tpu/kernels/wide_shade.py:43", counts["wide_shade"][0], ws_err,
               ws_ms, ws_plain, ws_bound, None),
        _entry("lane_take", "atray_tpu_torch/csrc/lane_take.cu",
               "atray_tpu/kernels/lane_pack.py:202", counts["lane_take"][0], 0.0,
               lt_ms, lt_plain, _bound((2 * 14 + 1) * 4 * n_chunk), lt_lib),
        _entry("lane_scatter", "atray_tpu_torch/csrc/lane_scatter.cu",
               "atray_tpu/kernels/lane_pack.py:632", g_counts["lane_scatter"][0], ls_err,
               ls_ms, ls_plain, ls_bound, ls_lib),
        _entry("wide_exact", "atray_tpu_torch/csrc/wide_exact.cu",
               "atray_tpu/kernels/wide_exact.py:46", t_counts["wide_exact"][0],
               max(we_err, t_err, lineage["wide_exact_err"]),
               we_ms, we_plain, we_bound, None),
        _entry("treelet_phase_a", "atray_tpu_torch/csrc/treelet_phase_a.cu",
               "atray_tpu/kernels/treelet_pairs.py:69", p_counts["treelet_phase_a"][0], 0.0,
               *pk["a"], None),
        _entry("treelet_phase_b", "atray_tpu_torch/csrc/treelet_phase_b.cu",
               "atray_tpu/kernels/treelet_pairs.py:186", p_counts["treelet_phase_b"][0], 0.0,
               *pk["b"], None),
        _entry("ppacket", "atray_tpu_torch/csrc/ppacket.cu",
               "atray_tpu/kernels/persistent_packet.py:42", h_counts["ppacket"][0], pp_err,
               pp_ms, pp_plain, pp_bound, None),
    ] + [
        _entry(name, f"atray_tpu_torch/csrc/{name}.cu", replaces, lineage[name]["launches"],
               lineage[name]["err"], lineage[name]["ms"], lineage[name]["plain_ms"],
               lineage[name]["bound"], None, rays=lineage[name]["rays"],
               plain_rays=lineage[name]["plain_rays"],
               warp_bound_ms=lineage[name]["warp_bound"][0])
        for name, _, replaces in LINEAGE
    ] + [
        _entry(name, f"atray_tpu_torch/csrc/{source}", replaces, probes[name]["launches"],
               probes[name]["err"], probes[name]["t"].ms, probes[name]["plain_ms"],
               (probes[name]["t"].bound_ms, probes[name]["t"].bound_by),
               probes[name]["library_ms"], variant=probes[name]["t"].label,
               **({"one_sm_bound_ms": probes[name]["t"].bound_ms * 132}
                  if probes[name]["t"].one_block else {}))
        for name, source, replaces, _ in PROBES
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
