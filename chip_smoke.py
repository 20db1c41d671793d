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
    float32 products within rtol 1e-5, atol 1e-5 x reps at reps 0, 1 and
    64 (P1, P2 at M = 14 and 16) or 8 (P4, P5, also on a dense normal b
    within ``probe_r19.dense_tolerance``), everything else equal; every P6
    variant and P7 at n x unroll of 0, 1, 127, 128, 129 and 16,384 steps
    (rounded to a multiple of unroll) on five rel sets (the script's, rel %
    136, every lane at 127 or more, all lanes equal, every lane at or past
    the step count); P8 at 0, 1, 2, 7, 8 and the script's rows and inner
    1, 3 and 7, P9 at 0, 1 and around its index rows in flight and on a
    5-row index table, each flag; the takes at 2,073,600 lanes x 14 planes on
    the maps of every occupancy and a scattered one, P10 also on every lane
    dead, the identity, indices at N and above, only the last row live,
    int32 NaN bit patterns, C = 1, 3 and 17 and 37 rows, P11 on its
    ``check_maps``); then, counted, each probe's table at the script's
    shapes and reps, every line with its bound
    on the card and, for the one-block kernels, on one SM (P1-P5) or at one
    scheduler's issue rate (P6-P9: the busiest warp's instructions, 14 for
    each term of its busiest lane, ``probe_r20.issue_instr``), with the
    time over it (a time under it fails); P1-P9 with the block's threads
    and shared memory and ptxas's registers and spills, P11's
    with its resources and a second bound from the bytes its design moves
    (staged rows, index, output), P10's with its threads, grid, registers and
    spills, its device time (launches queued behind a spin) and a second
    bound from the 32-byte sectors its map touches (``probe_r21.sector_work``;
    printed, not enforced), the scattered map on a line of its own; then
    the plain version's and the library call's time (``torch.matmul`` for
    P1-P5, and for P6 build+dot and P7 a product with a 0/1 mask held to
    the plain version within its stated tolerance; ``index_select`` for P10-P11: its first call apart, then the
    mean of warm calls, with its kernels' names and grids from the
    profiler) at one variant of each.

15. the oracle slice (brute force, explicit uniforms, NEE, anti-aliasing)
    at four configurations the repository has, each at full size: (a)
    ``bench.py``'s ladder config 1 (``Cube.obj`` through the port's
    ``load_obj``, 256x256, 1 spp, 1 bounce, ``accel=None``): no kernel and
    no plain version runs, the film equals the CPU render within 1e-5; (b)
    ladder config 2 (``Monkey.obj``, a floor, a light sphere, 512x512, 4
    spp, 3 bounces, NEE, the shaded accel at leaf 16): a warm-up and two
    timed frames, ``wide_shade`` launched twice a bounce (hits and shadow
    rays), ``lane_take`` launched, no plain version, the film with sort and
    lane pack off bit-equal; (c) ``examples/arealight.toml`` built in code
    (``dragon_proxy(139_000)``, two emissive quads, 1280x720, 16 spp, 4
    bounces, NEE, chunks of 2*1280*720 rays): timed frames, ``wide_shade``
    twice a bounce in every chunk, once of them in the shadow-ray call
    (``wavefront.occlusion``, counted by a spy on it), a profiled frame,
    bounce 1's shadow-ray launch of one chunk against the plain version
    under phase 3's rules,
    the NEE gradient at phase 8's config (forward, forward+backward, ratio,
    peak memory; the backward launches no ``wide_shade``; ``lane_scatter``
    launched), and a 48x27 NEE gradient against the CPU plain versions;
    (d) ``examples/cornell.toml`` with anti-aliasing: the card's jitter
    bits equal the numpy threefry's, the film finite and unlike the film
    without AA; (e) on config 2's rays, ``trace_radiance`` with explicit
    uniforms drawn from a key bit-equal to the keyed trace.
16. textures, AOVs and the output modules on the textured slice: phase
    4's scene plus ``assets/Deer.obj`` (through the port's ``load_obj``,
    turned, scaled and placed so at least 10% of the camera rays hit its
    tex-coord faces) and the CLI's 1024 x 1024 checker, the shaded accel at
    leaf 16, phase 4's settings. (a) the frame through the gather path
    (``nearest_hit_ids`` -> ``wide_shade``, the texel gather): the textured
    share, the camera bounce's texel gather timed alone, a warm-up and two
    timed frames, ``wide_shade`` launched once a bounce in every chunk, all
    inside ``nearest_hit_ids``, ``lane_take`` launched, no plain version; a
    profiled frame, and the texel gather's device time from the profiler's
    ``aten::index_select`` calls on the texel rows; the frame's camera-bounce
    and sorted, packed bounce-2 launches of one chunk (captured) against
    the plain version under phase 3's rules and bit for bit in t, id and
    material; sort + pack == unsorted at 256x144 x 2 spp; a 48x27 render
    against the CPU under phase 4's rule; (b) the texel gradient at phase
    8's config (forward, forward+backward, ratio, peak memory; finite and
    non-zero; the backward launches no ``wide_shade``; ``lane_scatter``
    launched) and a 48x27 texel gradient on the card against the CPU plain
    versions under phase 8's rule; (c) ``render_aovs`` at 1920x1080 through the shaded accel,
    timed, its hit and material_id equal to the kernel's planes with the
    floor merged, depth within 1e-4 relative of its t; (d)
    ``render_progressive`` on 15d's cornell scene, 3 batches of 8 spp,
    stopped after batch 1 and resumed from a checkpoint in a temporary
    directory: film_sum equal to the run without a stop; (e)
    ``render_telemetry`` of the frame as 16 chunks (``render`` at that
    chunk size, timed from its callback), its film equal to ``render``'s,
    whose ``progress_cb`` ticks once a chunk
    with the chunk's live rays, summing to rays_cast; ``tail_report``; (f)
    ``save_bmp`` of (a)'s film, its header read back.

17. the host surfaces: (a) the native OBJ parser (``native.parse_obj_native``)
    on ``Cube.obj``, ``Deer.obj``, ``Monkey.obj`` and a
    ``dragon_proxy(139_000)`` OBJ written to a temporary directory, its
    arrays equal to the Python parser's, both parse times; (b) ``bench.py``'s
    ladder config 3 (``Deer.obj`` on the floor, 1280x720, 16 spp, 3
    bounces, sorted, leaf 16) written as a TOML and rendered by
    ``cli.main(["render", toml, "-o", png])`` on the card: the TOML's scene
    equal to ``_ladder_scene(3)``'s, ``wide_shade`` launched once a bounce,
    ``lane_take`` launched, no plain version, the PNG's bytes equal to
    ``save_png`` of a direct ``render()`` with ``prng_key(0)``; the
    camera bounce's ``wide_shade`` launch and the first ``lane_take``
    launch (the compaction's state pack) of that render, captured, against
    their plain versions (phase 3's rules; bit for bit); the command line's
    phase table and live rays/s; (c) ``examples/cornell.toml`` and
    ``examples/arealight.toml`` through ``cli.main`` at their own sizes:
    films finite, in [0, 1], not black; (d) ``--aov``, ``--telemetry 4``
    and ``--progressive`` on config 3, the run resumed from its checkpoint
    equal to the uninterrupted one; (e) ``validate_bvh``,
    ``compute_vertex_normals`` and ``save_cost_heatmap`` with their host
    seconds, and ``python3 -m atray_tpu_torch.examples.render_demo`` as a
    subprocess from the root: exit 0, five PNGs.
18. the sharded serving path: two ranks, each a process of its own
    (``chip_smoke.py --rank R ...``), joined by a gloo group over 127.0.0.1
    on the one card (NCCL refuses two ranks on one device); a rank that
    fails, or runs past ``RANK_TIMEOUT_S``, fails the phase, and both are
    killed. (a) the slice through ``render(mesh=)``: each rank traces
    8,294,400 rays in 2 chunks; the counts set to 0 before a timed frame,
    ``wide_shade`` once a bounce a chunk, ``lane_take`` launched, no plain
    version; every rank's film equal to the local film bit for bit (rank 0
    also renders the frame alone), the live rays per shard summing to its
    rays_cast; per-rank frame seconds and the gathers' seconds and bytes;
    each rank's camera-bounce ``wide_shade`` launch and first ``lane_take``
    launch (captured from a warm-up frame) held bit for bit against the
    plain versions, with their bounds, the ranks in turn (the kernels line
    takes rank 1's, the floor and dragon half); (b) the slice through
    ``render_treelet`` with ``TreeletAccels`` (2 parts, leaf 16): a timed
    frame with ``wide_shade`` launched once a hop (2 hops x 5 bounces), the
    film against the local film (pixels differing by more than 1e-5 at
    most ``TIE_PIXELS``: an equal-t tie), each hop's rays, bytes, local
    query seconds and transfer seconds, and each rank's first ring hop
    launch held bit for bit against the plain version (the ranks in turn);
    (c) ``examples/cornell.toml`` through ``cli.main`` on both ranks with
    ``--mesh 2 --nee`` (its PNG byte-equal to the one-rank command's),
    ``--telemetry 4`` (the per-shard row) and ``--treelet --nee`` (the
    shadow ring), then ``torchrun --standalone --nproc-per-node 2 -m
    atray_tpu_torch.cli`` with ``--mesh 2 --nee``, its PNG byte-equal too;
    (d) a one-rank NCCL group in this process: the slice through
    ``render(mesh=)`` equal to the local film, ``assemble_film`` and an
    ``all_reduce``.
19. the sharded training path: two ranks again (``chip_smoke.py --rank R
    ... --phase 19``), gloo on the one card. (a) the trainer of phase 9 at
    16 views x 128x128 (262,144 rays, 131,072 a rank) through
    ``make_train_step(mesh=)``: step 1's loss and gradients by
    ``make_loss_and_grad(mesh=)`` held to this process's one-rank ones
    (``_hold_grads``), then with the counts set to 0, 4 steps on the
    ``make_accel`` ``WideBVH`` and 2 on the ``ShadedWideBVH``, both
    refit: ``wide_exact`` and ``wide_shade`` launched, no plain version,
    the loss falling, the parameters bit-equal on both ranks after every
    step, each step's seconds and its ``all_reduce``'s seconds and bytes,
    each rank's first captured ``wide_exact`` and ``wide_shade`` launches
    bit for bit against the plain versions; (b) ``TreeletParts`` and (c)
    ``TreeletShards`` of the same dragon in 2 parts, 16 views x 64x64 x 3
    bounces (the third so that the compaction runs), forward and backward
    with the counts set to 0: ``lane_take`` and ``lane_scatter`` launched,
    no plain version, the backward's hops only the reverse pickup ring,
    every ring's hops, bytes and seconds; the films against the
    replicated brute-force films (``TIE_PIXELS``), the gradients (summed
    by ``reduce_grads``, or gathered and merged) against the replicated
    ones (``_hold_grads``), each rank's part's bytes on the card, and each
    rank's first ``lane_take`` and ``lane_scatter`` launches bit for bit
    against the plain versions; (d) ``torchrun --standalone
    --nproc-per-node 2 -m atray_tpu_torch.examples.inverse_render`` at 16
    views x 64x64 on the 139k dragon, its loss falling; (e) in this
    process, a one-rank NCCL group: one ``make_train_step(mesh=)`` step
    equal to the step without a mesh bit for bit.

Each path's launch counts are set to 0 just before it runs and read just
after. Every profile (phases 4, 8, 9, 11, 12) prints device time by kernel
and, where they ran, the lane kernels' device time and launches. Then a
JSON line of per-kernel results (times, launches, bound), and as the last
line ``{"ok": true, "device": {...}}``. The script needs a
CUDA device and the repository checkout; without either it exits non-zero
and prints no result.
"""

from __future__ import annotations

import contextlib
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


def _plain_hits(accel, planes, alive, piece=None, **kw):
    """``wide_shade_planes_ref`` on the rays, in pieces of ``piece`` rays
    where given (a ray's walk depends on no other ray; the plain version's
    per-ray stacks and leaf records for a whole 14,745,600-ray launch would
    take tens of GB). ``visits`` sums over the pieces."""
    import torch

    from atray_tpu_torch.kernels.wide_shade import wide_shade_planes_ref

    n = alive.shape[0]
    if piece is None or piece >= n:
        return wide_shade_planes_ref(accel, *planes, alive, **kw)
    parts = [wide_shade_planes_ref(accel, *(p[s:s + piece] for p in planes),
                                   alive[s:s + piece], **kw) for s in range(0, n, piece)]
    return {k: torch.cat([part[k] for part in parts]) for k in parts[0]}


def _compare_hits(accel, planes, alive, label, gpu, exact=False, piece=None):
    """Kernel vs plain version on one ray set, stats off and on; returns
    (max error, kernel ms, plain ms, kernel output, bound). With stats on
    the kernel's hit planes must equal its planes with stats off, and on
    every ray whose t, id and material equal the plain version's bit for
    bit (at least 99% of the live rays), so must its per-ray node and leaf
    visits: a ray's walk depends on no other ray. With ``exact`` every
    ray's t, id and material must equal the plain version's bit for bit.
    ``piece``: the plain version runs on that many rays a call."""
    import torch

    from atray_tpu_torch.kernels.wide_shade import OUTPUTS, STATS, wide_shade_planes

    got = wide_shade_planes(accel, *planes, alive)
    got_st = wide_shade_planes(accel, *planes, alive, stats=True)
    visits = {}
    want = _plain_hits(accel, planes, alive, piece, visits=visits, stats=True)
    n_diff, max_abs_t, nerr, hit = _planes_rules(got, want, alive, f"wide_shade {label}")
    if not all(torch.equal(got_st[k], got[k]) for k in OUTPUTS):
        raise AssertionError(f"wide_shade {label}: stats=True changes the hit planes")
    same = ((got["t"].view(torch.int32) == want["t"].view(torch.int32))
            & (got["id"] == want["id"]) & (got["mat"] == want["mat"]))
    n_same = int((same & alive).sum())
    if exact and not bool(same.all()):
        raise AssertionError(f"wide_shade {label}: t, id or material differ from the plain "
                             f"version bit for bit on {int((~same).sum())} rays")
    if n_same < 0.99 * int(alive.sum()):
        raise AssertionError(f"wide_shade {label}: only {n_same} live rays bit-equal, "
                             "too few to hold the visit counts to")
    for k in STATS:
        if not torch.equal(got_st[k][same], want[k][same]):
            raise AssertionError(f"wide_shade {label}: per-ray {k} differ on bit-equal rays")
    al = alive.cpu().numpy()
    ms = _cuda_ms(lambda: wide_shade_planes(accel, *planes, alive), 20)
    ms_st = _cuda_ms(lambda: wide_shade_planes(accel, *planes, alive, stats=True), 20)
    plain_ms = _host_ms(lambda: _plain_hits(accel, planes, alive, piece))
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


def _frame_launches(scene, accel, bounces=FRAME_BOUNCES):
    """The arguments ``render()`` hands ``wide_shade`` at ``bounces`` of
    chunk ``FRAME_CHUNK`` of one slice frame (phase 4's settings, key 0),
    cloned: {bounce: [ox, oy, oz, dx, dy, dz, alive]}. Bounce 0 is the
    camera bounce; bounce 1 traces its survivors at full width, in tile
    order; after it the state is sorted and its live rays packed to a
    prefix (``wavefront.trace_radiance``), so bounce 2 is the first sorted,
    packed launch."""
    import torch

    from atray_tpu_torch.render import wavefront
    from atray_tpu_torch.render.rng import prng_key

    settings, cam = _slice_settings()
    real = wavefront.wide_shade_planes
    calls, got = [], {}

    def spy(acc, *args, **kw):
        chunk, b = divmod(len(calls), settings.bounce_limit)
        calls.append(b)
        if chunk == FRAME_CHUNK and b in bounces:
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
    if len(calls) != chunks * settings.bounce_limit or sorted(got) != sorted(bounces):
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


_EDGE = "spin_kernel"   # torch.cuda._sleep's kernel, which pads a profiled window
_EDGE_LEAD = 256        # padding kernels before the profiled call
_EDGE_TAIL = 16         # and after it


def _profiled_kernels(fn):
    """(events, profile, whole) of one call of ``fn`` under torch.profiler:
    its device events (``key_averages``, kernels only), and whether the
    window is whole. The profiler loses the records of a window's first
    kernels, more the later in the process (without padding, phase 14's
    library lines read "the profiler recorded no kernel"), and at times of
    its last: so short kernels of our own open and close the window, and
    are left out. The window is whole where one of them is both its first
    and its last device record: then no record of ``fn``'s was lost."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(_EDGE_LEAD):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        for _ in range(_EDGE_TAIL):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    whole = bool(dev) and _EDGE in dev[0].name and _EDGE in dev[-1].name
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and _EDGE not in e.key], prof, whole


def _profile_frame(run, frame_s, gpu, label="phase 4", what="one slice frame"):
    """Device time of one run by kernel, from torch.profiler; the busy
    share is kernel time over the un-profiled wall time ``frame_s``."""
    groups = {k: [0.0, 0] for k in _KERNEL_NAMES + ("torch ops",)}
    top = []
    evs, _, whole = _profiled_kernels(run)
    for e in evs:
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
          f"{parts}; busy share {total / 1e6 / frame_s:.3f} of the {frame_s:.4f} s run"
          f"{'' if whole else ' (the profiler lost records at the edge of the window)'} [{gpu}]")
    lanes = [f"{k} {groups[k][0] / 1e3:.4f} ms over {groups[k][1]} launches"
             for k in ("lane_take", "lane_scatter") if groups[k][1]]
    if lanes:
        print(f"{label} profile lane kernels: {', '.join(lanes)} [{gpu}]")
    for us, count, key in sorted(top, reverse=True)[:6]:
        print(f"{label} profile top torch kernel: {us / 1e3:.3f} ms, {count} launches, {key[:90]}")


def _hold_grads(label, names, card, cpu):
    """Holds each card gradient to the CPU plain versions' within 1e-4 of
    the latter's max |g|, apart from at most 0.2% of values (grazing hits
    decided by one rounding); returns the summary printed beside it."""
    import numpy as np

    worst = []
    for k, a, b in zip(names, card, cpu):
        scale = max(float(np.abs(b).max()), 1e-30)
        bad = np.abs(a - b) > 1e-4 * scale
        if bad.mean() > 0.002:
            raise AssertionError(f"{label}: {k} differs beyond 1e-4 of max |g| on "
                                 f"{int(bad.sum())} of {bad.size} values")
        worst.append(f"{k} {float(np.abs(a - b).max()) / scale:.3g} ({int(bad.sum())} beyond)")
    return ", ".join(worst)


def phase_small_vs_cpu(scene, accel_host, dev, gpu, label="phase 4 small render"):
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
    print(f"{label} 48x27 x 1 spp x 5 bounces: card vs CPU plain versions "
          f"{int(bad.sum())} of {bad.size} values beyond 1e-4, max |diff| "
          f"{float(np.abs(gpu_film - cpu_film).max()):.3g} [{gpu}]")


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


def _trainer_rays(dev, res=TRAIN_RES):
    """The trainer's primaries: 16 orbit views x res x res px (64: phase
    9's) x 1 spp, view by view."""
    import numpy as np
    import torch

    from atray_tpu_torch.core.camera import camera_rays, look_at_camera

    origs, dirns = [], []
    for v in range(TRAIN_VIEWS):
        ang = 2 * np.pi * v / TRAIN_VIEWS
        cam = look_at_camera((2.5 * np.sin(ang), 0.8, -4 + 2.5 * np.cos(ang)), (0, 0, -4),
                             h_fov=0.8, aspect=1.0)
        o, d = camera_rays(cam, res, res, 1, device=dev)
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


def _trainer(scene_host, accels, orig, dirn, dev, mesh=None):
    """Phase 9's trainer over the primaries (``orig``, ``dirn``): the target
    traced at the true parameters on the first of ``accels`` (name ->
    accel), albedo (x 0.4 + 0.2) and vertices (``_trainer_start``)
    corrupted, one Adam, and a ``make_train_step`` (2 bounces,
    ``refit=True``, over ``mesh`` where given) for each accel. Returns
    (scene, true params, params, target, steps by name)."""
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
    steps = {name: make_train_step(scene_host, 2, opt, accel=acc, refit=True, device=dev,
                                   mesh=mesh)
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
    worst = _hold_grads("48x27 gradient", names, out["cuda"], out["cpu"])
    print("phase 8 gradient 48x27 x 1 spp x 3 bounces, card vs CPU plain versions, max |diff| "
          "/ max |g|: " + worst)
    return counts, (t_f, t_b, peak)


def _device_ms(fn):
    """(ms, kernels) of device kernel time of one call of ``fn``, from
    torch.profiler."""
    evs = _profiled_kernels(fn)[0]
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
    from atray_tpu_torch.probes import _timing

    return _timing.ptxas(f"{name}_kernel{template}")


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


# the float32 one-block products: counter name -> (variant, K) of atray_probe_dot
_F32_PRODUCTS = {"probe_dot_n": (0, 128), "probe_dot_t": (1, 128), "probe_dot_k": (2, 512),
                 "probe_dot_indep": (3, 512)}


def _library_kernels(fn):
    """The device kernels of one call of ``fn`` from torch.profiler: name,
    device microseconds and, where the exported trace records them, grid and
    block; up to three windows, until one is whole."""
    import json
    import os
    import tempfile

    for _ in range(3):
        evs, prof, whole = _profiled_kernels(fn)
        if whole:
            break
    kern = [(e.key, float(getattr(e, "self_device_time_total", 0.0)))
            for e in evs if not e.key.startswith(("Memset", "Memcpy"))]
    if not kern:
        return "the profiler recorded no kernel (not measured)"
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    shape = {e["name"]: f"grid {e['args'].get('grid')} block {e['args'].get('block')}"
             for e in events if e.get("cat") == "kernel"}
    return "; ".join(f"{name[:120]} {us:.1f} us {shape.get(name, 'grid not in the trace')}"
                     for name, us in kern) + ("" if whole else " (a window's edge was lost)")


def _probe_plain_and_library(dev):
    """name -> (plain ms, library ms or None) at each entry's variant. The
    library call computes the same function in one call: the reps-fold sum
    of products as one product over the reps-fold contraction (a tiled
    along K, b along K), P6 build+dot and P7 as one product of the window
    with a 0/1 mask (``probe_r20.library_calls``, held to the plain version
    first), and the takes as one ``index_select`` with a zero word appended,
    to which dead lanes point. A library time is the mean of three calls
    (ten for P6, P7, P10 and P11) after a first one, timed apart."""
    import numpy as np
    import torch

    from atray_tpu_torch.probes import (
        _timing, probe_r18, probe_r19, probe_r20, probe_r21, probe_r22)

    ms = lambda fn, reps=1: _timing.events_ms(fn, reps, warm=False)  # noqa: E731

    def lib_ms(name, fn, reps=3):
        # the first call of a library kernel in a process can also pay for
        # setting it up: it is timed and printed apart, and library_ms is
        # the mean of the calls after it
        first = ms(fn)
        warm = ms(fn, reps)
        torch.cuda.synchronize()
        print(f"phase 14 {name} library call: first {first:.4f} ms, then {warm:.4f} ms a call; "
              f"kernels {_library_kernels(fn)}")
        return warm

    res = {}
    reps = probe_r18.REPS
    a, b = probe_r18.inputs(dev)
    wide_a, wide_bt, wide_b = a.repeat(1, reps), b.repeat(1, reps), b.repeat(reps, 1)
    res["probe_dot_t"] = (ms(lambda: probe_r18.dot_ref(a, b, reps, "probe_dot_t", True)),
                          lib_ms("probe_dot_t", lambda: torch.matmul(wide_a, wide_bt.t())))
    res["probe_dot_n"] = (ms(lambda: probe_r18.dot_ref(a, b, reps)),
                          lib_ms("probe_dot_n", lambda: torch.matmul(wide_a, wide_b)))
    del wide_a, wide_bt, wide_b
    ha, hb = probe_r18.bf16_inputs(dev, 14, np.random.default_rng(1))
    wide_a, wide_b = ha.repeat(1, reps), hb.repeat(reps, 1)
    res["probe_dot_bf16"] = (ms(lambda: probe_r18.dot_ref(ha, hb, reps, "probe_dot_bf16")),
                             lib_ms("probe_dot_bf16", lambda: torch.matmul(wide_a, wide_b)))
    del wide_a, wide_b
    a, b = probe_r19.inputs(dev, 14, probe_r19.INDEP_K, np.random.default_rng(0), 0.002)
    wide_a, wide_b = a.repeat(1, reps), b.repeat(reps, 1)
    lib = lib_ms("probe_dot_k, probe_dot_indep", lambda: torch.matmul(wide_a, wide_b))
    del wide_a, wide_b
    res["probe_dot_k"] = (ms(lambda: probe_r19.dot_k_ref(a, b, reps)), lib)
    res["probe_dot_indep"] = (ms(lambda: probe_r19.dot_indep_ref(a, b, reps)), lib)
    win, rel = probe_r20.inputs(dev)
    n = probe_r20.trips(dev, probe_r20.STEPS)
    route_lib = probe_r20.library_calls(win, rel, probe_r20.STEPS)
    res["probe_route_loop"] = (ms(lambda: probe_r20.route_loop_ref(n, win, rel, "build+dot", 1)),
                               lib_ms("probe_route_loop", route_lib["probe_route_loop"], 10))
    res["probe_route_dyn"] = (ms(lambda: probe_r20.route_dyn_ref(n, win, rel)),
                              lib_ms("probe_route_dyn", route_lib["probe_route_dyn"], 10))
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
                            lib_ms("probe_take_rm", lambda: torch.index_select(flat, 0, fidx), 10))
    del flat, fidx, src
    planes = base.permute(1, 0, 2).contiguous()
    cols_z = torch.cat([planes.reshape(c, -1), planes.new_zeros(c, 1)], 1)
    idx_z = torch.where(ok, idx, rows * lane).long()
    res["probe_stream_take"] = (
        ms(lambda: probe_r22.stream_take_ref(planes, idx), 3),
        lib_ms("probe_stream_take", lambda: torch.index_select(cols_z, 1, idx_z), 10))
    # P11's second bound: the bytes its design moves on this map
    res["design_bound"] = _timing.bound(probe_r22.design_work(idx, c), 0.0)
    return res


def phase_probes(dev, gpu):
    """Phase 14: the probe kernels against their plain versions, then each
    probe's table (the counted run), then plain and library times."""
    from atray_tpu_torch.probes import (
        _timing, probe_r18, probe_r19, probe_r20, probe_r21, probe_r22)

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
    for (name, label), ms in probe_r20.device_table(dev, out=say).items():
        if res[name]["t"].label == label:
            res[name]["device_ms"] = ms
    for name in res:
        if res[name]["t"].device_ms is not None:
            res[name]["device_ms"] = res[name]["t"].device_ms
    lib_res = _probe_plain_and_library(dev)
    design = lib_res.pop("design_bound")
    res["probe_stream_take"]["design_bound"] = design
    for name, (plain_ms, lib_ms) in lib_res.items():
        res[name].update(plain_ms=plain_ms, library_ms=lib_ms)
        t = res[name]["t"]
        lib = "none" if lib_ms is None else f"{lib_ms:.4f} ms"
        shape = ""
        if name in _F32_PRODUCTS:
            shape = (f", {_timing.over_one_sm(t):.3f}x the one-SM bound, "
                     f"{probe_r18.resources(14, *_F32_PRODUCTS[name])}")
        elif name == "probe_dot_bf16":
            shape = (f", {_timing.over_one_sm(t):.3f}x the one-SM bound, "
                     f"{probe_r18.bf16_resources(14)}")
        elif name == "probe_stream_take":
            shape = (f", {t.ms / design[0]:.3f}x the design's bound {design[0]:.6g} ms "
                     f"(staged rows, index, output), {probe_r22.resources()}")
        elif name.startswith("probe_route_"):
            shape = f", {probe_r20.resources(name)}"
        elif name == "probe_take_rm":
            shape = (f", {t.ms / t.sector_bound_ms:.3f}x the sector bound "
                     f"{t.sector_bound_ms:.6g} ms (``probe_r21.sector_work``), "
                     f"{probe_r21.resources()}")
        if "device_ms" in res[name]:
            shape += f", device {res[name]['device_ms']:.5f} ms a launch (queued launches)"
        say(f"{name} {t.label}: kernel {t.ms:.4f} ms, {t.bound_text()}, plain {plain_ms:.4f} ms, "
            f"library {lib}, {res[name]['launches']} launches in the probes' run{shape}")
    print(f"phase 14 probes: checks {t_check:.1f} s, tables {t_table:.1f} s, all "
          f"{time.perf_counter() - t_phase:.1f} s")
    return res


# phase 15: the oracle slice on the card (brute force, explicit uniforms,
# NEE with sphere and area lights, anti-aliasing), at bench.py's ladder
# configs 1 and 2 and the scenes of examples/arealight.toml and
# examples/cornell.toml, each at its full size

LADDER_CAMERA = ((0.0, 1.0, 0.8), (0.0, -0.2, -4.0))   # bench.py's look_at_camera


LADDER_ASSETS = {1: "Cube.obj", 2: "Monkey.obj", 3: "Deer.obj"}


def _ladder_scene(n):
    """``bench.py``'s ladder config ``n`` (1, 2 or 3): (scene, settings,
    camera, accel or None). Config 1: ``Cube.obj`` alone, 256x256, 1 spp, 1
    bounce, unsorted, by brute force; config 2: ``Monkey.obj`` on a floor
    under a light sphere, 512x512, 4 spp, 3 bounces, NEE, the shaded accel
    at leaf 16; config 3: ``Deer.obj`` on the floor, 1280x720, 16 spp, 3
    bounces, sorted, the shaded accel at leaf 16. Each mesh scaled to 2.4
    and centred at (0, -0.3, -4)."""
    import numpy as np

    from atray_tpu_torch.accel.shaded import build_shaded_accel
    from atray_tpu_torch.config import KDTreeConfig, RenderSettings
    from atray_tpu_torch.core.camera import look_at_camera
    from atray_tpu_torch.scene import build_scene, load_obj
    from atray_tpu_torch.scene.data import Planes, Spheres, make_materials
    from atray_tpu_torch.scene.transforms import scale_to, translate_to

    mats = make_materials([
        ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),   # sky
        ((0.0, 0.0, 0.0), (0.75, 0.55, 0.35), 0.15),  # body
        ((0.0, 0.0, 0.0), (0.6, 0.6, 0.65), 0.0),     # floor
        ((9.0, 8.5, 7.0), (0.0, 0.0, 0.0), 0.0),      # light
    ])
    asset = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                         LADDER_ASSETS[n])
    mesh = translate_to(scale_to(load_obj(asset), 2.4), (0.0, -0.3, -4.0))
    floor = Planes(normals=np.asarray([[0.0, 1.0, 0.0]], np.float32),
                   offsets=np.asarray([-1.8], np.float32),
                   material_id=np.asarray([2], np.int32))
    if n == 1:
        scene = build_scene([mesh], materials=mats)
        settings = RenderSettings(resolution=(256, 256), samples_per_pixel=1, bounce_limit=1,
                                  sort_bounces=False)
        accel = None
    elif n == 2:
        light = Spheres(centers=np.asarray([[2.5, 3.0, -2.5]], np.float32),
                        radii=np.asarray([0.6], np.float32),
                        material_id=np.asarray([3], np.int32))
        scene = build_scene([mesh], planes=floor, spheres=light, materials=mats)
        settings = RenderSettings(resolution=(512, 512), samples_per_pixel=4, bounce_limit=3,
                                  nee=True)
        accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=16))
    else:
        scene = build_scene([mesh], planes=floor, materials=mats)
        settings = RenderSettings(resolution=(1280, 720), samples_per_pixel=16, bounce_limit=3,
                                  sort_bounces=True)
        accel = build_shaded_accel(scene, KDTreeConfig(leaf_size=16))
    w, h = settings.resolution
    cam = look_at_camera(*LADDER_CAMERA, h_fov=0.9, aspect=w / h)
    return scene, settings, cam, accel


def _toml_scene(name):
    """The scene of ``examples/<name>.toml``, built in code value for value
    (materials, meshes, spheres, planes, camera, [render], [accel] leaf
    size 16): (host scene, settings, camera, host shaded accel)."""
    import numpy as np

    from atray_tpu_torch.accel.shaded import build_shaded_accel
    from atray_tpu_torch.config import KDTreeConfig, RenderSettings
    from atray_tpu_torch.core.camera import look_at_camera
    from atray_tpu_torch.scene import build_scene, procedural
    from atray_tpu_torch.scene.data import Planes, Spheres, make_materials
    from atray_tpu_torch.scene.transforms import translate_to

    def floor(offset, material):
        return Planes(normals=np.asarray([[0.0, 1.0, 0.0]], np.float32),
                      offsets=np.asarray([offset], np.float32),
                      material_id=np.asarray([material], np.int32))

    if name == "arealight":
        mats = make_materials([
            ((0.02, 0.02, 0.04), (0.0, 0.0, 0.0), 0.0),     # sky
            ((0.0, 0.0, 0.0), (0.78, 0.62, 0.45), 0.2),     # body
            ((0.0, 0.0, 0.0), (0.50, 0.52, 0.58), 0.05),    # floor
            ((16.0, 14.5, 12.0), (0.0, 0.0, 0.0), 0.0),     # warm_panel
            ((4.0, 5.5, 9.0), (0.0, 0.0, 0.0), 0.0),        # cool_panel
        ])
        meshes = [
            translate_to(procedural.dragon_proxy(target_tris=139_000, material=1),
                         (0.0, 0.0, -4.0)),
            procedural.quad((-1.2, 2.3, -5.0), (1.2, 2.3, -5.0), (1.2, 2.3, -3.0),
                            (-1.2, 2.3, -3.0), material=3),
            procedural.quad((-3.2, 0.4, -6.4), (-3.2, 2.2, -6.4), (-3.2, 2.2, -2.2),
                            (-3.2, 0.4, -2.2), material=4),
        ]
        scene = build_scene(meshes, planes=floor(-1.8, 2), materials=mats)
        settings = RenderSettings(resolution=(1280, 720), samples_per_pixel=16, bounce_limit=4,
                                  nee=True, ray_chunk=2 * 1280 * 720)
        eye, target, h_fov = (0.4, 1.1, 1.1), (0.0, -0.1, -4.0), 0.85
    else:
        mats = make_materials([
            ((0.30, 0.42, 0.62), (0.0, 0.0, 0.0), 0.0),     # sky
            ((0.0, 0.0, 0.0), (0.75, 0.72, 0.68), 0.0),     # floor
            ((0.0, 0.0, 0.0), (0.85, 0.35, 0.25), 0.35),    # body
            ((6.0, 5.5, 4.5), (0.0, 0.0, 0.0), 0.0),        # light
            ((0.0, 0.0, 0.0), (0.95, 0.95, 0.95), 1.0),     # mirror
        ])
        body = translate_to(procedural.dragon_proxy(target_tris=20_000, material=2),
                            (0.0, 0.2, -4.0))
        spheres = Spheres(centers=np.asarray([[2.0, 0.4, -5.2], [-2.2, 2.6, -3.2]], np.float32),
                          radii=np.asarray([1.0, 0.8], np.float32),
                          material_id=np.asarray([4, 3], np.int32))
        scene = build_scene([body], spheres=spheres, planes=floor(-1.2, 1), materials=mats)
        settings = RenderSettings(resolution=(640, 360), samples_per_pixel=8, bounce_limit=4,
                                  anti_aliasing=True)
        eye, target, h_fov = (0.0, 1.2, 1.2), (0.0, 0.1, -4.0), 0.9
    w, h = settings.resolution
    cam = look_at_camera(eye, target, h_fov=h_fov, aspect=w / h)
    return scene, settings, cam, build_shaded_accel(scene, KDTreeConfig(leaf_size=16))


def _no_plain(counts, what):
    if any(c[1] for c in counts.values()):
        raise AssertionError(f"{what}: a plain version ran on the card: "
                             f"{ {k: c for k, c in counts.items() if c[1]} }")


def _timed_frames(run, keys):
    """One warm-up frame (key 0), then the counts set to 0 and one timed
    frame for each key: (warm-up s, [(s, live rays)], counts, last film)."""
    import torch

    t0 = time.perf_counter()
    run(0)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    _reset_counts()
    frames = []
    for k in keys:
        t0 = time.perf_counter()
        film, stats = run(k)
        live = int(stats["rays_cast"])          # synchronizes
        frames.append((time.perf_counter() - t0, live))
    return warm, frames, _read_counts(), film


def _frames_line(label, what, warm, frames, gpu):
    for i, (sec, live) in enumerate(frames):
        print(f"phase {label} frame {i + 1}: {what}: {sec:.4f} s, live rays {live}, "
              f"{live / sec:.6g} live rays/s [{gpu}]")
    print(f"phase {label}: warm-up frame {warm:.4f} s")


def phase_ladder_1(dev, gpu):
    """15a: config 1 by brute force; no kernel runs on this path."""
    import numpy as np
    import torch

    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.render.wavefront import render

    scene_host, s, cam, _ = _ladder_scene(1)
    scene = scene_host.to(dev)
    render(scene, cam, s, prng_key(0), accel=None)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    film = render(scene, cam, s, prng_key(1), accel=None)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = _read_counts()
    if any(c[0] or c[1] for c in counts.values()):
        raise AssertionError(f"15a: the brute-force path ran a kernel or a plain version: "
                             f"{ {k: c for k, c in counts.items() if c[0] or c[1]} }")
    f = film.cpu().numpy()
    ref = render(scene_host, cam, s, prng_key(1), accel=None, device="cpu").numpy()
    err = float(np.abs(f - ref).max())
    if not np.isfinite(f).all() or err > 1e-5:
        raise AssertionError(f"15a: film not finite or off the CPU render by {err}")
    print(f"phase 15a ladder config 1: Cube.obj ({scene.mesh.num_faces} tris), 256x256 x 1 spp x "
          f"1 bounce, brute force: {sec:.4f} s, no kernel and no plain version ran, film == the "
          f"CPU render within {err:.3g} (1e-5), std {f.std():.4f} [{gpu}]")


def phase_ladder_2(dev, gpu):
    """15b: config 2 (NEE with a sphere light), timed; 15e: explicit
    uniforms on its chunk. Returns (accel, scene, counts)."""
    import numpy as np
    import torch

    from atray_tpu_torch.core.camera import camera_rays
    from atray_tpu_torch.render import wavefront
    from atray_tpu_torch.render.rng import draw_bounce_uniforms, prng_key, split

    t0 = time.perf_counter()
    scene_host, s, cam, accel_host = _ladder_scene(2)
    t_build = time.perf_counter() - t0
    scene, accel = scene_host.to(dev), accel_host.to(dev)
    (w, h), spp, bounces = s.resolution, s.samples_per_pixel, s.bounce_limit

    def run(k):
        return wavefront.render(scene, cam, s, prng_key(k), accel=accel, return_stats=True)

    warm, frames, counts, film = _timed_frames(run, (1, 2))
    if counts["wide_shade"][0] != 2 * bounces * len(frames):
        raise AssertionError(f"15b: wide_shade launched {counts['wide_shade'][0]} times, not "
                             f"{2 * bounces} a frame (hits and shadow rays at each bounce)")
    if counts["lane_take"][0] <= 0:
        raise AssertionError("15b: lane_take never launched")
    _no_plain(counts, "15b")
    f = film.cpu().numpy()
    if not (np.isfinite(f).all() and f.std() > 0.01):
        raise AssertionError(f"15b: film not finite or flat (std {f.std()})")
    off = dataclasses.replace(s, sort_bounces=False, lane_pack=False)
    plain = wavefront.render(scene, cam, off, prng_key(2), accel=accel)
    if not torch.equal(film, plain):
        raise AssertionError("15b: the film with sort and lane pack off differs")
    _frames_line("15b", f"ladder config 2, Monkey.obj ({scene.mesh.num_faces} tris), floor, "
                 f"light sphere, {w}x{h} x {spp} spp x {bounces} bounces, NEE", warm, frames, gpu)
    print(f"phase 15b: host build {t_build:.2f} s; launches over the 2 timed frames wide_shade "
          f"{counts['wide_shade'][0]} ({2 * bounces} a frame: hits and shadow rays), lane_take "
          f"{counts['lane_take'][0]}, plain calls 0; film std {f.std():.4f}; film with sort and "
          f"lane pack off == the default film (torch.equal)")

    # 15e: explicit uniforms drawn from the bounce key give the keyed trace
    o, d = camera_rays(cam, w, h, spp, device=dev)
    o, d = wavefront.to_tile_order(o, w, h, spp), wavefront.to_tile_order(d, w, h, spp)
    key = split(prng_key(5))[1]
    uni = draw_bounce_uniforms(key, bounces, o.shape[0], 6, device=dev)
    args = dict(accel=accel, sort_rays=True, lane_pack=True, nee=True)
    a = wavefront.trace_radiance(scene, o, d, bounces, key, **args)
    b = wavefront.trace_radiance(scene, o, d, bounces, uniforms=uni, **args)
    if not torch.equal(a, b):
        raise AssertionError("15e: trace_radiance(uniforms=...) != trace_radiance(key=...)")
    print(f"phase 15e explicit uniforms: trace_radiance of config 2's {o.shape[0]} rays (sort + "
          f"lane pack, NEE) with uniforms=draw_bounce_uniforms(k, {bounces}, R, 6) == with key=k "
          f"(torch.equal) [{gpu}]")
    return counts


def _shadow_launch(scene, accel, settings, cam, chunk, bounce):
    """The arguments ``render()`` hands ``wide_shade`` for the shadow rays
    of ``bounce`` in ``chunk`` (key 0), cloned, and the number of calls
    each chunk made. The bounce's hit call comes first, then its shadow
    rays' call (``wavefront.occlusion``)."""
    import torch

    from atray_tpu_torch.render import wavefront
    from atray_tpu_torch.render.rng import prng_key

    real = wavefront.wide_shade_planes
    calls, got = [], []
    per_chunk = 2 * settings.bounce_limit

    def spy(acc, *args, **kw):
        if len(calls) == chunk * per_chunk + 2 * bounce + 1:
            got.extend(a.clone() for a in args)
        calls.append(1)
        return real(acc, *args, **kw)

    wavefront.wide_shade_planes = spy
    try:
        wavefront.render(scene, cam, settings, prng_key(0), accel=accel)
        torch.cuda.synchronize()
    finally:
        wavefront.wide_shade_planes = real
    (w, h), spp = settings.resolution, settings.samples_per_pixel
    chunks = -(-(w * h * spp) // settings.ray_chunk)
    if len(calls) != chunks * per_chunk or not got:
        raise AssertionError(f"the NEE frame launched wide_shade {len(calls)} times")
    return got


@contextlib.contextmanager
def _launch_spy(name, into):
    """While the block runs, append to ``into`` the ``wide_shade`` launches
    each call of ``wavefront.<name>`` made, read from the wrapper's own
    count: ``occlusion`` for the NEE shadow rays, ``nearest_hit_ids`` for
    the gather path's hits."""
    from atray_tpu_torch.kernels import _build
    from atray_tpu_torch.render import wavefront

    real = getattr(wavefront, name)
    counter = _build.COUNTERS["wide_shade"]

    def spy(*args, **kw):
        before = counter.launches
        out = real(*args, **kw)
        into.append(counter.launches - before)
        return out

    setattr(wavefront, name, spy)
    try:
        yield
    finally:
        setattr(wavefront, name, real)


def phase_arealight(dev, gpu):
    """15c: the area-light scene: timed frames, a profile, the shadow-ray
    launch against the plain version, the gradient. Returns the shadow
    launch's kernels-line numbers."""
    import numpy as np
    import torch

    from atray_tpu_torch.config import RenderSettings
    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.render.wavefront import _static_tri_lights, render

    t0 = time.perf_counter()
    scene_host, s, cam, accel_host = _toml_scene("arealight")
    t_build = time.perf_counter() - t0
    scene, accel = scene_host.to(dev), accel_host.to(dev)
    (w, h), spp, bounces = s.resolution, s.samples_per_pixel, s.bounce_limit
    chunks = -(-(w * h * spp) // s.ray_chunk)
    lights = _static_tri_lights(scene_host)

    shadow = []          # launches of each shadow-ray call in the timed frames

    def run(k):
        with _launch_spy("occlusion", shadow if k else []):
            return render(scene, cam, s, prng_key(k), accel=accel, return_stats=True)

    warm, frames, counts, film = _timed_frames(run, (1, 2))
    per_frame = 2 * bounces * chunks
    if counts["wide_shade"][0] != per_frame * len(frames):
        raise AssertionError(f"15c: wide_shade launched {counts['wide_shade'][0]} times, not "
                             f"{per_frame} a frame")
    shadow_launches = sum(shadow)
    if shadow != [1] * (bounces * chunks * len(frames)):
        raise AssertionError(f"15c: the shadow-ray calls launched wide_shade {shadow}, not once "
                             f"a bounce in every chunk")
    if counts["lane_take"][0] <= 0:
        raise AssertionError("15c: lane_take never launched")
    _no_plain(counts, "15c")
    f = film.cpu().numpy()
    if not (np.isfinite(f).all() and f.std() > 0.01):
        raise AssertionError(f"15c: film not finite or flat (std {f.std()})")
    _frames_line("15c", f"examples/arealight.toml, dragon_proxy(139_000) + {len(lights)} "
                 f"triangle lights, floor, {w}x{h} x {spp} spp x {bounces} bounces, NEE, "
                 f"{chunks} chunks", warm, frames, gpu)
    print(f"phase 15c: host build {t_build:.2f} s ({scene.mesh.num_faces} tris, "
          f"{accel_host.num_nodes} wide nodes); launches over the 2 timed frames wide_shade "
          f"{counts['wide_shade'][0]} ({shadow_launches} of them in the shadow-ray calls: "
          f"hits and shadow rays at each bounce of every chunk), lane_take {counts['lane_take'][0]}, plain calls 0; film std "
          f"{f.std():.4f}")
    frame_s = sum(sec for sec, _ in frames) / len(frames)
    _profile_frame(lambda: render(scene, cam, s, prng_key(3), accel=accel), frame_s, gpu,
                   "phase 15c", "one arealight frame")

    # bounce 1's shadow-ray launch of one chunk against the plain version
    args = _shadow_launch(scene, accel, s, cam, FRAME_CHUNK, 1)
    err, ms, plain_ms, _, bound = _compare_hits(accel, args[:6], args[6],
                                                "(phase 15c) shadow rays, bounce 1", gpu)
    live, rays = int(args[6].sum()), args[6].shape[0]
    print(f"phase 15c shadow-ray wide_shade (bounce 1, chunk {FRAME_CHUNK}): {live} live of "
          f"{rays} rays, kernel {ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]} "
          f"({ms / bound[0]:.2f}x), plain {plain_ms:.1f} ms [{gpu}]")
    del args, film

    # the gradient at phase 8's config on this scene (960x540 and 48x27
    # have the scene's 16:9 aspect, so its camera serves)
    gs = RenderSettings(resolution=(960, 540), samples_per_pixel=4, bounce_limit=3, nee=True,
                        ray_chunk=0)
    p = _grad_leaves(scene)

    def loss_of(k):
        return render(scene.with_params(p), cam, gs, prng_key(k), accel=accel).sum()

    def fwd(k):
        with torch.no_grad():
            return float(loss_of(k))

    def fwd_bwd(k):
        return torch.autograd.grad(loss_of(k), p.leaves())

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
    g_counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    if g_counts["wide_shade"][0] != fwd_counts["wide_shade"][0]:
        raise AssertionError(f"15c gradient: the backward launched wide_shade "
                             f"({fwd_counts['wide_shade'][0]} -> {g_counts['wide_shade'][0]})")
    if fwd_counts["wide_shade"][0] != 2 * gs.bounce_limit:
        raise AssertionError(f"15c gradient: forward wide_shade {fwd_counts['wide_shade'][0]}")
    if g_counts["lane_scatter"][0] <= 0:
        raise AssertionError("15c gradient: lane_scatter never launched")
    _no_plain(g_counts, "15c gradient")
    names = ("vertices", "normals", "emission", "albedo", "scatter")
    g = {k: v.cpu().numpy() for k, v in zip(names, grads)}
    if not all(np.isfinite(v).all() for v in g.values()):
        raise AssertionError("15c gradient: non-finite")
    if not all(np.abs(g[k]).max() > 0 for k in ("vertices", "albedo", "emission")):
        raise AssertionError("15c gradient: a vertex, albedo or emission gradient is zero")
    light_v = float(np.abs(g["vertices"][scene_host.mesh.num_vertices - 8:]).max())
    print(f"phase 15c gradient 960x540 x 4 spp x 3 bounces, NEE (2,073,600 rays, one chunk, "
          f"sort + lane pack): forward {t_f:.4f} s, forward+backward {t_b:.4f} s, ratio "
          f"{t_b / t_f:.3f} (best of 3: forward {', '.join(f'{x:.4f}' for x in f_runs)}; "
          f"forward+backward {', '.join(f'{x:.4f}' for x in b_runs)}), max_memory_allocated "
          f"{peak / 2**30:.3f} GiB [{gpu}]")
    print(f"phase 15c gradient launches: forward wide_shade {fwd_counts['wide_shade'][0]} "
          f"(hits and shadow rays), after backward {g_counts['wide_shade'][0]}, lane_scatter "
          f"{g_counts['lane_scatter'][0]}, plain calls 0; max |g|: "
          + ", ".join(f"{k} {float(np.abs(v).max()):.4g}" for k, v in g.items())
          + f"; the light panels' vertices {light_v:.4g}")
    _profile_frame(lambda: fwd_bwd(4), t_b, gpu, "phase 15c", "one NEE forward+backward")

    # a small NEE gradient on the card against the CPU plain versions
    small = RenderSettings(resolution=(48, 27), samples_per_pixel=1, bounce_limit=3, nee=True)
    out = {}
    for where, sc, ac in (("cuda", scene, accel), ("cpu", scene_host.to("cpu"), accel_host)):
        q = _grad_leaves(sc)
        loss = render(sc.with_params(q), cam, small, prng_key(5), accel=ac, device=where).sum()
        out[where] = [x.cpu().numpy() for x in torch.autograd.grad(loss, q.leaves())]
    worst = _hold_grads("15c 48x27 gradient", names, out["cuda"], out["cpu"])
    print("phase 15c NEE gradient 48x27 x 1 spp x 3 bounces, card vs CPU plain versions, max "
          "|diff| / max |g|: " + worst)
    return {"launches": shadow_launches, "err": err, "ms": ms, "plain_ms": plain_ms,
            "bound": bound, "rays": rays, "live_rays": live}


def phase_cornell(dev, gpu):
    """15d: the cornell scene with anti-aliasing: the jitter bits against
    the numpy threefry, the film against the film without AA."""
    import numpy as np
    import torch

    from atray_tpu_torch.render.rng import prng_key, random_bits, random_bits_np, split
    from atray_tpu_torch.render.wavefront import render

    scene_host, s, cam, accel_host = _toml_scene("cornell")
    scene, accel = scene_host.to(dev), accel_host.to(dev)
    (w, h), spp, bounces = s.resolution, s.samples_per_pixel, s.bounce_limit
    aa_key = split(prng_key(1))[0]
    n = spp * h * w * 2
    card = random_bits(aa_key, n, dev).cpu().numpy()
    host = random_bits_np(aa_key, n)
    if not np.array_equal(card, host.astype(np.int64)):
        raise AssertionError(f"15d: the card's jitter bits differ from threefry on "
                             f"{int((card != host).sum())} of {n} words")

    def run(k):
        return render(scene, cam, s, prng_key(k), accel=accel, return_stats=True)

    warm, frames, counts, film = _timed_frames(run, (1,))
    if counts["wide_shade"][0] != bounces or counts["lane_take"][0] <= 0:
        raise AssertionError(f"15d: wide_shade {counts['wide_shade'][0]}, lane_take "
                             f"{counts['lane_take'][0]} launches")
    _no_plain(counts, "15d")
    plain = render(scene, cam, dataclasses.replace(s, anti_aliasing=False), prng_key(1),
                   accel=accel)
    f = film.cpu().numpy()
    if not np.isfinite(f).all() or torch.equal(film, plain):
        raise AssertionError("15d: the AA film is not finite or equals the film without AA")
    _frames_line("15d", f"examples/cornell.toml, dragon_proxy(20_000), mirror and light "
                 f"spheres, floor, {w}x{h} x {spp} spp x {bounces} bounces, anti-aliasing",
                 warm, frames, gpu)
    print(f"phase 15d: the card's {n} jitter words == numpy threefry2x32 for the same key; "
          f"launches wide_shade {counts['wide_shade'][0]}, lane_take {counts['lane_take'][0]}, "
          f"plain calls 0; film std {f.std():.4f}, max |AA - no AA| "
          f"{float((film - plain).abs().max()):.4f}")


def phase_oracle_slice(dev, gpu):
    """Phase 15; returns the shadow-ray launch's numbers."""
    t0 = time.perf_counter()
    phase_ladder_1(dev, gpu)
    phase_ladder_2(dev, gpu)
    shadow = phase_arealight(dev, gpu)
    phase_cornell(dev, gpu)
    print(f"phase 15 oracle slice: {time.perf_counter() - t0:.1f} s")
    return shadow


TEXTURE_SIZE = 1024           # the checker's texels a side (the CLI's ``checker = [H, W]``)


def _textured_slice_scene():
    """Phase 16's host scene: ``_slice_scene()`` plus ``assets/Deer.obj``
    (1,149 tex coords over 1,570 faces) turned a quarter about y, scaled to
    4.0 tall and standing on the floor left of the dragon, and the CLI's
    checker texture at 1024 x 1024 with colours (1, 1, 1) and (0.2, 0.2,
    0.2)."""
    import numpy as np

    from atray_tpu_torch.scene import build_scene, load_obj
    from atray_tpu_torch.scene.transforms import scale_to, translate_to

    base = _slice_scene()
    deer = load_obj(os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets",
                                 "Deer.obj"))
    v = np.asarray(deer.vertices)
    deer = dataclasses.replace(deer, vertices=np.stack([v[:, 2], v[:, 1], -v[:, 0]], 1))
    deer = translate_to(scale_to(deer, 4.0), (-2.5, 0.2, -2.0))
    yy, xx = np.mgrid[0:TEXTURE_SIZE, 0:TEXTURE_SIZE]
    m = ((xx + yy) % 2).astype(np.float32)[..., None]
    tex = m * np.ones(3, np.float32) + (1.0 - m) * np.full(3, 0.2, np.float32)
    return build_scene([base.mesh, deer], planes=base.planes, materials=base.materials,
                       texture=tex)


def _op_device_ms(run, op, shape0):
    """(device ms, calls) of the ``op`` calls whose first input has shape
    ``shape0`` in one call of ``run``, from torch.profiler (CPU ops with
    their input shapes, and the kernels each launched), or None where the
    profiler recorded no such call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        run()
        torch.cuda.synchronize()
    ms, calls = 0.0, 0
    for e in prof.key_averages(group_by_input_shape=True):
        if e.key == op and e.input_shapes and list(e.input_shapes[0]) == list(shape0):
            ms += float(getattr(e, "device_time_total", 0.0)) / 1e3
            calls += e.count
    return (ms, calls) if calls else None


def _texel_rows(scene, accel, o, d):
    """The texel rows the camera bounce of (o, d) reads, and the share of
    its rays that hit a face with tex coords: ``_texture_mod_soa`` on a
    texture whose first channel is the texel's flat index."""
    import torch

    from atray_tpu_torch.render import wavefront

    ids = wavefront.nearest_hit_ids(scene, o, d, accel)
    ft, fuv = wavefront.build_face_table(scene), wavefront.build_face_uv(scene)
    tri = ids.prim_type == wavefront.PRIM_TRI
    uv_hit = tri & (torch.index_select(fuv[:, 6], 0, ids.prim_id.clamp_min(0).long()) > 0.5)
    tex = scene.texture
    index_tex = torch.arange(tex.shape[0] * tex.shape[1], dtype=torch.float32,
                             device=tex.device)[:, None].expand(-1, 3).reshape(tex.shape)
    flat = wavefront._texture_mod_soa(index_tex, ft, fuv, ids.prim_id, tri,
                                      *(o[:, k] for k in range(3)), *(d[:, k] for k in range(3)))
    rows = torch.where(uv_hit, flat[0], 0.0).long()
    return rows, float(uv_hit.double().mean())


def phase_textured_frame(scene_host, scene, accel_host, accel, dev, gpu):
    """16a: the textured slice frame (the gather path over the shaded
    accel): textured share, timed frames, profile, the camera bounce's
    launch against the plain version bit for bit, sort + pack identity, a
    small render against the CPU. Returns (film, the kernels-line numbers
    of the gather path's ``wide_shade``)."""
    import numpy as np
    import torch

    from atray_tpu_torch.core.camera import camera_rays
    from atray_tpu_torch.render import wavefront
    from atray_tpu_torch.render.rng import prng_key

    settings, cam = _slice_settings()
    (w, h), spp, bounces = settings.resolution, settings.samples_per_pixel, settings.bounce_limit
    chunks = -(-(w * h * spp) // settings.ray_chunk)
    o, d = camera_rays(cam, w, h, 1, device=dev)
    rows, share = _texel_rows(scene, accel, o, d)
    if share < 0.10:
        raise AssertionError(f"16a: only {share:.4f} of the camera rays hit a textured face")
    tex_rows = scene.texture.reshape(-1, 3)
    gather_ms = _cuda_ms(lambda: torch.index_select(tex_rows, 0, rows), 20)
    del o, d

    hits = []           # wide_shade launches of each nearest_hit_ids call in the timed frames

    def run(k):
        with _launch_spy("nearest_hit_ids", hits if k else []):
            return wavefront.render(scene, cam, settings, prng_key(k), accel=accel,
                                    return_stats=True)

    warm, frames, counts, film = _timed_frames(run, (1, 2))
    per_frame = bounces * chunks
    if counts["wide_shade"][0] != per_frame * len(frames) or hits != [1] * per_frame * len(frames):
        raise AssertionError(f"16a: wide_shade launched {counts['wide_shade'][0]} times, "
                             f"{sum(hits)} of them in nearest_hit_ids, not once a bounce in "
                             "every chunk")
    if counts["lane_take"][0] <= 0:
        raise AssertionError("16a: lane_take never launched")
    _no_plain(counts, "16a")
    f = film.cpu().numpy()
    if f.shape != (h, w, 3) or not np.isfinite(f).all() or f.min() < 0 or f.max() > 1 \
            or not f.std() > 0.01:
        raise AssertionError(f"16a: film not finite (H, W, 3) in [0, 1] with std > 0.01")
    _frames_line("16a", f"the textured slice, dragon_proxy(139_000) + Deer.obj "
                 f"({scene.mesh.num_faces} tris), {TEXTURE_SIZE}x{TEXTURE_SIZE} checker, floor, "
                 f"{w}x{h} x {spp} spp x {bounces} bounces, {chunks} chunks", warm, frames, gpu)
    print(f"phase 16a: {share:.4f} of the camera rays hit a face with tex coords; launches over "
          f"the 2 timed frames wide_shade {counts['wide_shade'][0]} (all {sum(hits)} in "
          f"nearest_hit_ids: the gather path's hits), lane_take {counts['lane_take'][0]}, plain "
          f"calls 0; film std {f.std():.4f}; the camera bounce's texel gather alone "
          f"({rows.shape[0]} rows of {tex_rows.shape[0]}) {gather_ms:.4f} ms [{gpu}]")
    frame_s = sum(sec for sec, _ in frames) / len(frames)

    def one():
        return wavefront.render(scene, cam, settings, prng_key(3), accel=accel)

    _profile_frame(one, frame_s, gpu, "phase 16a", "one textured slice frame")
    gather = _op_device_ms(one, "aten::index_select", list(tex_rows.shape))
    print("phase 16a profile texel gather (aten::index_select on the "
          f"{tex_rows.shape[0]} x 3 texel rows): "
          + ("not measured (the profiler recorded no such call)" if gather is None else
             f"{gather[0]:.3f} ms of device time over {gather[1]} calls")
          + f" in one frame [{gpu}]")

    # the frame's own launches: the camera bounce and the sorted, packed
    # bounce 2 of one chunk, against the plain version bit for bit
    got = _frame_launches(scene, accel, (0, 2))
    entry = None
    for b in (0, 2):
        args = got[b]
        err, ms, plain_ms, _, bound = _compare_hits(accel, args[:6], args[6],
                                                    f"(phase 16a) gather-path bounce {b}", gpu,
                                                    exact=True)
        live = int(args[6].sum())
        print(f"phase 16a gather-path wide_shade (bounce {b}, chunk {FRAME_CHUNK}): {live} live "
              f"of {args[6].shape[0]} rays, t, id and material == the plain version's bit for "
              f"bit; kernel {ms:.4f} ms, bound {bound[0]:.4f} ms by {bound[1]} "
              f"({ms / bound[0]:.2f}x), plain {plain_ms:.1f} ms [{gpu}]")
        if b == 0:
            entry = {"launches": counts["wide_shade"][0], "err": err, "ms": ms,
                     "plain_ms": plain_ms, "bound": bound, "rays": args[6].shape[0],
                     "live_rays": live}
    del got

    def identity(on):
        s = dataclasses.replace(settings, resolution=(256, 144), samples_per_pixel=2,
                                ray_chunk=0, sort_bounces=on, lane_pack=on)
        return wavefront.render(scene, cam, s, prng_key(4), accel=accel)

    if not torch.equal(identity(True), identity(False)):
        raise AssertionError("16a: the sorted + packed textured film != the unsorted film")
    print(f"phase 16a identity 256x144 x 2 spp x 5 bounces: sort+pack textured film == plain "
          f"film (torch.equal) [{gpu}]")
    phase_small_vs_cpu(scene_host, accel_host, dev, gpu, "phase 16a small textured render")
    return film, entry


def phase_texture_gradient(scene_host, scene, accel_host, accel, gpu):
    """16b: the texel gradient at ``bench.py``'s backward config, and at
    48x27 against the CPU plain versions."""
    import numpy as np
    import torch

    from atray_tpu_torch.config import RenderSettings
    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.render.wavefront import render

    gs = RenderSettings(resolution=(960, 540), samples_per_pixel=4, bounce_limit=3, ray_chunk=0)
    _, cam = _slice_settings()
    tex = scene.texture.detach().clone().requires_grad_()
    textured = dataclasses.replace(scene, texture=tex)

    def loss_of(k):
        return render(textured, cam, gs, prng_key(k), accel=accel).sum()

    def fwd(k):
        with torch.no_grad():
            return float(loss_of(k))

    def fwd_bwd(k):
        return torch.autograd.grad(loss_of(k), [tex])[0]

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
    g = torch.autograd.grad(loss, [tex])[0]
    torch.cuda.synchronize()
    counts = _read_counts()
    peak = torch.cuda.max_memory_allocated()
    if fwd_counts["wide_shade"][0] != gs.bounce_limit:
        raise AssertionError(f"16b: forward wide_shade {fwd_counts['wide_shade'][0]}")
    if counts["wide_shade"][0] != fwd_counts["wide_shade"][0]:
        raise AssertionError(f"16b: the backward launched wide_shade "
                             f"({fwd_counts['wide_shade'][0]} -> {counts['wide_shade'][0]})")
    if counts["lane_scatter"][0] <= 0:
        raise AssertionError("16b: lane_scatter never launched")
    _no_plain(counts, "16b")
    gn = g.cpu().numpy()
    if not np.isfinite(gn).all() or not np.abs(gn).max() > 0:
        raise AssertionError("16b: the texel gradient is not finite or is zero")
    print(f"phase 16b texel gradient 960x540 x 4 spp x 3 bounces (2,073,600 rays, one chunk, "
          f"sort + lane pack, gather path): forward {t_f:.4f} s, forward+backward {t_b:.4f} s, "
          f"ratio {t_b / t_f:.3f} (best of 3: forward {', '.join(f'{x:.4f}' for x in f_runs)}; "
          f"forward+backward {', '.join(f'{x:.4f}' for x in b_runs)}), max_memory_allocated "
          f"{peak / 2**30:.3f} GiB [{gpu}]")
    print(f"phase 16b launches: forward wide_shade {fwd_counts['wide_shade'][0]}, after backward "
          f"{counts['wide_shade'][0]}, lane_scatter {counts['lane_scatter'][0]}, plain calls 0; "
          f"texels with a gradient {int((gn != 0).any(-1).sum())} of {gn.shape[0] * gn.shape[1]}, "
          f"max |g| {float(np.abs(gn).max()):.4g} [{gpu}]")

    # a small texel gradient on the card against the CPU plain versions
    small = RenderSettings(resolution=(48, 27), samples_per_pixel=1, bounce_limit=3)
    out = {}
    for where, sc, ac in (("cuda", scene, accel), ("cpu", scene_host.to("cpu"), accel_host)):
        t = sc.texture.detach().clone().requires_grad_()
        loss = render(dataclasses.replace(sc, texture=t), cam, small, prng_key(5), accel=ac,
                      device=where).sum()
        out[where] = torch.autograd.grad(loss, [t])[0].cpu().numpy()
    if not np.abs(out["cpu"]).max() > 0:
        raise AssertionError("16b 48x27 texel gradient: zero on the CPU")
    worst = _hold_grads("16b 48x27 texel gradient", ("texture",), [out["cuda"]], [out["cpu"]])
    print("phase 16b texel gradient 48x27 x 1 spp x 3 bounces, card vs CPU plain versions, max "
          f"|diff| / max |g|: {worst}; texels with a gradient "
          f"{int((out['cpu'] != 0).any(-1).sum())} [{gpu}]")


def phase_aovs(scene, accel, dev, gpu):
    """16c: the AOVs of the textured slice at 1920x1080 through the shaded
    accel, held to the kernel's planes and the floor."""
    import torch

    from atray_tpu_torch.core.camera import camera_rays
    from atray_tpu_torch.core.intersect import INF, moller_trumbore, plane_hits
    from atray_tpu_torch.kernels.wide_shade import wide_shade_planes
    from atray_tpu_torch.render.aov import render_aovs
    from atray_tpu_torch.render.wavefront import build_face_table

    settings, cam = _slice_settings()
    w, h = settings.resolution
    render_aovs(scene, cam, w, h, accel=accel)
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    aovs = render_aovs(scene, cam, w, h, accel=accel)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = _read_counts()
    if counts["wide_shade"][0] != 1:
        raise AssertionError(f"16c: wide_shade launched {counts['wide_shade'][0]} times, not once")
    _no_plain(counts, "16c")
    o, d = camera_rays(cam, w, h, 1, device=dev)
    ones = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
    fo = wide_shade_planes(accel, *_planes_of(o, d), ones)
    tp, pid = plane_hits(o, d, scene.planes.normals, scene.planes.offsets)
    tri = fo["id"] >= 0
    t_tri = torch.where(tri, fo["t"], INF)
    floor = (pid >= 0) & (tp < t_tri)
    # resolve_hit demotes a triangle hit whose Moller-Trumbore recompute
    # misses (a grazing hit decided the other way by the recompute)
    row = torch.index_select(build_face_table(scene), 0, fo["id"].clamp_min(0).long())
    kept = moller_trumbore(o, d, row[:, 0:3], row[:, 3:6], row[:, 6:9])[0] < 1.0e30
    tri_won = tri & ~floor
    demoted = int((tri_won & ~kept).sum())
    hit = floor | (tri_won & kept)
    mat = torch.where(floor, scene.planes.material_id[pid.clamp_min(0).long()],
                      torch.where(tri_won & kept, fo["mat"], -1))
    depth = torch.where(floor, tp, torch.where(tri, fo["t"], 0.0))
    got_hit = aovs["hit"].reshape(-1) > 0.5
    got_mat = aovs["material_id"].reshape(-1)
    if not torch.equal(got_hit, hit) or not torch.equal(got_mat, mat):
        bad = torch.nonzero((got_hit != hit) | (got_mat != mat)).reshape(-1)[:4].tolist()
        raise AssertionError(
            f"16c: hit or material_id differ from the kernel's planes on "
            f"{int((got_hit != hit).sum())}, {int((got_mat != mat).sum())} pixels; (pixel, id, "
            f"t, floor t, kept, AOV hit, AOV material): "
            + "; ".join(f"({i}, {int(fo['id'][i])}, {float(fo['t'][i])}, {float(tp[i])}, "
                        f"{bool(kept[i])}, {bool(got_hit[i])}, {int(got_mat[i])})" for i in bad))
    rel = ((aovs["depth"].reshape(-1) - depth).abs() / depth.abs().clamp_min(1e-30))[hit]
    if float(rel.max()) > 1e-4:
        raise AssertionError(f"16c: depth off the kernel's t by {float(rel.max()):.3g} relative")
    al = aovs["albedo"].reshape(-1, 3)[hit]
    print(f"phase 16c AOVs 1920x1080 through the shaded accel: {sec:.4f} s (one wide_shade "
          f"launch, plain calls 0); hit and material_id == the kernel's id and material planes "
          f"with the floor merged and {demoted} grazing hits demoted by the recompute, depth "
          f"within {float(rel.max()):.3g} of its t (1e-4 relative); {int(hit.sum())} hits, "
          f"{len(torch.unique(al, dim=0))} distinct albedo rows [{gpu}]")


class _Stop(Exception):
    """Stops a progressive render after a batch."""


def phase_progressive(dev, gpu):
    """16d: progressive render with a stop and a resume, on 15d's cornell
    scene."""
    import tempfile

    import numpy as np

    from atray_tpu_torch.render import progressive

    scene_host, s, cam, accel_host = _toml_scene("cornell")
    scene, accel = scene_host.to(dev), accel_host.to(dev)
    total = 3 * s.samples_per_pixel
    t0 = time.perf_counter()
    full = progressive.render_progressive(scene, cam, s, total, accel=accel, seed=11)
    full_s = time.perf_counter() - t0

    def stop_after_one(state):
        if state.batches_done == 1:
            raise _Stop

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cornell.npz")
        try:
            progressive.render_progressive(scene, cam, s, total, accel=accel, seed=11,
                                           checkpoint_path=path, on_batch=stop_after_one)
        except _Stop:
            pass
        stopped = progressive.load_checkpoint(path).batches_done
        t0 = time.perf_counter()
        resumed = progressive.render_progressive(scene, cam, s, total, accel=accel, seed=11,
                                                 checkpoint_path=path)
        resume_s = time.perf_counter() - t0
    if stopped != 1 or resumed.batches_done != 3:
        raise AssertionError(f"16d: stopped at batch {stopped}, resumed to {resumed.batches_done}")
    if not np.array_equal(resumed.film_sum, full.film_sum):
        raise AssertionError("16d: the resumed film_sum differs from the run without a stop")
    w, h = s.resolution
    print(f"phase 16d progressive: examples/cornell.toml {w}x{h}, AA, {s.bounce_limit} bounces, "
          f"3 batches of {s.samples_per_pixel} spp: without a stop {full_s:.4f} s; stopped after "
          f"batch 1, resumed from the checkpoint (2 batches) {resume_s:.4f} s; film_sum == the "
          f"run without a stop (np.array_equal), film std {full.film().std():.4f} [{gpu}]")


def phase_telemetry(scene, accel, gpu):
    """16e: the textured slice frame as 16 timed chunks, against
    ``render()`` at that chunk size with a progress callback."""
    import torch

    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.render.telemetry import render_telemetry, tail_report
    from atray_tpu_torch.render.wavefront import render

    settings, cam = _slice_settings()
    film_t, report = render_telemetry(scene, cam, settings, prng_key(7), accel=accel,
                                      n_chunks=16)
    chunked = dataclasses.replace(settings, ray_chunk=report["chunk_rays"])
    ticks = []
    film, stats = render(scene, cam, chunked, prng_key(7), accel=accel, return_stats=True,
                         progress_cb=ticks.append)
    rays = int(stats["rays_cast"])
    if not torch.equal(film_t, film):
        raise AssertionError("16e: the telemetry film != render() at its chunk size")
    if len(ticks) != report["n_chunks"] or sum(ticks) != rays \
            or ticks != report["chunk_live_rays"]:
        raise AssertionError(f"16e: {len(ticks)} progress ticks summing to {sum(ticks)}, not one "
                             f"a chunk summing to rays_cast {rays}")
    print(f"phase 16e telemetry: the textured slice frame as {report['n_chunks']} chunks of "
          f"{report['chunk_rays']} rays, {sum(report['chunk_s']):.4f} s in all; film == "
          f"render(ray_chunk={report['chunk_rays']}) (torch.equal); progress_cb ticked "
          f"{len(ticks)} times, summing to rays_cast {rays}, each tick its chunk's live rays "
          f"[{gpu}]")
    for line in tail_report(report).splitlines():
        print(f"phase 16e {line}")


def phase_bmp(film, gpu):
    """16f: ``save_bmp`` of 16a's film, its header read back."""
    import struct
    import tempfile

    from atray_tpu_torch.render.film import save_bmp

    h, w = film.shape[0], film.shape[1]
    with tempfile.TemporaryDirectory() as tmp:
        path = save_bmp(os.path.join(tmp, "slice.bmp"), film, srgb=True)
        with open(path, "rb") as fh:
            data = fh.read()
    size, = struct.unpack("<I", data[2:6])
    bw, bh, planes, bits = struct.unpack("<iiHH", data[18:30])
    want = 54 + ((3 * w + 3) & ~3) * h
    if data[:2] != b"BM" or (bw, bh, planes, bits) != (w, h, 1, 24) or not size == len(data) == want:
        raise AssertionError(f"16f: BMP header {data[:2]!r} {size} {bw}x{bh} {bits} bits")
    print(f"phase 16f save_bmp: 16a's film, {len(data)} bytes, header BM, {bw}x{bh}, {bits} bits, "
          f"file size field == the file's [{gpu}]")


def phase_output_slice(dev, gpu):
    """Phase 16; returns the gather path's ``wide_shade`` numbers."""
    from atray_tpu_torch.accel.shaded import build_shaded_accel
    from atray_tpu_torch.config import KDTreeConfig

    t_all = time.perf_counter()
    scene_host = _textured_slice_scene()
    t0 = time.perf_counter()
    accel_host = build_shaded_accel(scene_host, KDTreeConfig(leaf_size=16))
    print(f"phase 16 host build: textured slice scene and shaded accel in "
          f"{time.perf_counter() - t_all:.2f} s (the accel {time.perf_counter() - t0:.2f} s; "
          f"{scene_host.mesh.num_faces} tris, {accel_host.num_nodes} wide nodes, texels "
          f"{scene_host.texture.nbytes / 1e6:.1f} MB) [{gpu}]")
    scene, accel = scene_host.to(dev), accel_host.to(dev)
    film, entry = phase_textured_frame(scene_host, scene, accel_host, accel, dev, gpu)
    phase_texture_gradient(scene_host, scene, accel_host, accel, gpu)
    phase_aovs(scene, accel, dev, gpu)
    phase_progressive(dev, gpu)
    phase_telemetry(scene, accel, gpu)
    phase_bmp(film, gpu)
    print(f"phase 16 textures, AOVs and output: {time.perf_counter() - t_all:.1f} s")
    return entry


# phase 17: the host surfaces on the card: the native OBJ parser, the
# command line (``atray_tpu_torch.cli``) at ladder config 3 and on the two
# example scenes, its modes, the host tools and the demo

ROOT = os.path.dirname(os.path.abspath(__file__))
PLAIN_PIECE_HITS = 4_147_200  # rays a call of the plain wide_shade (a slice chunk)
CONFIG3_TOML = """\
[render]
resolution = [1280, 720]
samples_per_pixel = 16
bounce_limit = 3
sort_bounces = true

[accel]
leaf_size = 16

[camera]
eye = [0.0, 1.0, 0.8]
look_at = [0.0, -0.2, -4.0]
h_fov = 0.9

[[materials]]
name = "sky"
emission = [0.35, 0.45, 0.65]

[[materials]]
name = "body"
albedo = [0.75, 0.55, 0.35]
scatter = 0.15

[[materials]]
name = "floor"
albedo = [0.6, 0.6, 0.65]

[[materials]]
name = "light"
emission = [9.0, 8.5, 7.0]

[[meshes]]
obj = {obj}
material = "body"
scale_to = 2.4
translate_to = [0.0, -0.3, -4.0]

[[planes]]
normal = [0.0, 1.0, 0.0]
offset = -1.8
material = "floor"
"""


def _cli(label, argv):
    """``cli.main(argv)`` with its stdout and stderr captured, then printed
    line by line after ``phase <label>``; the phase registry is emptied
    first, so its table is this run's. Returns (printed paths, stderr
    lines, seconds)."""
    import io

    from atray_tpu_torch import cli
    from atray_tpu_torch.utils.profiling import reset_phases

    reset_phases()
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    sec = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"{label}: the command line exited {rc}")
    lines = err.getvalue().splitlines()
    for line in lines:
        print(f"phase {label} | {line}")
    return out.getvalue().split(), lines, sec


@contextlib.contextmanager
def _films_of_render(into):
    """While the block runs, append every film ``wavefront.render`` returns
    (the command line imports ``render`` when it runs)."""
    from atray_tpu_torch.render import wavefront

    real = wavefront.render

    def spy(*args, **kw):
        out = real(*args, **kw)
        into.append(out[0] if isinstance(out, tuple) else out)
        return out

    wavefront.render = spy
    try:
        yield
    finally:
        wavefront.render = real


@contextlib.contextmanager
def _first_launches(got):
    """While the block runs, keep clones of the arguments of the first
    ``wide_shade_planes`` call ("wide_shade": ox..dz, alive: the camera
    bounce) and of the first ``lane_take`` call ("lane_take": cols, idx:
    the compaction's state pack, reached through ``lane_take_p``)."""
    from atray_tpu_torch.kernels import lane_pack
    from atray_tpu_torch.render import wavefront

    real_ws, real_lt = wavefront.wide_shade_planes, lane_pack.lane_take

    def ws(acc, *args, **kw):
        got.setdefault("wide_shade", [a.clone() for a in args])
        return real_ws(acc, *args, **kw)

    def lt(cols, idx):
        got.setdefault("lane_take", (cols.clone(), idx.clone()))
        return real_lt(cols, idx)

    wavefront.wide_shade_planes, lane_pack.lane_take, wavefront.lane_take = ws, lt, lt
    try:
        yield
    finally:
        wavefront.wide_shade_planes = real_ws
        lane_pack.lane_take = wavefront.lane_take = real_lt


def _check_film(label, f):
    import numpy as np

    f = f.detach().cpu().numpy() if hasattr(f, "detach") else np.asarray(f)
    if not (np.isfinite(f).all() and f.min() >= 0 and f.max() <= 1 and f.mean() > 0.01):
        raise AssertionError(f"{label}: film not finite in [0, 1] or black "
                             f"(mean {float(np.nanmean(f))})")
    return f


def _hold_take(cols, idx, label, gpu, phase):
    """``_take_case`` on a captured state pack (float planes held bit for
    bit as their int32 words), with its bound: the take reads only the live
    rays' words, so the live sources once, the index and every output word;
    returns the kernels-line numbers."""
    import torch

    cols = cols.view(torch.int32)
    ms, plain_ms, lib_ms = _take_case(cols, idx, label, gpu, phase=phase)
    sources = int((idx >= 0).sum())
    c, word = cols.shape[0], cols.element_size()
    bound = _bound(c * sources * word + idx.nbytes + c * idx.shape[0] * word)
    print(f"phase {phase} lane_take {label} (C={c}, N={cols.shape[1]}, {sources} live sources): "
          f"bound {bound[0]:.4f} ms by {bound[1]} ({ms / bound[0]:.2f}x) [{gpu}]")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound": bound,
            "rays": int(idx.shape[0])}


def phase_native_parser(gpu):
    """17a: the native parser on the three assets and a 139k-triangle OBJ,
    array-equal to the Python parser."""
    import tempfile

    import numpy as np

    from atray_tpu_torch import native
    from atray_tpu_torch.scene import load_obj, procedural, save_obj

    if not native.available():
        raise AssertionError(f"17a: the native library did not build: {native.bindings._native.error}")
    with tempfile.TemporaryDirectory() as tmp:
        dragon = os.path.join(tmp, "Dragon.obj")
        save_obj(dragon, procedural.dragon_proxy(target_tris=139_000, material=1))
        for path in [os.path.join(ROOT, "assets", a) for a in ("Cube.obj", "Deer.obj",
                                                                "Monkey.obj")] + [dragon]:
            t0 = time.perf_counter()
            nat = native.parse_obj_native(path)
            t_nat = time.perf_counter() - t0
            if nat is None:
                raise AssertionError(f"17a: parse_obj_native returned None on {path}")
            t0 = time.perf_counter()
            py = load_obj(path, backend="python")
            t_py = time.perf_counter() - t0
            for k, a in nat.items():
                b = getattr(py, k)
                if a.shape[0] == 0:         # a TriMesh pads an empty table to a zero row
                    a = np.zeros_like(b)
                if a.dtype != b.dtype or not np.array_equal(a, b):
                    raise AssertionError(f"17a: native {k} != the Python parser's on {path}")
            name = "dragon_proxy(139_000) OBJ" if path == dragon else os.path.basename(path)
            print(f"phase 17a native OBJ parser: {name} ({os.path.getsize(path)} bytes, "
                  f"{nat['faces'].shape[0]} faces, {nat['vertices'].shape[0]} vertices): native "
                  f"{t_nat:.4f} s, Python {t_py:.4f} s of host time ({t_py / t_nat:.1f}x); the six "
                  f"arrays == the Python parser's [{gpu}]")


def _same_scene(label, got, want):
    import numpy as np

    for part in ("mesh", "spheres", "planes", "materials"):
        a, b = getattr(got, part), getattr(want, part)
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if x.dtype != y.dtype or not np.array_equal(x, y):
                raise AssertionError(f"{label}: {part}.{f.name} differs from the helper's")


def phase_cli_config3(dev, tmp, gpu):
    """17b: ladder config 3 through ``cli.main``: the scene against
    ``_ladder_scene(3)``, the PNG against a direct render, the camera
    bounce's ``wide_shade`` launch and the first ``lane_take`` launch against
    their plain versions. Returns (toml path, the kernels-line numbers)."""
    import numpy as np
    import torch

    from atray_tpu_torch import cli
    from atray_tpu_torch.render.film import save_png
    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.render.wavefront import render
    from atray_tpu_torch.utils.profiling import phase_stats

    toml = os.path.join(tmp, "ladder3.toml")
    with open(toml, "w") as fh:
        fh.write(CONFIG3_TOML.format(obj=json.dumps(os.path.join(ROOT, "assets", "Deer.obj"))))
    scene_h, cam, s, accel_cfg, mesh_cfg = cli.load_scene_file(toml)
    want_scene, want_s, want_cam, want_accel = _ladder_scene(3)
    _same_scene("17b", scene_h, want_scene)
    if s != want_s or accel_cfg.leaf_size != 16 or mesh_cfg.num_devices != 0 or not all(
            np.array_equal(getattr(cam, f.name), getattr(want_cam, f.name))
            for f in dataclasses.fields(cam)):
        raise AssertionError("17b: the TOML's settings, camera or configs differ from "
                             "_ladder_scene(3)'s")
    (w, h), spp, bounces = s.resolution, s.samples_per_pixel, s.bounce_limit

    # the first render at this width also grows the caching allocator: a
    # first command, then the one whose launches and film are held
    _, _, first_s = _cli("17b first", ["render", toml, "-o", os.path.join(tmp, "first.png")])
    first_render_s = phase_stats()["render"]["min_s"]
    png = os.path.join(tmp, "ladder3.png")
    films = []
    _reset_counts()
    with _films_of_render(films):
        paths, _, sec = _cli("17b", ["render", toml, "-o", png])
    counts = _read_counts()
    if paths != [png] or len(films) != 1 or films[0].device != dev:
        raise AssertionError(f"17b: wrote {paths}, rendered {len(films)} films on "
                             f"{[str(f.device) for f in films]}")
    if counts["wide_shade"][0] != bounces or counts["lane_take"][0] <= 0:
        raise AssertionError(f"17b: wide_shade {counts['wide_shade'][0]} launches (not one a "
                             f"bounce), lane_take {counts['lane_take'][0]}")
    _no_plain(counts, "17b")
    f = _check_film("17b", films[0])
    render_s = phase_stats()["render"]["min_s"]

    scene, accel = want_scene.to(dev), want_accel.to(dev)
    got = {}
    with _first_launches(got):
        film, stats = render(scene, cam, s, prng_key(0), accel=accel, return_stats=True)
    live = int(stats["rays_cast"])
    direct = save_png(os.path.join(tmp, "direct.png"), film)
    if open(png, "rb").read() != open(direct, "rb").read():
        raise AssertionError("17b: the command line's PNG != save_png of a direct render()")
    if not torch.equal(film, films[0]):
        raise AssertionError("17b: the command line's film != the direct render's")
    print(f"phase 17b ladder config 3 through cli.main: Deer.obj ({scene.mesh.num_faces} tris), "
          f"floor, {w}x{h} x {spp} spp x {bounces} bounces, one chunk, sort + lane pack: first "
          f"command {first_s:.4f} s (render phase {first_render_s:.4f} s), second command "
          f"{sec:.4f} s, its render phase {render_s:.4f} s, live rays {live}, "
          f"{live / render_s:.6g} live rays/s; launches wide_shade {counts['wide_shade'][0]}, "
          f"lane_take {counts['lane_take'][0]}, plain calls 0; load_scene_file's scene, "
          f"settings and camera == _ladder_scene(3)'s; the PNG's bytes == save_png of a "
          f"direct render() with prng_key(0); film std {f.std():.4f} [{gpu}]")

    # the render's launches, captured from the direct render (the same
    # inputs: its film equals the command line's bit for bit)
    args = got["wide_shade"]
    err, ms, plain_ms, _, bound = _compare_hits(accel, args[:6], args[6],
                                                "(phase 17b) config 3 camera bounce", gpu,
                                                piece=PLAIN_PIECE_HITS)
    rays, alive_n = args[6].shape[0], int(args[6].sum())
    print(f"phase 17b config 3 camera-bounce wide_shade: {alive_n} live of {rays} rays, held to "
          f"the plain version under phase 3's rules (max error {err:.3g}); kernel {ms:.4f} ms, "
          f"bound {bound[0]:.4f} ms by {bound[1]} ({ms / bound[0]:.2f}x), plain {plain_ms:.1f} ms "
          f"in pieces of {PLAIN_PIECE_HITS} rays [{gpu}]")
    cols, idx = got["lane_take"]
    del got, args, film
    take = _hold_take(cols, idx, "config 3 state pack", gpu, "17b")
    return toml, {
        "wide_shade": {"launches": counts["wide_shade"][0], "err": err, "ms": ms,
                       "plain_ms": plain_ms, "bound": bound, "rays": rays, "live_rays": alive_n},
        "lane_take": {"launches": counts["lane_take"][0], **take}}


def phase_cli_examples(dev, tmp, gpu):
    """17c: examples/cornell.toml and examples/arealight.toml through
    ``cli.main`` at their own resolution and spp."""
    from atray_tpu_torch import cli

    for name, per_bounce in (("cornell", 1), ("arealight", 2)):   # NEE: hits and shadow rays
        toml = os.path.join(ROOT, "examples", f"{name}.toml")
        s = cli.load_scene_file(toml)[2]
        films = []
        _reset_counts()
        with _films_of_render(films):
            paths, _, sec = _cli(f"17c {name}", ["render", toml, "-o",
                                                 os.path.join(tmp, f"{name}.png"), "--srgb"])
        counts = _read_counts()
        if len(films) != 1 or films[0].device != dev or len(paths) != 1:
            raise AssertionError(f"17c {name}: {len(films)} films, paths {paths}")
        if counts["wide_shade"][0] != per_bounce * s.bounce_limit or counts["lane_take"][0] <= 0:
            raise AssertionError(f"17c {name}: wide_shade {counts['wide_shade'][0]}, lane_take "
                                 f"{counts['lane_take'][0]} launches")
        _no_plain(counts, f"17c {name}")
        f = _check_film(f"17c {name}", films[0])
        (w, h), spp = s.resolution, s.samples_per_pixel
        print(f"phase 17c examples/{name}.toml through cli.main: {w}x{h} x {spp} spp x "
              f"{s.bounce_limit} bounces{', NEE' if s.nee else ''}"
              f"{', AA' if s.anti_aliasing else ''}: command {sec:.4f} s; launches wide_shade "
              f"{counts['wide_shade'][0]}, lane_take {counts['lane_take'][0]}, plain calls 0; "
              f"film finite in [0, 1], mean {f.mean():.4f}, std {f.std():.4f} [{gpu}]")


def phase_cli_modes(toml, tmp, gpu):
    """17d: --aov, --telemetry 4 and --progressive resumed from its
    checkpoint, on config 3."""
    import numpy as np

    from atray_tpu_torch import cli

    prefix = os.path.join(tmp, "ladder3_aov")
    paths, _, sec = _cli("17d aov", ["render", toml, "-o", os.path.join(tmp, "aov.png"),
                                     "--aov", prefix])
    names = [f"{prefix}_{n}.png" for n in ("depth", "normal", "albedo", "emission")]
    if paths[:4] != names or not all(os.path.getsize(p) > 0 for p in names):
        raise AssertionError(f"17d: --aov wrote {paths}")
    print(f"phase 17d --aov on config 3: beauty and 4 AOV PNGs in {sec:.4f} s [{gpu}]")

    _reset_counts()
    _, lines, sec = _cli("17d telemetry", ["render", toml, "-o", os.path.join(tmp, "tel.png"),
                                           "--telemetry", "4"])
    counts = _read_counts()
    if not any(l.startswith("chunk wall (s)") for l in lines) or counts["wide_shade"][0] != 4 * 3:
        raise AssertionError(f"17d: --telemetry 4 printed no table or launched wide_shade "
                             f"{counts['wide_shade'][0]} times")
    print(f"phase 17d --telemetry 4 on config 3: {sec:.4f} s, wide_shade {counts['wide_shade'][0]} "
          f"launches (one a bounce in each of 4 chunks) [{gpu}]")

    spb = cli.load_scene_file(toml)[2].samples_per_pixel
    ck, whole = os.path.join(tmp, "ck.npz"), os.path.join(tmp, "whole.npz")
    base = ["render", toml, "--seed", "4"]
    t = []
    for label, total, path, png in (("first", "16", ck, "p16.png"), ("resumed", "32", ck, "p32.png"),
                                    ("whole", "32", whole, "w32.png")):
        t.append(_cli(f"17d progressive {label}", base + [
            "-o", os.path.join(tmp, png), "--progressive", total, "--checkpoint", path])[2])
    a, b = np.load(ck), np.load(whole)
    if not (int(a["batches_done"]) == int(b["batches_done"]) == -(-32 // spb)
            and np.array_equal(a["film_sum"], b["film_sum"])):
        raise AssertionError("17d: the resumed progressive film != the uninterrupted one")
    if open(os.path.join(tmp, "p32.png"), "rb").read() != open(os.path.join(tmp, "w32.png"),
                                                              "rb").read():
        raise AssertionError("17d: the resumed progressive PNG != the uninterrupted one")
    print(f"phase 17d --progressive on config 3 (batches of {spb} spp): 16 then resumed to 32 from "
          f"the checkpoint {t[0]:.4f} + {t[1]:.4f} s, uninterrupted 32 {t[2]:.4f} s; film_sum "
          f"and PNG bytes == the uninterrupted run's [{gpu}]")


def phase_host_tools(tmp, gpu):
    """17e: validate_bvh, compute_vertex_normals and save_cost_heatmap, with
    their host seconds; then the demo as a subprocess from the root."""
    import numpy as np

    from atray_tpu_torch.accel.bvh import build_bvh, validate_bvh
    from atray_tpu_torch.config import KDTreeConfig
    from atray_tpu_torch.core.camera import look_at_camera
    from atray_tpu_torch.scene import load_obj, procedural
    from atray_tpu_torch.scene.transforms import compute_vertex_normals, scale_to, translate_to
    from atray_tpu_torch.utils.debugviz import save_cost_heatmap

    dragon = procedural.dragon_proxy(target_tris=139_000)
    bvh = build_bvh(dragon.vertices, dragon.faces, KDTreeConfig(leaf_size=16))
    t0 = time.perf_counter()
    validate_bvh(bvh, dragon.num_faces)
    t_val = time.perf_counter() - t0
    deer = translate_to(scale_to(load_obj(os.path.join(ROOT, "assets", "Deer.obj")), 2.4),
                        (0.0, -0.3, -4.0))
    t0 = time.perf_counter()
    smooth = compute_vertex_normals(deer)
    t_vn = time.perf_counter() - t0
    if not np.allclose(np.linalg.norm(smooth.normals, axis=1), 1.0, atol=1e-5):
        raise AssertionError("17e: vertex normals are not unit length")
    dbvh = build_bvh(deer.vertices, deer.faces, KDTreeConfig(leaf_size=16))
    cam = look_at_camera(*LADDER_CAMERA, h_fov=0.9, aspect=320 / 180)
    t0 = time.perf_counter()
    heat = save_cost_heatmap(os.path.join(tmp, "cost.png"), dbvh, None, cam, 320, 180)
    t_heat = time.perf_counter() - t0
    print(f"phase 17e host tools: validate_bvh on dragon_proxy(139_000)'s BVH ({bvh.num_nodes} "
          f"nodes, leaf 16) {t_val:.4f} s; compute_vertex_normals on Deer.obj "
          f"({deer.num_vertices} vertices) {t_vn:.4f} s; save_cost_heatmap 320x180 on its BVH "
          f"({dbvh.num_nodes} nodes) {t_heat:.4f} s, {os.path.getsize(heat)} bytes [{gpu}]")

    out = os.path.join(tmp, "demo", "demo")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-m", "atray_tpu_torch.examples.render_demo",
                          "--out", out], cwd=ROOT, capture_output=True, text=True, timeout=300)
    sec = time.perf_counter() - t0
    want = [f"{out}.png"] + [f"{out}_{n}.png" for n in ("depth", "normal", "albedo", "emission")]
    printed = run.stdout.split()
    if run.returncode != 0 or not all(p in printed and os.path.getsize(p) > 0 for p in want):
        raise AssertionError(f"17e: the demo exited {run.returncode}: {run.stdout[-2000:]} "
                             f"{run.stderr[-2000:]}")
    print(f"phase 17e demo: python3 -m atray_tpu_torch.examples.render_demo from the root, exit "
          f"0 in {sec:.2f} s (a process of its own, the kernels' library loaded from the build "
          f"directory), five PNGs; its line: {run.stdout.splitlines()[0]} [{gpu}]")


def phase_host_surfaces(dev, gpu):
    """Phase 17; returns the command line's kernels-line numbers."""
    import tempfile

    t0 = time.perf_counter()
    phase_native_parser(gpu)
    with tempfile.TemporaryDirectory() as tmp:
        toml, entry = phase_cli_config3(dev, tmp, gpu)
        phase_cli_examples(dev, tmp, gpu)
        phase_cli_modes(toml, tmp, gpu)
        phase_host_tools(tmp, gpu)
    print(f"phase 17 host surfaces: {time.perf_counter() - t0:.1f} s")
    return entry


# ---------------------------------------------------------------------------
# Phase 18: the sharded serving path, two ranks on one card
# ---------------------------------------------------------------------------

RANKS = 2                     # processes, each a rank of one gloo group on cuda:0
RANK_TIMEOUT_S = 420          # both ranks' whole run; the parent kills them after
TORCHRUN_TIMEOUT_S = 240
CORNELL = os.path.join(ROOT, "examples", "cornell.toml")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _timed_gathers(into, dev):
    """While the block runs, time every ``dist.mesh.gather_rows`` (a device
    synchronize on each side) and append (seconds, bytes sent, bytes
    gathered)."""
    import torch

    from atray_tpu_torch.dist import mesh as dmesh

    real = dmesh.gather_rows

    def spy(x, mesh):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = real(x, mesh)
        torch.cuda.synchronize(dev)
        into.append((time.perf_counter() - t0, x.nbytes, out.nbytes))
        return out

    dmesh.gather_rows = spy
    try:
        yield
    finally:
        dmesh.gather_rows = real


@contextlib.contextmanager
def _first_hop(got):
    """While the block runs, keep clones of the first ring hop's
    ``wide_shade_first_hit`` rays ("planes": ox..dz, "alive")."""
    from atray_tpu_torch.kernels import wide_shade

    real = wide_shade.wide_shade_first_hit

    def spy(acc, orig, dirn, alive=None):
        if "planes" not in got:
            got["planes"] = [x[:, k].contiguous().clone() for x in (orig, dirn) for k in range(3)]
            got["alive"] = (alive != 0).clone()
        return real(acc, orig, dirn, alive)

    wide_shade.wide_shade_first_hit = spy
    try:
        yield
    finally:
        wide_shade.wide_shade_first_hit = real


def _in_turns(mesh, fn):
    """``fn()`` on each rank in turn, the others waiting at a barrier, so
    that a timing has the card to itself; returns this rank's result."""
    import torch.distributed as dist

    out = None
    for r in range(mesh.size):
        if mesh.rank == r:
            out = fn()
        dist.barrier()
    return out


def phase_sharded_slice(scene_host, accel_host, mesh, gpu):
    """18a (each rank): the slice through ``render(mesh=)``: a warm-up frame
    (its camera-bounce ``wide_shade`` launch and first ``lane_take`` launch
    captured), then the counts set to 0 and a timed frame; rank 0 renders
    the frame alone, which the sharded film must equal bit for bit; then
    each rank in turn holds its captured launches against the plain
    versions. Returns (the rank's numbers, the local film on rank 0 or
    None)."""
    import torch

    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.render.wavefront import render

    dev, rank = mesh.device, mesh.rank
    scene, accel = scene_host.to(dev), accel_host.to(dev)
    settings, cam = _slice_settings()
    (w, h), spp, bounces = settings.resolution, settings.samples_per_pixel, settings.bounce_limit
    got = {}
    t0 = time.perf_counter()
    with _first_launches(got):
        render(scene, cam, settings, prng_key(0), accel=accel, mesh=mesh)
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0

    gathers = []
    _reset_counts()
    with _timed_gathers(gathers, dev):
        t0 = time.perf_counter()
        film, st = render(scene, cam, settings, prng_key(1), accel=accel, mesh=mesh,
                          return_stats=True)
        per_shard = st["rays_cast_per_shard"].tolist()         # synchronizes
        frame_s = time.perf_counter() - t0
    counts = _read_counts()
    chunks = -(-(w * h * spp // mesh.size) // settings.ray_chunk)
    if counts["wide_shade"][0] != bounces * chunks or counts["lane_take"][0] <= 0:
        raise AssertionError(f"18a rank {rank}: wide_shade {counts['wide_shade'][0]} launches "
                             f"(not {bounces} a chunk of {chunks}), lane_take "
                             f"{counts['lane_take'][0]}")
    _no_plain(counts, f"18a rank {rank}")
    f = _check_film(f"18a rank {rank}", film)
    g_s = sum(g[0] for g in gathers)
    print(f"phase 18a rank {rank} of {mesh.size} (gloo, {dev}): the slice through render(mesh=), "
          f"{w}x{h} x {spp} spp x {bounces} bounces, its {w * h * spp // mesh.size} rays in "
          f"{chunks} chunks: warm-up {warm_s:.4f} s, frame {frame_s:.4f} s; live rays per "
          f"shard {per_shard} (sum {sum(per_shard)}); {len(gathers)} gathers "
          f"{g_s:.4f} s ({', '.join(f'{g[0]:.4f} s: {g[1]} B sent, {g[2]} B gathered' for g in gathers)}); "
          f"launches wide_shade {counts['wide_shade'][0]}, lane_take {counts['lane_take'][0]}, "
          f"plain calls 0; film sha256 {_digest(film)}, std {f.std():.4f} [{gpu}]")
    res = {"frame_s": frame_s, "warm_s": warm_s, "per_shard": per_shard,
           "rays_cast": int(st["rays_cast"]), "digest": _digest(film),
           "launches": {k: counts[k][0] for k in ("wide_shade", "lane_take")},
           "gathers": gathers}
    local = None
    if rank == 0:
        t0 = time.perf_counter()
        local, lst = render(scene, cam, settings, prng_key(1), accel=accel, return_stats=True)
        live = int(lst["rays_cast"])
        local_s = time.perf_counter() - t0
        if not torch.equal(local, film) or live != sum(per_shard):
            raise AssertionError(f"18a: the sharded film != the local film, or rays_cast "
                                 f"{sum(per_shard)} != {live}")
        print(f"phase 18a rank 0: the frame alone (render() with no mesh, the other rank "
              f"idle) {local_s:.4f} s, rays_cast {live} == the sum over shards; the sharded "
              f"film == the local film bit for bit [{gpu}]")
        res["local_s"], res["local_digest"] = local_s, _digest(local)

    def hold():
        args = got["wide_shade"]
        err, ms, plain_ms, _, bound = _compare_hits(
            accel, args[:6], args[6], f"(phase 18a) rank {rank} camera bounce", gpu, exact=True)
        return {"wide_shade": {"err": err, "ms": ms, "plain_ms": plain_ms, "bound": bound,
                               "rays": args[6].shape[0], "live_rays": int(args[6].sum())},
                "lane_take": _hold_take(*got["lane_take"], f"rank {rank} state pack", gpu,
                                        "18a")}

    res.update(_in_turns(mesh, hold))
    del got
    return res, local


def phase_treelet_slice(scene_host, mesh, local, gpu):
    """18b (each rank): the slice through ``render_treelet`` with
    ``TreeletAccels`` (one part a rank, leaf 16): a warm-up frame (its
    first ring hop's ``wide_shade`` launch captured), then the counts set
    to 0 and a timed frame with the hop log; the film against rank 0's
    local film (pixels differing by more than 1e-5 at most
    ``TIE_PIXELS``); the captured launch against the plain version bit for
    bit, one rank at a time."""
    import torch

    from atray_tpu_torch.config import KDTreeConfig
    from atray_tpu_torch.dist.treelet import build_treelet_accels, render_treelet
    from atray_tpu_torch.render.rng import prng_key

    dev, rank = mesh.device, mesh.rank
    settings, cam = _slice_settings()
    (w, h), spp, bounces = settings.resolution, settings.samples_per_pixel, settings.bounce_limit
    t0 = time.perf_counter()
    ta = build_treelet_accels(scene_host, mesh.size, KDTreeConfig(leaf_size=16))
    build_s = time.perf_counter() - t0
    part = ta.local(rank, dev)
    part_mb = sum(getattr(part, k).nbytes for k in ("cboxes", "clinks", "caxis", "tris")) / 1e6
    got = {}
    t0 = time.perf_counter()
    with _first_hop(got):
        render_treelet(scene_host, cam, settings, prng_key(0), mesh, treelets=ta)
    torch.cuda.synchronize(dev)
    warm_s = time.perf_counter() - t0

    hops = []
    _reset_counts()
    t0 = time.perf_counter()
    film, st = render_treelet(scene_host, cam, settings, prng_key(1), mesh, treelets=ta,
                              return_stats=True, hop_log=hops)
    per_shard = st["rays_cast_per_shard"].tolist()
    frame_s = time.perf_counter() - t0
    counts = _read_counts()
    if counts["wide_shade"][0] != bounces * mesh.size or counts["lane_take"][0] <= 0:
        raise AssertionError(f"18b rank {rank}: wide_shade {counts['wide_shade'][0]} launches "
                             f"(not {mesh.size} hops x {bounces} bounces), lane_take "
                             f"{counts['lane_take'][0]}")
    _no_plain(counts, f"18b rank {rank}")
    _check_film(f"18b rank {rank}", film)
    kern = sum(x["kernel_s"] for x in hops)
    xfer = sum(x["transfer_s"] for x in hops)
    print(f"phase 18b rank {rank}: TreeletAccels of the slice mesh, {mesh.size} parts "
          f"(host build {build_s:.4f} s; this rank's part {ta.num_nodes} wide nodes padded, "
          f"{ta.tris.shape[1]} record rows, wide depth {ta.max_depth}, {part_mb:.1f} MB on "
          f"the card): warm-up {warm_s:.4f} s, frame {frame_s:.4f} s (its {len(hops)} hops "
          f"synchronized for the log), live rays per shard {per_shard}; hops: local query "
          f"and merge {kern:.4f} s, transfer {xfer:.4f} s; launches wide_shade "
          f"{counts['wide_shade'][0]}, lane_take {counts['lane_take'][0]}, plain calls 0; film "
          f"sha256 {_digest(film)} [{gpu}]")
    for x in hops:
        print(f"phase 18b rank {rank} hop {x['hop']} ({x['ring']}): {x['rays']} rays, "
              f"{x['bytes'] / 1e6:.1f} MB, query+merge {x['kernel_s']:.4f} s, transfer "
              f"{x['transfer_s']:.4f} s ({x['bytes'] / max(x['transfer_s'], 1e-9) / 1e9:.2f} "
              f"GB/s)")
    res = {"frame_s": frame_s, "warm_s": warm_s, "build_s": build_s, "per_shard": per_shard,
           "digest": _digest(film), "launches": counts["wide_shade"][0], "hops": hops}
    if rank == 0:
        diff = (film - local).abs().amax(dim=2)
        share = float((diff > 1e-5).double().mean())
        print(f"phase 18b the treelet film against the local film: max |diff| "
              f"{float(diff.max()):.3g}, {share:.6f} of pixels differ by more than 1e-5 "
              f"(limit {TIE_PIXELS}: an equal-t tie may pick a coincident face) [{gpu}]")
        if share > TIE_PIXELS:
            raise AssertionError(f"18b: {share} of the treelet film's pixels differ")
        res["max_diff"], res["share"] = float(diff.max()), share

    def hold():
        err, ms, plain_ms, _, bound = _compare_hits(
            part, got["planes"], got["alive"], f"(phase 18b) rank {rank} first ring hop", gpu,
            exact=True, piece=PLAIN_PIECE_HITS)
        print(f"phase 18b rank {rank} first ring hop: wide_shade on its own part, "
              f"{int(got['alive'].sum())} live of {got['alive'].shape[0]} rays, bit-equal to "
              f"the plain version: {ms:.4f} ms, {ms / bound[0]:.2f}x its bound of "
              f"{bound[0]:.4f} ms by {bound[1]} (phase 3's: bytes and the plain version's "
              f"visits) [{gpu}]")
        return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound": bound,
                "rays": got["alive"].shape[0], "live_rays": int(got["alive"].sum())}

    res["wide_shade"] = _in_turns(mesh, hold)
    del got
    return res


def phase_sharded_cli(mesh, out, gpu):
    """18c (each rank): ``examples/cornell.toml`` through ``cli.main`` on
    the two ranks: ``--mesh 2 --nee`` (rank 0 writes the PNG the parent
    holds against the one-rank command's), ``--telemetry 4`` with its
    per-shard row, and ``--treelet --nee`` (the shadow ring, the light
    sphere)."""
    from atray_tpu_torch import cli

    s = cli.load_scene_file(CORNELL)[2]
    rank = mesh.rank
    base = ["render", CORNELL, "--nee", "--dist-backend", "gloo"]
    res = {}
    for name, extra, want in (("mesh", ["--mesh", "2"], 2 * s.bounce_limit),
                              ("telemetry", ["--mesh", "2", "--telemetry", "4"], None),
                              ("treelet", ["--treelet"], 2 * mesh.size * s.bounce_limit)):
        _reset_counts()
        png = os.path.join(out, f"cornell_{name}.png")
        _, lines, sec = _cli(f"18c rank {rank} {name}", base + extra + ["-o", png])
        counts = _read_counts()
        if want is not None and counts["wide_shade"][0] != want:
            raise AssertionError(f"18c rank {rank} {name}: wide_shade {counts['wide_shade'][0]} "
                                 f"launches, not {want}")
        _no_plain(counts, f"18c rank {rank} {name}")
        if rank == 0 and name == "telemetry" and not any(
                line.startswith("shard live rays") for line in lines):
            raise AssertionError("18c: --telemetry printed no per-shard row")
        print(f"phase 18c rank {rank} cornell {' '.join(extra)} --nee: {sec:.4f} s, wide_shade "
              f"{counts['wide_shade'][0]} launches [{gpu}]")
        res[name] = {"s": sec, "wide_shade": counts["wide_shade"][0]}
    return res


def rank_main(argv) -> int:
    """One rank of phase 18 or 19: ``chip_smoke.py --rank R --world N --port
    P --out DIR [--phase 19]``, as ``phase_sharded`` and
    ``phase_sharded_training`` start it. It joins the gloo group over
    127.0.0.1 on cuda:0, runs 18a-18c (or 19a-19c) and writes its numbers
    to DIR/rank<R>.json (DIR/rank<R>_19.json)."""
    import argparse

    import torch

    p = argparse.ArgumentParser(prog="chip_smoke.py --rank")
    for flag in ("--rank", "--world", "--port"):
        p.add_argument(flag, type=int, required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--phase", choices=("18", "19"), default="18")
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke rank: no CUDA device", file=sys.stderr)
        return 2
    import torch.distributed as dist

    from atray_tpu_torch.accel.shaded import build_shaded_accel
    from atray_tpu_torch.config import KDTreeConfig
    from atray_tpu_torch.dist.mesh import make_device_mesh
    from atray_tpu_torch.dist.multihost import init_distributed
    from atray_tpu_torch.kernels import _build

    _build.load()          # built by the parent: loaded from the build directory
    init_distributed(f"tcp://127.0.0.1:{a.port}", a.world, a.rank, backend="gloo")
    try:
        mesh = make_device_mesh(a.world, device="cuda:0")
        gpu = _gpu_line()
        res = {}
        if a.phase == "19":
            res["19a"] = phase_sharded_trainer(mesh, a.out, gpu)
            res.update(phase_treelet_training(mesh, a.out, gpu))
            name = f"rank{a.rank}_19.json"
        else:
            t0 = time.perf_counter()
            scene_host = _slice_scene()
            accel_host = build_shaded_accel(scene_host, KDTreeConfig(leaf_size=16))
            print(f"phase 18 rank {a.rank}: host build of the slice "
                  f"{time.perf_counter() - t0:.2f} s")
            res["18a"], local = phase_sharded_slice(scene_host, accel_host, mesh, gpu)
            res["18b"] = phase_treelet_slice(scene_host, mesh, local, gpu)
            del local
            res["18c"] = phase_sharded_cli(mesh, a.out, gpu)
            name = f"rank{a.rank}.json"
        with open(os.path.join(a.out, name), "w") as fh:
            json.dump(res, fh)
    finally:
        dist.destroy_process_group()
    return 0


def _wait_ranks(procs, logs, timeout):
    """Wait for every rank; kill them all when one fails or at ``timeout``."""
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            bad = [i for i, p in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                why = (f"rank {bad[0]} exited {procs[bad[0]].returncode}" if bad
                       else f"the ranks still ran after {timeout} s")
                tails = "\n".join(f"--- rank {i} ---\n{open(logs[i]).read()[-3000:]}"
                                  for i in range(len(procs)))
                raise AssertionError(f"phase 18: {why}; the logs' ends:\n{tails}")
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, p in enumerate(procs):
        if p.returncode != 0:
            raise AssertionError(f"phase 18: rank {i} exited {p.returncode}:\n"
                                 f"{open(logs[i]).read()[-3000:]}")


def phase_nccl_one_rank(scene, accel, dev, gpu):
    """18d (the parent): a one-rank NCCL group (the backend ``init_distributed``
    picks on the card): the slice through ``render(mesh=)`` equal to the
    local film bit for bit, ``assemble_film`` of its rows and an
    ``all_reduce``, so NCCL's gathers are built and launched. Two ranks on
    one card cannot share NCCL."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from atray_tpu_torch.dist.mesh import make_device_mesh
    from atray_tpu_torch.dist.multihost import assemble_film, host_local_slice, init_distributed
    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.render.wavefront import render

    init_distributed(f"tcp://127.0.0.1:{_free_port()}", 1, 0, device=dev)
    try:
        backend = dist.get_backend()
        mesh = make_device_mesh(1, device=dev)
        settings, cam = _slice_settings()
        local = render(scene, cam, settings, prng_key(1), accel=accel)
        t0 = time.perf_counter()
        film, st = render(scene, cam, settings, prng_key(1), accel=accel, mesh=mesh,
                          return_stats=True)
        per_shard = st["rays_cast_per_shard"].tolist()
        sec = time.perf_counter() - t0
        rows = assemble_film(film[host_local_slice(film.shape[0])])
        x = torch.arange(1024, dtype=torch.float32, device=dev)
        y = x.clone()
        dist.all_reduce(y)
        if backend != "nccl" or not torch.equal(film, local) or not np.array_equal(
                rows, film.cpu().numpy()) or not torch.equal(x, y):
            raise AssertionError(f"18d: backend {backend}; the one-rank mesh's film, "
                                 "assembled rows or all_reduce differ")
        print(f"phase 18d one-rank {backend} group on {dev}: the slice through render(mesh=) "
              f"{sec:.4f} s, rays per shard {per_shard}, == the local film bit for bit; "
              f"assemble_film and all_reduce through NCCL equal their inputs [{gpu}]")
    finally:
        dist.destroy_process_group()


def phase_sharded(scene, accel, dev, gpu):
    """Phase 18; returns each rank's numbers."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()          # the ranks share the card with this process
    with tempfile.TemporaryDirectory() as tmp:
        one = os.path.join(tmp, "cornell_one.png")
        _cli("18c one rank", ["render", CORNELL, "--nee", "-o", one])
        port = _free_port()
        logs = [os.path.join(tmp, f"rank{r}.log") for r in range(RANKS)]
        t0 = time.perf_counter()
        procs = []
        for r in range(RANKS):
            with open(logs[r], "w") as fh:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--world",
                     str(RANKS), "--port", str(port), "--out", tmp],
                    cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT))
        _wait_ranks(procs, logs, RANK_TIMEOUT_S)
        ranks_s = time.perf_counter() - t0
        for r in range(RANKS):
            for line in open(logs[r]).read().splitlines():
                if line.startswith("phase "):
                    print(line)
        res = []
        for r in range(RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as fh:
                res.append(json.load(fh))
        a0 = res[0]["18a"]
        if any(x["18a"]["digest"] != a0["local_digest"] or x["18a"]["per_shard"] != a0["per_shard"]
               or x["18b"]["digest"] != res[0]["18b"]["digest"] for x in res):
            raise AssertionError("phase 18: the ranks' films or shard counts differ")
        png = open(os.path.join(tmp, "cornell_mesh.png"), "rb").read()
        if png != open(one, "rb").read():
            raise AssertionError("18c: the --mesh 2 PNG != the one-rank command's")
        print(f"phase 18 ranks: {RANKS} processes on one card over gloo (NCCL refuses two "
              f"ranks on one device) in {ranks_s:.2f} s; every rank's slice film == the local "
              f"film (sha256 {a0['local_digest']}), sum of live rays per shard "
              f"{sum(a0['per_shard'])} == the local rays_cast; the treelet films equal on every "
              f"rank; cornell --mesh 2 --nee PNG == the one-rank command's byte for byte [{gpu}]")

        t0 = time.perf_counter()
        run = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
             str(RANKS), "-m", "atray_tpu_torch.cli", "render", CORNELL, "--nee", "--mesh",
             str(RANKS), "--dist-backend", "gloo", "-o", os.path.join(tmp, "torchrun.png")],
            cwd=ROOT, capture_output=True, text=True, timeout=TORCHRUN_TIMEOUT_S)
        sec = time.perf_counter() - t0
        if run.returncode != 0 or open(os.path.join(tmp, "torchrun.png"), "rb").read() != png:
            raise AssertionError(f"18c: torchrun exited {run.returncode} or its PNG differs: "
                                 f"{run.stdout[-2000:]} {run.stderr[-3000:]}")
        for line in run.stderr.splitlines():
            if line.startswith(("device mesh", "scene:", "render ")):
                print(f"phase 18c torchrun | {line}")
        print(f"phase 18c torchrun --standalone --nproc-per-node {RANKS} -m atray_tpu_torch.cli "
              f"render examples/cornell.toml --nee --mesh {RANKS} --dist-backend gloo: exit 0 in "
              f"{sec:.2f} s (two processes, each loading the kernels' library), its PNG == the "
              f"one-rank command's byte for byte [{gpu}]")
    phase_nccl_one_rank(scene, accel, dev, gpu)
    print(f"phase 18 sharded serving path: {time.perf_counter() - t_phase:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 19: the sharded training half, two ranks on one card
# ---------------------------------------------------------------------------

SHARD_TRAIN_RES = 128         # 19a: 16 views x 128x128 = 262,144 rays, 131,072 a rank
TREELET_RES = 64              # 19b-c: 16 views x 64x64 = 65,536 rays, 32,768 a rank
# 19b-c trace 3 bounces: the port compacts (lane_take, lane_scatter in the
# backward) after the first diffuse bounce only when another one follows
TREELET_BOUNCES = 3
EXAMPLE_ARGS = ["--views", "16", "--tris", "139000", "--res", "64", "--steps", "20"]
EXAMPLE_TIMEOUT_S = 300


@contextlib.contextmanager
def _spy_first(mod, name, got):
    """While the block runs, keep ``mod.name``'s first call's arguments
    (its accel as it is, its tensors cloned) under ``got[name]``."""
    import torch

    real = getattr(mod, name)

    def spy(*args, **kw):
        got.setdefault(name, [a.clone() if isinstance(a, torch.Tensor) else a for a in args])
        return real(*args, **kw)

    setattr(mod, name, spy)
    try:
        yield
    finally:
        setattr(mod, name, real)


@contextlib.contextmanager
def _timed_reduces(into, dev):
    """While the block runs, time every ``torch.distributed.all_reduce`` (a
    device synchronize on each side) and append (seconds, bytes)."""
    import torch
    import torch.distributed as dist

    real = dist.all_reduce

    def spy(x, *args, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = real(x, *args, **kw)
        torch.cuda.synchronize(dev)
        into.append((time.perf_counter() - t0, x.nbytes))
        return out

    dist.all_reduce = spy
    try:
        yield
    finally:
        dist.all_reduce = real


def _exact_bits(accel, o, d, label, gpu, phase):
    """``_exact_compare`` (phase 7's rules, times, bound), then every ray's
    t, u, v and id against the plain version bit for bit."""
    import torch

    from atray_tpu_torch.kernels.wide_exact import wide_exact_first_hit, wide_exact_ref

    out = _exact_compare(accel, o, d, label, gpu, phase=phase)
    got, want = wide_exact_first_hit(accel, o, d), wide_exact_ref(accel, o, d)
    diff = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum()) for a, b in zip(got, want))
    if diff:
        raise AssertionError(f"wide_exact {label}: {diff} words differ from the plain version")
    print(f"phase {phase} wide_exact {label}: t, u, v and id bit-equal to the plain version on "
          f"all {o.shape[0]} rays [{gpu}]")
    return out


def _digest_params(p) -> str:
    import hashlib

    h = hashlib.sha256()
    for x in (p.albedo, p.vertices):
        h.update(x.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def phase_sharded_trainer(mesh, out, gpu):
    """19a (each rank): the trainer of phase 9 at 16 views x 128x128 with
    ``make_train_step(mesh=)``: step 1's loss and gradients by
    ``make_loss_and_grad(mesh=)`` (rank 0 saves them for the parent), then
    the counts set to 0 and 4 steps on the ``make_accel`` ``WideBVH`` and 2
    on the ``ShadedWideBVH``, both refit, each step's seconds and its
    ``all_reduce``'s seconds and bytes, the parameters' digest after every
    step; the first ``wide_exact`` and ``wide_shade`` launches of the
    steps, captured, held bit for bit against the plain versions, the
    ranks in turn."""
    import numpy as np
    import torch

    from atray_tpu_torch.accel.shaded import build_shaded_accel
    from atray_tpu_torch.accel.wide import make_accel
    from atray_tpu_torch.config import KDTreeConfig
    from atray_tpu_torch.dist.train import make_loss_and_grad
    from atray_tpu_torch.render import wavefront
    from atray_tpu_torch.render.rng import fold_in, prng_key

    dev, rank = mesh.device, mesh.rank
    t0 = time.perf_counter()
    scene_host = _trainer_scene()
    wide_host = make_accel(scene_host.mesh.vertices, scene_host.mesh.faces,
                           KDTreeConfig(leaf_size=16))
    shaded = build_shaded_accel(scene_host, KDTreeConfig(leaf_size=16))
    build_s = time.perf_counter() - t0
    orig, dirn = _trainer_rays(dev, SHARD_TRAIN_RES)
    scene, _, p, target, steps = _trainer(
        scene_host, {"make_accel": wide_host, "shaded accel": shaded}, orig, dirn, dev, mesh)
    loss0, g0 = make_loss_and_grad(scene_host, 2, accel=wide_host, refit=True, device=dev,
                                   mesh=mesh)(p, orig, dirn, target, fold_in(prng_key(0), 0))
    if rank == 0:
        np.savez(os.path.join(out, "19a_step1.npz"), loss=loss0.cpu().numpy(),
                 albedo=g0.albedo.cpu().numpy(), vertices=g0.vertices.cpu().numpy())
    plan = ["make_accel"] * 4 + ["shaded accel"] * 2
    got, reduces, losses, secs, digests = {}, [], [], [], []
    _reset_counts()
    with _timed_reduces(reduces, dev):
        for s, name in enumerate(plan):
            spy = (_spy_first(wavefront, "wide_exact_first_hit", got) if name == "make_accel"
                   else _spy_first(wavefront, "wide_shade_planes", got))
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            with spy:
                losses.append(float(steps[name](p, orig, dirn, target, fold_in(prng_key(0), s))))
            secs.append(time.perf_counter() - t0)
            digests.append(_digest_params(p))
    counts = _read_counts()
    if counts["wide_exact"][0] < 4 * 2 or counts["wide_shade"][0] < 2 * 2:
        raise AssertionError(f"19a rank {rank}: launches {counts}")
    _no_plain(counts, f"19a rank {rank}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"19a rank {rank}: the loss did not fall: {losses}")
    print(f"phase 19a rank {rank} of {mesh.size} (gloo, {dev}): make_train_step(mesh=) on "
          f"dragon_proxy(139_000), 16 views x {SHARD_TRAIN_RES}x{SHARD_TRAIN_RES} = "
          f"{orig.shape[0]} rays ({orig.shape[0] // mesh.size} a rank), 2 bounces, refit=True "
          f"(host builds {build_s:.2f} s); losses {', '.join(f'{x:.6g}' for x in losses)} "
          f"[{gpu}]")
    print(f"phase 19a rank {rank} step seconds: make_accel "
          f"{', '.join(f'{x:.4f}' for x in secs[:4])}; shaded accel "
          f"{', '.join(f'{x:.4f}' for x in secs[4:])}; all_reduce a step "
          f"{', '.join(f'{r[0]:.4f}' for r in reduces)} s of {reduces[0][1]} B; launches "
          f"wide_exact {counts['wide_exact'][0]}, wide_shade {counts['wide_shade'][0]}, plain "
          f"calls 0; parameter digests {' '.join(digests)} [{gpu}]")
    res = {"losses": losses, "secs": secs, "reduces": reduces, "digests": digests,
           "launches": {k: counts[k][0] for k in ("wide_exact", "wide_shade")},
           "loss0": float(loss0)}

    def hold():
        acc, o, d = got["wide_exact_first_hit"]
        ex = _exact_bits(acc, o, d, f"(phase 19a) rank {rank} first make_accel step's camera "
                         "bounce", gpu, "19a")
        args = got["wide_shade_planes"]
        ws = _compare_hits(args[0], args[1:7], args[7],
                           f"(phase 19a) rank {rank} first shaded step's camera bounce", gpu,
                           exact=True)
        return {"wide_exact": {"err": ex[0], "ms": ex[1], "plain_ms": ex[2], "bound": ex[3],
                               "rays": int(o.shape[0])},
                "wide_shade": {"err": ws[0], "ms": ws[1], "plain_ms": ws[2], "bound": ws[4],
                               "rays": int(args[7].shape[0]), "live_rays": int(args[7].sum())}}

    res.update(_in_turns(mesh, hold))
    del got
    return res


def _treelet_views():
    """19b-c's 16 orbit cameras (phase 9's views) and their settings:
    ``TREELET_RES`` square, 1 spp, ``TREELET_BOUNCES``, the defaults (sort
    and lane pack on)."""
    import numpy as np

    from atray_tpu_torch.config import RenderSettings
    from atray_tpu_torch.core.camera import look_at_camera

    cams = []
    for v in range(TRAIN_VIEWS):
        ang = 2 * np.pi * v / TRAIN_VIEWS
        cams.append(look_at_camera((2.5 * np.sin(ang), 0.8, -4 + 2.5 * np.cos(ang)),
                                   (0, 0, -4), h_fov=0.8, aspect=1.0))
    return cams, RenderSettings(resolution=(TREELET_RES, TREELET_RES), samples_per_pixel=1,
                                bounce_limit=TREELET_BOUNCES)


def _leaf_grads(loss, leaves):
    import torch

    g = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(x) if y is None else y for x, y in zip(leaves, g)]


def _hop_lines(label, rank, hops, n_fwd, gpu):
    """One line a ring and direction: hops, bytes a hop, the local work's
    and the transfers' seconds and rate. Returns the same numbers."""
    kinds = {}
    for i, h in enumerate(hops):
        k = kinds.setdefault(("backward " if i >= n_fwd else "forward ") + h["ring"],
                             {"hops": 0, "bytes": 0, "kernel_s": 0.0, "transfer_s": 0.0})
        k["hops"] += 1
        k["bytes"] += h["bytes"]
        k["kernel_s"] += h["kernel_s"]
        k["transfer_s"] += h["transfer_s"]
    for key, k in kinds.items():
        print(f"phase {label} rank {rank} {key} hops: {k['hops']}, {k['bytes']} B in all "
              f"({k['bytes'] // k['hops']} B a hop), local work {k['kernel_s']:.4f} s, transfer "
              f"{k['transfer_s']:.4f} s ({k['bytes'] / max(k['transfer_s'], 1e-9) / 1e9:.3f} "
              f"GB/s) [{gpu}]")
    return kinds


def phase_treelet_training(mesh, out, gpu):
    """19b and 19c (each rank): the differentiable treelet renders of the
    trainer's dragon in 2 parts, over 16 views, forward and backward with
    the counts set to 0 and the hop log on: ``TreeletParts`` (all five
    leaves, summed by ``reduce_grads``) and ``TreeletShards`` (this rank's
    vertex and normal slices, gathered and merged on rank 0); the films and
    gradients go to the parent; the first ``lane_take`` and ``lane_scatter``
    launches held bit for bit against the plain versions, the ranks in
    turn."""
    import numpy as np
    import torch

    from atray_tpu_torch.dist.mesh import gather_rows
    from atray_tpu_torch.dist.train import reduce_grads
    from atray_tpu_torch.dist.treelet import (
        build_treelet_parts,
        build_treelet_shards,
        merge_normal_grads,
        merge_vertex_grads,
        render_treelet,
    )
    from atray_tpu_torch.kernels import lane_pack
    from atray_tpu_torch.render import wavefront
    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.scene.data import SceneParams

    dev, rank = mesh.device, mesh.rank
    scene_host = _trainer_scene()
    scene = scene_host.to(dev)
    cams, settings = _treelet_views()
    res = {}
    for label, name in (("19b", "TreeletParts"), ("19c", "TreeletShards")):
        t0 = time.perf_counter()
        if name == "TreeletParts":
            tl = build_treelet_parts(scene_host, mesh.size)
            p = SceneParams(*(x.clone().requires_grad_() for x in scene.params().leaves()))
            traced, leaves = scene.with_params(p), list(p.leaves())
            part_b = tl.idx[rank].nbytes + tl.owner.nbytes + tl.lrow.nbytes
        else:
            host = build_treelet_shards(scene_host, mesh.size)
            tl = host.local(rank, dev)
            leaves = [tl.vertices.requires_grad_(), tl.normals.requires_grad_()]
            traced = scene
            part_b = sum(getattr(tl, f.name).nbytes for f in dataclasses.fields(tl)
                         if isinstance(getattr(tl, f.name), torch.Tensor))
        build_s = time.perf_counter() - t0
        got, hops = {}, []
        torch.cuda.synchronize(dev)
        _reset_counts()
        t0 = time.perf_counter()
        with _spy_first(lane_pack, "lane_scatter", got), _first_launches(got):
            films = [render_treelet(traced, cam, settings, prng_key(v), mesh, treelets=tl,
                                    hop_log=hops) for v, cam in enumerate(cams)]
            torch.cuda.synchronize(dev)
            fwd_s = time.perf_counter() - t0
            n_fwd = len(hops)
            g = _leaf_grads(sum(f.sum() for f in films), leaves)
            torch.cuda.synchronize(dev)
        bwd_s = time.perf_counter() - t0 - fwd_s
        counts = _read_counts()
        for k in ("lane_take", "lane_scatter"):
            if counts[k][0] <= 0:
                raise AssertionError(f"{label} rank {rank}: {k} did not launch: {counts}")
        _no_plain(counts, f"{label} rank {rank}")
        if any(h["ring"] != "pickup" or not h["reverse"] for h in hops[n_fwd:]) or \
                len(hops) == n_fwd or any(h["reverse"] for h in hops[:n_fwd]):
            raise AssertionError(f"{label} rank {rank}: the backward ran hops other than the "
                                 f"reverse pickup ring: {[h['ring'] for h in hops[n_fwd:]]}")
        t1 = time.perf_counter()
        if name == "TreeletParts":
            g = reduce_grads(g, mesh)
            saved = {f"g{i}": x.cpu().numpy() for i, x in enumerate(g)}
        else:
            gv, gn = (gather_rows(x[None], mesh) for x in g)
            saved = {"g0": merge_vertex_grads(host, gv, int(scene_host.mesh.num_vertices)
                                              ).cpu().numpy(),
                     "g1": merge_normal_grads(host, gn, scene_host.mesh.normals.shape[0]
                                              ).cpu().numpy()}
        red_s = time.perf_counter() - t1
        films = torch.stack([f.detach() for f in films]).cpu().numpy()
        if rank == 0:
            np.savez(os.path.join(out, f"{label}.npz"), films=films, **saved)
        print(f"phase {label} rank {rank}: {name} of dragon_proxy(139_000) in {mesh.size} parts "
              f"(host build {build_s:.4f} s; this rank's tables on the card {part_b} B), 16 "
              f"views x {TREELET_RES}x{TREELET_RES} x {TREELET_BOUNCES} bounces "
              f"({len(cams) * TREELET_RES ** 2 // mesh.size} rays a rank): forward {fwd_s:.4f} s, "
              f"backward {bwd_s:.4f} s, gradient reduction {red_s:.4f} s; launches lane_take "
              f"{counts['lane_take'][0]}, lane_scatter {counts['lane_scatter'][0]}, plain calls "
              f"0 [{gpu}]")
        kinds = _hop_lines(label, rank, hops, n_fwd, gpu)
        for h in hops[:4] + hops[n_fwd:n_fwd + 2]:
            print(f"phase {label} rank {rank} {'backward' if h['reverse'] else 'forward'} "
                  f"{h['ring']} hop {h['hop']}: {h['rays']} rays, {h['bytes']} B, local work "
                  f"{h['kernel_s']:.5f} s, transfer {h['transfer_s']:.5f} s")

        def hold():
            take = _hold_take(*got["lane_take"], f"rank {rank} {name} state pack", gpu, label)
            cols, dst = got["lane_scatter"]
            sc = _scatter_case(cols, dst, f"(phase {label}) rank {rank} {name} backward", gpu)
            return {"lane_take": take, "lane_scatter": {
                "ms": sc[0], "plain_ms": sc[1], "library_ms": sc[2], "bound": sc[3],
                "err": sc[4], "rays": int(dst.shape[0])}}

        res[label] = {"fwd_s": fwd_s, "bwd_s": bwd_s, "red_s": red_s, "part_bytes": part_b,
                      "hops": kinds, "launches": {k: counts[k][0] for k in
                                                  ("lane_take", "lane_scatter")},
                      **_in_turns(mesh, hold)}
        del got, films, g, leaves, traced
    return res


def _replicated_views(scene_host, dev):
    """The replicated brute-force films of 19b-c's views (``render`` with
    no accel) and the gradients of their sum with respect to all five
    leaves."""
    import torch

    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.render.wavefront import render
    from atray_tpu_torch.scene.data import SceneParams

    cams, settings = _treelet_views()
    scene = scene_host.to(dev)
    p = SceneParams(*(x.clone().requires_grad_() for x in scene.params().leaves()))
    sc = scene.with_params(p)
    films = [render(sc, cam, settings, prng_key(v), device=dev) for v, cam in enumerate(cams)]
    g = _leaf_grads(sum(f.sum() for f in films), list(p.leaves()))
    return (torch.stack([f.detach() for f in films]).cpu().numpy(),
            [x.cpu().numpy() for x in g])


def _film_ties(label, got, want, gpu):
    import numpy as np

    diff = np.abs(got - want).max(axis=-1)
    share = float((diff > 1e-5).mean())
    print(f"phase {label} the films of the 16 views against the replicated brute-force "
          f"render's: max |diff| {float(diff.max()):.3g}, {share:.6f} of pixels differ by more "
          f"than 1e-5 (limit {TIE_PIXELS}: an equal-t tie) [{gpu}]")
    if share > TIE_PIXELS:
        raise AssertionError(f"{label}: {share} of the films' pixels differ")


def phase_example_torchrun(gpu):
    """19d: ``examples/inverse_render.py``'s port under ``torchrun
    --standalone --nproc-per-node 2`` on the one card (gloo): its step
    lines, its last loss below its first, its Mray-steps/s line."""
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
         str(RANKS), "-m", "atray_tpu_torch.examples.inverse_render", "--dist-backend", "gloo"]
        + EXAMPLE_ARGS, cwd=ROOT, capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT_S)
    sec = time.perf_counter() - t0
    lines = run.stdout.splitlines()
    steps = [x for x in lines if x.startswith("step")]
    if run.returncode != 0 or len(steps) < 2:
        raise AssertionError(f"19d: torchrun exited {run.returncode}: {run.stdout[-2000:]} "
                             f"{run.stderr[-3000:]}")
    first, last = (float(x.split("loss")[1].split()[0]) for x in (steps[0], steps[-1]))
    for x in lines:
        print(f"phase 19d torchrun | {x}")
    print(f"phase 19d torchrun --standalone --nproc-per-node {RANKS} -m "
          f"atray_tpu_torch.examples.inverse_render --dist-backend gloo {' '.join(EXAMPLE_ARGS)}: "
          f"exit 0 in {sec:.2f} s, loss {first:.4g} -> {last:.4g} [{gpu}]")
    if not last < first:
        raise AssertionError(f"19d: the example's loss did not fall: {steps}")
    return {"s": sec, "first": first, "last": last}


def phase_nccl_train_step(dev, gpu):
    """19e (the parent): in a one-rank NCCL group, one ``make_train_step``
    step with ``mesh=`` (its gradients through NCCL's ``all_reduce``) equal
    to the step without a mesh bit for bit, on phase 9's rays."""
    import torch
    import torch.distributed as dist

    from atray_tpu_torch.accel.wide import make_accel
    from atray_tpu_torch.config import KDTreeConfig
    from atray_tpu_torch.dist.mesh import make_device_mesh
    from atray_tpu_torch.dist.multihost import init_distributed
    from atray_tpu_torch.render.rng import fold_in, prng_key

    scene_host = _trainer_scene()
    wide_host = make_accel(scene_host.mesh.vertices, scene_host.mesh.faces,
                           KDTreeConfig(leaf_size=16))
    orig, dirn = _trainer_rays(dev)
    init_distributed(f"tcp://127.0.0.1:{_free_port()}", 1, 0, device=dev)
    try:
        backend = dist.get_backend()
        mesh = make_device_mesh(1, device=dev)
        out = []
        # the gradient's index_add_ (index_select's backward) sums in the
        # order of its atomics unless PyTorch is asked for its
        # deterministic algorithms: then two steps on the same inputs agree
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for m in (None, mesh):
                _, _, p, target, steps = _trainer(scene_host, {"make_accel": wide_host}, orig,
                                                  dirn, dev, m)
                loss = steps["make_accel"](p, orig, dirn, target, fold_in(prng_key(0), 0))
                out.append((float(loss), p))
        finally:
            torch.use_deterministic_algorithms(False)
        (l0, p0), (l1, p1) = out
        same = l0 == l1 and all(torch.equal(a, b) for a, b in zip(p0.leaves(), p1.leaves()))
        if backend != "nccl" or not same:
            raise AssertionError(f"19e: backend {backend}; the one-rank mesh step differs from "
                                 "the step without a mesh")
        print(f"phase 19e one-rank {backend} group on {dev}: one make_train_step(mesh=) step on "
              f"{orig.shape[0]} rays (gradients through NCCL's all_reduce) == the step without a "
              f"mesh bit for bit (loss {l1:.6g}, albedo and vertices) [{gpu}]")
    finally:
        dist.destroy_process_group()


def _spawn_ranks(phase, tmp, timeout):
    """``chip_smoke.py --rank R --world RANKS --port P --out tmp --phase
    phase`` for each rank; their ``phase`` lines printed; returns each
    rank's json and the seconds."""
    port = _free_port()
    logs = [os.path.join(tmp, f"rank{r}_{phase}.log") for r in range(RANKS)]
    t0 = time.perf_counter()
    procs = []
    for r in range(RANKS):
        with open(logs[r], "w") as fh:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank", str(r), "--world",
                 str(RANKS), "--port", str(port), "--out", tmp, "--phase", phase],
                cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT))
    _wait_ranks(procs, logs, timeout)
    sec = time.perf_counter() - t0
    for r in range(RANKS):
        for line in open(logs[r]).read().splitlines():
            if line.startswith("phase "):
                print(line)
    res = []
    for r in range(RANKS):
        with open(os.path.join(tmp, f"rank{r}_{phase}.json")) as fh:
            res.append(json.load(fh))
    return res, sec


def phase_sharded_training(dev, gpu):
    """Phase 19; returns each rank's numbers."""
    import tempfile

    import numpy as np
    import torch

    from atray_tpu_torch.dist.train import make_loss_and_grad
    from atray_tpu_torch.render.rng import fold_in, prng_key

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        res, ranks_s = _spawn_ranks("19", tmp, RANK_TIMEOUT_S)
        if any(x["19a"]["digests"] != res[0]["19a"]["digests"] for x in res):
            raise AssertionError("19a: the ranks' parameters differ after a step")
        print(f"phase 19 ranks: {RANKS} processes on one card over gloo in {ranks_s:.2f} s; the "
              f"parameters equal bit for bit on every rank after each of the 6 steps [{gpu}]")
        # 19a: step 1 on one rank, at the same rays, target and parameters
        from atray_tpu_torch.accel.wide import make_accel
        from atray_tpu_torch.config import KDTreeConfig

        scene_host = _trainer_scene()
        wide_host = make_accel(scene_host.mesh.vertices, scene_host.mesh.faces,
                               KDTreeConfig(leaf_size=16))
        orig, dirn = _trainer_rays(dev, SHARD_TRAIN_RES)
        _, _, p, target, _ = _trainer(scene_host, {"make_accel": wide_host}, orig, dirn, dev)
        t0 = time.perf_counter()
        loss1, g1 = make_loss_and_grad(scene_host, 2, accel=wide_host, refit=True, device=dev)(
            p, orig, dirn, target, fold_in(prng_key(0), 0))
        one_s = time.perf_counter() - t0
        z = np.load(os.path.join(tmp, "19a_step1.npz"))
        if abs(float(z["loss"]) - float(loss1)) > 1e-5 * abs(float(loss1)):
            raise AssertionError(f"19a: sharded loss {float(z['loss'])} != one rank's "
                                 f"{float(loss1)}")
        worst = _hold_grads("19a step 1", ("albedo", "vertices"), (z["albedo"], z["vertices"]),
                            (g1.albedo.cpu().numpy(), g1.vertices.cpu().numpy()))
        print(f"phase 19a step 1 on 2 ranks against one rank's make_loss_and_grad ({one_s:.4f} s "
              f"with the refit, first call): loss {float(z['loss']):.8g} vs {float(loss1):.8g}; "
              f"max |diff| / max |g|: {worst} [{gpu}]")
        del p, target, orig, dirn, g1
        # 19b-c: the replicated brute-force films and gradients
        t0 = time.perf_counter()
        films, grads = _replicated_views(scene_host, dev)
        rep_s = time.perf_counter() - t0
        names = ("vertices", "normals", "emission", "albedo", "scatter")
        for label, keep in (("19b", 5), ("19c", 2)):
            z = np.load(os.path.join(tmp, f"{label}.npz"))
            _film_ties(label, z["films"], films, gpu)
            worst = _hold_grads(label, names[:keep], [z[f"g{i}"] for i in range(keep)],
                                grads[:keep])
            print(f"phase {label} gradients against the replicated brute-force render's "
                  f"({rep_s:.4f} s, one rank){' after merge_*_grads' if keep == 2 else ''}: max "
                  f"|diff| / max |g|: {worst} [{gpu}]")
        print(f"phase 19a-c ranks and references: {time.perf_counter() - t_phase:.1f} s")
    example = phase_example_torchrun(gpu)
    phase_nccl_train_step(dev, gpu)
    print(f"phase 19 sharded training path: {time.perf_counter() - t_phase:.1f} s")
    return res, example


def _entry(name, source, replaces, launches, err, ms, plain_ms, bound, library_ms, **rays):
    """One entry of the ``kernels`` line; the lineage walks add ``rays``
    (the rays of ``ms`` and ``bound_ms``) and ``plain_rays`` (of
    ``plain_ms``), since their timed set is cut, and ``warp_bound_ms``
    (the bound from the warp's own work); the
    probes add the ``variant`` timed and, for one-block kernels,
    ``one_sm_bound_ms`` (P1-P5) or ``issue_bound_ms`` (P6-P9: the busiest
    warp's instructions over one scheduler's issue rate), P11
    ``design_bound_ms`` (the bytes its design moves), P10
    ``sector_bound_ms`` (the 32-byte sectors its map touches), P6, P7 and
    P10 ``device_ms`` (the device time of a launch, ``_timing.device_ms``)."""
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
    shadow = phase_oracle_slice(dev, gpu)
    gather = phase_output_slice(dev, gpu)
    host = phase_host_surfaces(dev, gpu)
    sharded = phase_sharded(scene, accel, dev, gpu)
    # rank 1 traces the frame's lower half (the floor and most of the
    # dragon); rank 0's camera bounce is sky, its first pack empty
    sa, sb = sharded[1]["18a"], sharded[1]["18b"]
    training, _ = phase_sharded_training(dev, gpu)
    ta, tb, tc = (training[1][k] for k in ("19a", "19b", "19c"))

    lt_ms, lt_plain, lt_lib = lt[(14, 4_147_200, "pack")]
    n_chunk = 4_147_200
    ls_ms, ls_plain, ls_lib, ls_bound, _ = ls[(12, 2_073_600, "pack")]
    ls_err = max(v[4] for v in ls.values())
    print(json.dumps({"kernels": [
        _entry("wide_shade", "atray_tpu_torch/csrc/wide_shade.cu",
               "atray_tpu/kernels/wide_shade.py:43", counts["wide_shade"][0], ws_err,
               ws_ms, ws_plain, ws_bound, None),
        _entry("wide_shade (NEE shadow rays)", "atray_tpu_torch/csrc/wide_shade.cu",
               "atray_tpu/kernels/wide_shade.py:43", shadow["launches"], shadow["err"],
               shadow["ms"], shadow["plain_ms"], shadow["bound"], None, rays=shadow["rays"],
               live_rays=shadow["live_rays"]),
        _entry("wide_shade (gather path)", "atray_tpu_torch/csrc/wide_shade.cu",
               "atray_tpu/kernels/wide_shade.py:43", gather["launches"], gather["err"],
               gather["ms"], gather["plain_ms"], gather["bound"], None, rays=gather["rays"],
               live_rays=gather["live_rays"]),
        _entry("wide_shade (command line, ladder config 3)", "atray_tpu_torch/csrc/wide_shade.cu",
               "atray_tpu/kernels/wide_shade.py:43", host["wide_shade"]["launches"],
               host["wide_shade"]["err"], host["wide_shade"]["ms"],
               host["wide_shade"]["plain_ms"], host["wide_shade"]["bound"], None,
               rays=host["wide_shade"]["rays"], live_rays=host["wide_shade"]["live_rays"]),
        _entry("wide_shade (ray-sharded slice, rank 1 of 2)", "atray_tpu_torch/csrc/wide_shade.cu",
               "atray_tpu/kernels/wide_shade.py:43", sa["launches"]["wide_shade"],
               sa["wide_shade"]["err"], sa["wide_shade"]["ms"], sa["wide_shade"]["plain_ms"],
               sa["wide_shade"]["bound"], None, rays=sa["wide_shade"]["rays"],
               live_rays=sa["wide_shade"]["live_rays"]),
        _entry("wide_shade (treelet ring hop, rank 1 of 2)", "atray_tpu_torch/csrc/wide_shade.cu",
               "atray_tpu/kernels/wide_shade.py:43", sb["launches"], sb["wide_shade"]["err"],
               sb["wide_shade"]["ms"], sb["wide_shade"]["plain_ms"], sb["wide_shade"]["bound"],
               None, rays=sb["wide_shade"]["rays"], live_rays=sb["wide_shade"]["live_rays"]),
        _entry("wide_shade (sharded trainer, shaded accel, rank 1 of 2)",
               "atray_tpu_torch/csrc/wide_shade.cu", "atray_tpu/kernels/wide_shade.py:43",
               ta["launches"]["wide_shade"], ta["wide_shade"]["err"], ta["wide_shade"]["ms"],
               ta["wide_shade"]["plain_ms"], ta["wide_shade"]["bound"], None,
               rays=ta["wide_shade"]["rays"], live_rays=ta["wide_shade"]["live_rays"]),
        _entry("lane_take", "atray_tpu_torch/csrc/lane_take.cu",
               "atray_tpu/kernels/lane_pack.py:202", counts["lane_take"][0], 0.0,
               lt_ms, lt_plain, _bound((2 * 14 + 1) * 4 * n_chunk), lt_lib),
        _entry("lane_take (command line, ladder config 3)", "atray_tpu_torch/csrc/lane_take.cu",
               "atray_tpu/kernels/lane_pack.py:202", host["lane_take"]["launches"], 0.0,
               host["lane_take"]["ms"], host["lane_take"]["plain_ms"], host["lane_take"]["bound"],
               host["lane_take"]["library_ms"], rays=host["lane_take"]["rays"]),
        _entry("lane_take (ray-sharded slice, rank 1 of 2)", "atray_tpu_torch/csrc/lane_take.cu",
               "atray_tpu/kernels/lane_pack.py:202", sa["launches"]["lane_take"], 0.0,
               sa["lane_take"]["ms"], sa["lane_take"]["plain_ms"], sa["lane_take"]["bound"],
               sa["lane_take"]["library_ms"], rays=sa["lane_take"]["rays"]),
        _entry("lane_take (TreeletParts gradient, rank 1 of 2)", "atray_tpu_torch/csrc/lane_take.cu",
               "atray_tpu/kernels/lane_pack.py:202", tb["launches"]["lane_take"], 0.0,
               tb["lane_take"]["ms"], tb["lane_take"]["plain_ms"], tb["lane_take"]["bound"],
               tb["lane_take"]["library_ms"], rays=tb["lane_take"]["rays"]),
        _entry("lane_take (TreeletShards gradient, rank 1 of 2)", "atray_tpu_torch/csrc/lane_take.cu",
               "atray_tpu/kernels/lane_pack.py:202", tc["launches"]["lane_take"], 0.0,
               tc["lane_take"]["ms"], tc["lane_take"]["plain_ms"], tc["lane_take"]["bound"],
               tc["lane_take"]["library_ms"], rays=tc["lane_take"]["rays"]),
        _entry("lane_scatter", "atray_tpu_torch/csrc/lane_scatter.cu",
               "atray_tpu/kernels/lane_pack.py:632", g_counts["lane_scatter"][0], ls_err,
               ls_ms, ls_plain, ls_bound, ls_lib),
        _entry("lane_scatter (TreeletParts gradient, rank 1 of 2)", "atray_tpu_torch/csrc/lane_scatter.cu",
               "atray_tpu/kernels/lane_pack.py:632", tb["launches"]["lane_scatter"],
               tb["lane_scatter"]["err"], tb["lane_scatter"]["ms"],
               tb["lane_scatter"]["plain_ms"], tb["lane_scatter"]["bound"],
               tb["lane_scatter"]["library_ms"], rays=tb["lane_scatter"]["rays"]),
        _entry("lane_scatter (TreeletShards gradient, rank 1 of 2)", "atray_tpu_torch/csrc/lane_scatter.cu",
               "atray_tpu/kernels/lane_pack.py:632", tc["launches"]["lane_scatter"],
               tc["lane_scatter"]["err"], tc["lane_scatter"]["ms"],
               tc["lane_scatter"]["plain_ms"], tc["lane_scatter"]["bound"],
               tc["lane_scatter"]["library_ms"], rays=tc["lane_scatter"]["rays"]),
        _entry("wide_exact", "atray_tpu_torch/csrc/wide_exact.cu",
               "atray_tpu/kernels/wide_exact.py:46", t_counts["wide_exact"][0],
               max(we_err, t_err, lineage["wide_exact_err"]),
               we_ms, we_plain, we_bound, None),
        _entry("wide_exact (sharded trainer, make_accel, rank 1 of 2)",
               "atray_tpu_torch/csrc/wide_exact.cu", "atray_tpu/kernels/wide_exact.py:46",
               ta["launches"]["wide_exact"], ta["wide_exact"]["err"], ta["wide_exact"]["ms"],
               ta["wide_exact"]["plain_ms"], ta["wide_exact"]["bound"], None,
               rays=ta["wide_exact"]["rays"]),
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
               **({"issue_bound_ms": probes[name]["t"].issue_bound_ms}
                  if probes[name]["t"].issue_bound_ms is not None else
                  {"one_sm_bound_ms": probes[name]["t"].bound_ms * 132}
                  if probes[name]["t"].one_block else {}),
               **({"design_bound_ms": probes[name]["design_bound"][0]}
                  if "design_bound" in probes[name] else {}),
               **({"sector_bound_ms": probes[name]["t"].sector_bound_ms}
                  if probes[name]["t"].sector_bound_ms is not None else {}),
               **({"device_ms": probes[name]["device_ms"]}
                  if "device_ms" in probes[name] else {}))
        for name, source, replaces, _ in PROBES
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(rank_main(sys.argv[1:]) if sys.argv[1:2] == ["--rank"] else main())
