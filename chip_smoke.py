#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (``atray_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, one printed line each (a failing phase raises, exit code != 0):

1. environment: torch and CUDA versions, the card's name and power limit
   (nvidia-smi), then the nvcc build of every kernel in
   ``atray_tpu_torch/csrc/`` and its wall time;
2. ``lane_take`` kernel vs ``lane_take_ref`` at N = 4,147,200 (one chunk of
   the slice): pack, unpack and a scattered map with 5% -1, for C = 15, 14
   (the state pack) and 3 (the colour restore); results must be equal;
3. the slice's host build (scene, 139k-triangle shaded accel), then
   ``wide_shade`` kernel vs ``wide_shade_planes_ref`` on it: 65,536 rays
   (camera primaries and bounce-like rays from their hit points, 10% dead)
   and, at the main path's shape, one 4,147,200-ray chunk of primaries and
   its bounce rays: a differing id must be a coincident face, t within
   1 ulp, normals within 1e-6, materials equal, dead lanes give the miss
   sentinel;
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
   gradient config's chunk) and 4,147,200, C = 12 and 3, on pack and
   unpack maps (torch.equal) and on a map where every target is hit twice
   (allclose 1e-6: the atomics sum in varying order); kernel, plain and
   ``index_add_`` times;
7. the unshaded ``make_accel`` of the slice's 139k-triangle mesh, then
   ``wide_exact`` kernel vs ``wide_exact_ref`` on 65,536 mixed rays and on
   the gradient config's 2,073,600 primaries and their bounce rays, under
   phase 3's rules: t within 1 ulp, u and v within 1e-6, a differing id
   only where the plain version hits (coincident faces);
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
   first's, ``wide_exact`` and ``wide_shade`` must have launched.

Each path's launch counts are set to 0 just before it runs and read just
after. Then a JSON line of per-kernel results (times, launches, bound),
and as the last line ``{"ok": true, "device": {...}}``. The script needs a
CUDA device and the repository checkout; without either it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
FP32_OPS_PER_S = 67e12        # H100 SXM float32 peak outside the tensor cores
OPS_PER_CHILD_BOX = 25        # slab test of one child box (subs, muls, min/max, compares)
OPS_PER_RECORD = 52           # Moller-Trumbore test of one leaf record


def _bound(nbytes: float, ops: float = 0.0):
    """(least ms, "bytes" or "operations"): the larger of the bytes over
    the memory rate and the float32 operations over the peak rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
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


def _cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


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


def phase_lane_take(dev, gpu):
    import numpy as np
    import torch

    from atray_tpu_torch.kernels.lane_pack import (
        lane_take, lane_take_ref, pack_indices, unpack_indices)

    n = 4_147_200
    rng = np.random.default_rng(11)
    alive = torch.from_numpy(rng.random(n) < 0.7).to(dev)
    scat = rng.permutation(n).astype(np.int32)
    scat[rng.random(n) < 0.05] = -1
    maps = {"pack": pack_indices(alive), "unpack": unpack_indices(alive),
            "scattered": torch.from_numpy(scat).to(dev)}
    res = {}
    for c in (15, 14, 3):
        cols = torch.from_numpy(
            rng.integers(-2**31, 2**31, size=(c, n), dtype=np.int32)).to(dev)
        for name, idx in maps.items():
            got = lane_take(cols, idx)
            want = lane_take_ref(cols, idx)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"lane_take != lane_take_ref (C={c}, {name})")
            ms = _cuda_ms(lambda: lane_take(cols, idx), 20)
            plain_ms = _cuda_ms(lambda: lane_take_ref(cols, idx), 5)
            res[(c, name)] = (ms, plain_ms)
            print(f"phase 2 lane_take C={c} N={n} {name}: equal, kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms [{gpu}]")
    return res


def _compare_hits(accel, planes, alive, label, gpu):
    """Kernel vs plain version on one ray set; returns (max error, kernel
    ms, plain ms, kernel output)."""
    import numpy as np
    import torch

    from atray_tpu_torch.core.intersect import INF
    from atray_tpu_torch.kernels.wide_shade import wide_shade_planes, wide_shade_planes_ref

    got = wide_shade_planes(accel, *planes, alive)
    visits = {}
    want = wide_shade_planes_ref(accel, *planes, alive, visits=visits)
    torch.cuda.synchronize()
    g = {k: v.cpu().numpy() for k, v in got.items()}
    w = {k: v.cpu().numpy() for k, v in want.items()}
    al = alive.cpu().numpy()
    dead = ~al
    if not (np.all(g["t"][dead] == np.float32(INF)) and np.all(g["id"][dead] == -1)
            and all(np.all(g[k][dead] == 0) for k in ("nx", "ny", "nz", "mat"))):
        raise AssertionError(f"wide_shade {label}: dead lanes do not give the miss sentinel")
    hit = w["id"] >= 0
    ulp = np.spacing(np.abs(w["t"]).astype(np.float32))
    dt = np.abs(g["t"] - w["t"])
    id_diff = g["id"] != w["id"]
    nerr = max(float(np.abs(g[k] - w[k]).max()) for k in ("nx", "ny", "nz"))
    if np.any(dt > ulp):
        raise AssertionError(f"wide_shade {label}: t differs by more than 1 ulp on "
                             f"{int((dt > ulp).sum())} rays")
    if nerr > 1e-6 or not np.array_equal(g["mat"], w["mat"]):
        raise AssertionError(f"wide_shade {label}: normal error {nerr} or material mismatch")
    if np.any(id_diff & ~hit):
        raise AssertionError(f"wide_shade {label}: a plain-version miss is a kernel hit")
    max_abs_t = float(dt[hit].max()) if hit.any() else 0.0
    ms = _cuda_ms(lambda: wide_shade_planes(accel, *planes, alive), 20)
    plain_ms = _host_ms(lambda: wide_shade_planes_ref(accel, *planes, alive))
    print(f"phase 3 wide_shade {label}: {alive.shape[0]} rays ({int(al.sum())} live, "
          f"{int(hit.sum())} hits): ids differ on {int(id_diff.sum())} (coincident faces), "
          f"max |dt| {max_abs_t:.3g}, max normal err {nerr:.3g}; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.1f} ms [{gpu}]")
    tab = sum(getattr(accel, k).nbytes for k in ("cboxes", "clinks", "caxis", "tris"))
    io = sum(p.nbytes for p in planes) + alive.nbytes + sum(v.nbytes for v in got.values())
    bound = _bound(io + tab, _walk_ops(visits))
    print(f"phase 3 wide_shade {label}: bound {bound[0]:.4f} ms by {bound[1]} "
          f"({(io + tab) / 1e6:.1f} MB; {visits['nodes']} node pops, "
          f"{visits['records']} records tested)")
    return max(max_abs_t, nerr), ms, plain_ms, got, bound


def _chunk_rays(dev):
    """The third of the slice's four 4,147,200-ray chunks (tile order): its
    camera rays, which cross the dragon."""
    from atray_tpu_torch.core.camera import camera_rays, look_at_camera
    from atray_tpu_torch.render.wavefront import to_tile_order

    cam = look_at_camera((0.0, 1.0, 0.8), (0.0, 0.0, -4.0), h_fov=0.9, aspect=16 / 9)
    o, d = camera_rays(cam, 1920, 1080, 8, device=dev)
    n = 2 * 1920 * 1080
    o = to_tile_order(o, 1920, 1080, 8)[2 * n:3 * n]
    d = to_tile_order(d, 1920, 1080, 8)[2 * n:3 * n]
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


def phase_wide_shade(accel, dev, gpu):
    import numpy as np
    import torch

    from atray_tpu_torch.core.camera import camera_rays, look_at_camera

    def planes_of(o, d):
        return [o[:, k].contiguous() for k in range(3)] + [d[:, k].contiguous() for k in range(3)]

    rng = np.random.default_rng(12)
    # 65,536 rays: 32,768 camera primaries and 32,768 bounce-like rays from
    # their hit points; 10% dead
    cam = look_at_camera((0.0, 1.0, 0.8), (0.0, 0.0, -4.0), h_fov=0.9, aspect=16 / 9)
    o, d = camera_rays(cam, 1920, 1080, 1, device=dev)
    pick = torch.from_numpy(rng.choice(o.shape[0], 32_768, replace=False)).to(dev)
    o, d = o[pick], d[pick]
    ones = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
    _, _, _, prim, _ = _compare_hits(accel, planes_of(o, d), ones, "primaries 32768", gpu)
    bo, bd, _ = _hemisphere_rays(o, d, prim, rng, dev)
    alive = torch.from_numpy(rng.random(2 * o.shape[0]) >= 0.1).to(dev)
    err1, _, _, _, _ = _compare_hits(accel, planes_of(torch.cat([o, bo]), torch.cat([d, bd])),
                                     alive, "65536 mixed", gpu)
    # the main path's shape: one chunk of 4,147,200 rays
    o, d = _chunk_rays(dev)
    ones = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
    err2, _, _, prim, _ = _compare_hits(accel, planes_of(o, d), ones, "chunk primaries", gpu)
    bo, bd, hit = _hemisphere_rays(o, d, prim, rng, dev)
    err3, ms, plain_ms, _, bound = _compare_hits(accel, planes_of(bo, bd), hit, "chunk bounce",
                                                 gpu)
    return max(err1, err2, err3), ms, plain_ms, bound


def phase_slice(scene, accel, dev, gpu):
    import numpy as np
    import torch

    from atray_tpu_torch.config import RenderSettings
    from atray_tpu_torch.core.camera import look_at_camera
    from atray_tpu_torch.render.film import save_png
    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.render.wavefront import render

    w, h, spp, bounces = 1920, 1080, 8, 5
    settings = RenderSettings(resolution=(w, h), samples_per_pixel=spp,
                              bounce_limit=bounces, ray_chunk=2 * 1920 * 1080)
    cam = look_at_camera((0.0, 1.0, 0.8), (0.0, 0.0, -4.0), h_fov=0.9, aspect=w / h)
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
    save_png("out/chip_smoke.png", film, srgb=True)
    for i, (sec, live) in enumerate(frames):
        print(f"phase 4 slice frame {i + 1}: 1920x1080 x {spp} spp x {bounces} bounces, "
              f"{chunks} chunks: {sec:.4f} s, live rays {live}, "
              f"{live / sec:.6g} live rays/s [{gpu}]")
    print(f"phase 4 slice: warm-up frame {warm_s:.4f} s; launches over the 2 timed frames "
          f"wide_shade {counts['wide_shade'][0]}, lane_take {counts['lane_take'][0]}, "
          f"plain calls 0; film std {f.std():.4f}; wrote out/chip_smoke.png")
    frame_s = sum(sec for sec, _ in frames) / len(frames)
    _profile_frame(lambda: render(scene, cam, settings, prng_key(3), accel=accel), frame_s, gpu)
    return counts


_KERNEL_NAMES = ("wide_shade", "lane_take", "lane_scatter", "wide_exact")


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


def phase_lane_scatter(dev, gpu):
    import numpy as np
    import torch

    from atray_tpu_torch.kernels.lane_pack import (
        lane_scatter, lane_scatter_ref, pack_indices, unpack_indices)

    rng = np.random.default_rng(13)
    res = {}
    for n in (2_073_600, 4_147_200):
        alive = torch.from_numpy(rng.random(n) < 0.7).to(dev)
        dup = (np.arange(n) // 2).astype(np.int32)
        dup[rng.random(n) < 0.05] = -1
        maps = {"pack": pack_indices(alive), "unpack": unpack_indices(alive),
                "duplicates": torch.from_numpy(dup).to(dev)}
        for c in (12, 3):
            cols = torch.from_numpy(rng.normal(size=(c, n)).astype(np.float32)).to(dev)
            for name, dst in maps.items():
                got = lane_scatter(cols, dst)
                want = lane_scatter_ref(cols, dst)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if name == "duplicates":
                    if not torch.allclose(got, want, rtol=1e-6, atol=1e-6):
                        raise AssertionError(f"lane_scatter != lane_scatter_ref beyond 1e-6 "
                                             f"(C={c}, N={n}, {name}): {err}")
                elif not torch.equal(got, want):
                    raise AssertionError(f"lane_scatter != lane_scatter_ref (C={c}, N={n}, {name})")
                ok = dst >= 0
                d_ok, v_ok = dst[ok].long(), cols[:, ok].contiguous()
                ms = _cuda_ms(lambda: lane_scatter(cols, dst), 20)
                plain_ms = _cuda_ms(lambda: lane_scatter_ref(cols, dst), 3)
                lib_ms = _cuda_ms(lambda: torch.zeros_like(cols).index_add_(1, d_ok, v_ok), 20)
                bound = _bound(2 * cols.nbytes + dst.nbytes)
                res[(c, n, name)] = (ms, plain_ms, lib_ms, bound, err)
                print(f"phase 6 lane_scatter C={c} N={n} {name}: "
                      f"{'allclose' if name == 'duplicates' else 'equal'} (max |err| {err:.3g}), "
                      f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, "
                      f"bound {bound[0]:.4f} ms by {bound[1]} [{gpu}]")
    return res


def _exact_compare(accel, o, d, label, gpu):
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
    print(f"phase 7 wide_exact {label}: {o.shape[0]} rays ({int(hit.sum())} hits): ids differ "
          f"on {int((~same).sum())} (coincident faces), max |dt| {max_dt:.3g}, max u/v err "
          f"{uverr:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound {bound[0]:.4f} ms "
          f"by {bound[1]} ({visits['nodes']} node pops, {visits['records']} records) [{gpu}]")
    return max(max_dt, uverr), ms, plain_ms, bound


def _bwd_camera():
    from atray_tpu_torch.core.camera import look_at_camera

    return look_at_camera((0.0, 1.0, 0.8), (0.0, 0.0, -4.0), h_fov=0.9, aspect=16 / 9)


def phase_wide_exact(scene_host, shaded, dev, gpu):
    import numpy as np
    import torch

    from atray_tpu_torch.accel.wide import make_accel
    from atray_tpu_torch.config import KDTreeConfig
    from atray_tpu_torch.core.camera import camera_rays
    from atray_tpu_torch.kernels.wide_shade import wide_shade_planes
    from atray_tpu_torch.render.wavefront import to_tile_order

    t0 = time.perf_counter()
    host = make_accel(scene_host.mesh.vertices, scene_host.mesh.faces, KDTreeConfig(leaf_size=16))
    t_build = time.perf_counter() - t0
    tbytes = sum(getattr(host, k).nbytes for k in ("cboxes", "clinks", "tris"))
    print(f"phase 7 host build: make_accel {t_build:.2f} s ({host.num_nodes} wide nodes, "
          f"wide depth {host.max_depth}, tables {tbytes / 1e6:.1f} MB)")
    accel = host.to(dev)

    def hemisphere(o, d, rng):
        planes = [o[:, k].contiguous() for k in range(3)] + [d[:, k].contiguous() for k in range(3)]
        fo = wide_shade_planes(shaded, *planes, torch.ones(o.shape[0], dtype=torch.bool, device=dev))
        return _hemisphere_rays(o, d, fo, rng, dev)[:2]

    rng = np.random.default_rng(14)
    o, d = camera_rays(_bwd_camera(), 960, 540, 1, device=dev)
    pick = torch.from_numpy(rng.choice(o.shape[0], 32_768, replace=False)).to(dev)
    o, d = o[pick], d[pick]
    bo, bd = hemisphere(o, d, rng)
    err1, ms, plain_ms, bound = _exact_compare(
        accel, torch.cat([o, bo]).contiguous(), torch.cat([d, bd]).contiguous(),
        "65536 mixed", gpu)
    # the gradient config's one chunk: 960x540 x 4 spp primaries, tile order
    o, d = camera_rays(_bwd_camera(), 960, 540, 4, device=dev)
    o = to_tile_order(o, 960, 540, 4).contiguous()
    d = to_tile_order(d, 960, 540, 4).contiguous()
    err2, _, _, _ = _exact_compare(accel, o, d, "chunk primaries", gpu)
    bo, bd = hemisphere(o, d, rng)
    err3, _, _, _ = _exact_compare(accel, bo.contiguous(), bd.contiguous(), "chunk bounce", gpu)
    return host, max(err1, err2, err3), ms, plain_ms, bound


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


def phase_trainer(wide_host, dev, gpu):
    import dataclasses

    import numpy as np
    import torch

    from atray_tpu_torch.accel.shaded import build_shaded_accel
    from atray_tpu_torch.config import KDTreeConfig
    from atray_tpu_torch.core.camera import camera_rays, look_at_camera
    from atray_tpu_torch.dist.train import make_train_step
    from atray_tpu_torch.render.rng import fold_in, prng_key
    from atray_tpu_torch.render.wavefront import trace_radiance
    from atray_tpu_torch.scene import build_scene, procedural
    from atray_tpu_torch.scene.data import make_materials
    from atray_tpu_torch.scene.transforms import translate

    mats = make_materials([
        ((0.35, 0.45, 0.65), (0.0, 0.0, 0.0), 0.0),
        ((0.0, 0.0, 0.0), (0.8, 0.45, 0.25), 0.2),
    ])
    body = translate(procedural.dragon_proxy(target_tris=139_000, material=1), (0, 0, -4))
    scene_host = build_scene([body], materials=mats)
    t0 = time.perf_counter()
    shaded = build_shaded_accel(scene_host, KDTreeConfig(leaf_size=16))
    t_shaded = time.perf_counter() - t0
    views, res = 16, 64
    origs, dirns = [], []
    for v in range(views):
        ang = 2 * np.pi * v / views
        cam = look_at_camera((2.5 * np.sin(ang), 0.8, -4 + 2.5 * np.cos(ang)), (0, 0, -4),
                             h_fov=0.8, aspect=1.0)
        o, d = camera_rays(cam, res, res, 1, device=dev)
        origs.append(o)
        dirns.append(d)
    orig, dirn = torch.cat(origs), torch.cat(dirns)
    scene = scene_host.to(dev)
    with torch.no_grad():
        target = trace_radiance(scene, orig, dirn, 2, prng_key(0), accel=wide_host)

    true = scene.params()
    noise = torch.from_numpy(np.random.default_rng(3).normal(
        0, 0.004, tuple(true.vertices.shape)).astype(np.float32)).to(dev)
    p = dataclasses.replace(true, albedo=(true.albedo * 0.4 + 0.2).requires_grad_(),
                            vertices=(true.vertices + noise).requires_grad_())
    opt = torch.optim.Adam([{"params": [p.albedo], "lr": 3e-2},
                            {"params": [p.vertices], "lr": 5e-4}])
    steps = {"make_accel": make_train_step(scene_host, 2, opt, accel=wide_host, refit=True,
                                           device=dev),
             "shaded accel": make_train_step(scene_host, 2, opt, accel=shaded, refit=True,
                                             device=dev)}
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
    return counts


def _entry(name, source, replaces, launches, err, ms, plain_ms, bound, library_ms):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library_ms}


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

    ws_err, ws_ms, ws_plain, ws_bound = phase_wide_shade(accel, dev, gpu)
    counts = phase_slice(scene, accel, dev, gpu)
    phase_small_vs_cpu(scene_host, accel_host, dev, gpu)
    phase_identity(scene, accel, gpu)
    ls = phase_lane_scatter(dev, gpu)
    wide_host, we_err, we_ms, we_plain, we_bound = phase_wide_exact(scene_host, accel, dev, gpu)
    g_counts, _ = phase_gradient(scene, accel, scene_host, accel_host, dev, gpu)
    t_counts = phase_trainer(wide_host.to(dev), dev, gpu)

    lt_ms, lt_plain = lt[(14, "pack")]
    n_chunk = 4_147_200
    ls_ms, ls_plain, ls_lib, ls_bound, _ = ls[(12, 2_073_600, "pack")]
    ls_err = max(v[4] for v in ls.values())
    print(json.dumps({"kernels": [
        _entry("wide_shade", "atray_tpu_torch/csrc/wide_shade.cu",
               "atray_tpu/kernels/wide_shade.py:43", counts["wide_shade"][0], ws_err,
               ws_ms, ws_plain, ws_bound, None),
        _entry("lane_take", "atray_tpu_torch/csrc/lane_take.cu",
               "atray_tpu/kernels/lane_pack.py:202", counts["lane_take"][0], 0.0,
               lt_ms, lt_plain, _bound((2 * 14 + 1) * 4 * n_chunk), None),
        _entry("lane_scatter", "atray_tpu_torch/csrc/lane_scatter.cu",
               "atray_tpu/kernels/lane_pack.py:632", g_counts["lane_scatter"][0], ls_err,
               ls_ms, ls_plain, ls_bound, ls_lib),
        _entry("wide_exact", "atray_tpu_torch/csrc/wide_exact.cu",
               "atray_tpu/kernels/wide_exact.py:46", t_counts["wide_exact"][0], we_err,
               we_ms, we_plain, we_bound, None),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
