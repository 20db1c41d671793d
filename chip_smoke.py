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
   sort + lane pack on is bit-equal to the film with both off.

Then a JSON line of per-kernel results, and as the last line
``{"ok": true, "device": {...}}``. The script needs a CUDA device and the
repository checkout; without either it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time


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
    want = wide_shade_planes_ref(accel, *planes, alive)
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
    return max(max_abs_t, nerr), ms, plain_ms, got


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
    _, _, _, prim = _compare_hits(accel, planes_of(o, d), ones, "primaries 32768", gpu)
    bo, bd, _ = _hemisphere_rays(o, d, prim, rng, dev)
    alive = torch.from_numpy(rng.random(2 * o.shape[0]) >= 0.1).to(dev)
    err1, _, _, _ = _compare_hits(accel, planes_of(torch.cat([o, bo]), torch.cat([d, bd])),
                                  alive, "65536 mixed", gpu)
    # the main path's shape: one chunk of 4,147,200 rays
    o, d = _chunk_rays(dev)
    ones = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
    err2, _, _, prim = _compare_hits(accel, planes_of(o, d), ones, "chunk primaries", gpu)
    bo, bd, hit = _hemisphere_rays(o, d, prim, rng, dev)
    err3, ms, plain_ms, _ = _compare_hits(accel, planes_of(bo, bd), hit, "chunk bounce", gpu)
    return max(err1, err2, err3), ms, plain_ms


def phase_slice(scene, accel, dev, gpu):
    import numpy as np
    import torch

    from atray_tpu_torch.config import RenderSettings
    from atray_tpu_torch.core.camera import look_at_camera
    from atray_tpu_torch.kernels import _build
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

    for c in _build.COUNTERS.values():
        c.reset()
    frames = []
    for seed in (1, 2):
        t0 = time.perf_counter()
        film, stats = render(scene, cam, settings, prng_key(seed), accel=accel,
                             return_stats=True)
        live = int(stats["rays_cast"])       # synchronizes
        frames.append((time.perf_counter() - t0, live))
    counts = {k: (c.launches, c.plain_calls) for k, c in _build.COUNTERS.items()}
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


def _profile_frame(run, frame_s, gpu):
    """Device time of one frame by kernel, from torch.profiler; the busy
    share is kernel time over the un-profiled frame wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    groups = {"wide_shade": [0.0, 0], "lane_take": [0.0, 0], "torch ops": [0.0, 0]}
    top = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = float(getattr(e, "self_device_time_total", 0.0))
        name = ("wide_shade" if "wide_shade_kernel" in e.key else
                "lane_take" if "lane_take_kernel" in e.key else "torch ops")
        groups[name][0] += us
        groups[name][1] += e.count
        if name == "torch ops":
            top.append((us, e.count, e.key))
    total = sum(g[0] for g in groups.values())
    if total <= 0:
        print("phase 4 profile: the profiler recorded no device time (not measured)")
        return
    parts = ", ".join(f"{k} {v[0] / 1e3:.3f} ms ({100 * v[0] / total:.1f}%, {v[1]} launches)"
                      for k, v in groups.items())
    print(f"phase 4 profile of one slice frame: device kernel time {total / 1e3:.3f} ms = "
          f"{parts}; busy share {total / 1e6 / frame_s:.3f} of the {frame_s:.4f} s frame [{gpu}]")
    for us, count, key in sorted(top, reverse=True)[:6]:
        print(f"phase 4 profile top torch kernel: {us / 1e3:.3f} ms, {count} launches, {key[:90]}")


def phase_small_vs_cpu(scene, accel_host, dev, gpu):
    import numpy as np
    import torch

    from atray_tpu_torch.config import RenderSettings
    from atray_tpu_torch.core.camera import look_at_camera
    from atray_tpu_torch.render.rng import prng_key
    from atray_tpu_torch.render.wavefront import render

    s = RenderSettings(resolution=(48, 27), samples_per_pixel=1, bounce_limit=5)
    cam = look_at_camera((0.0, 1.0, 0.8), (0.0, 0.0, -4.0), h_fov=0.9, aspect=16 / 9)
    gpu_film = render(scene.to(dev), cam, s, prng_key(3), accel=accel_host.to(dev)).cpu().numpy()
    cpu_film = render(scene.to("cpu"), cam, s, prng_key(3), accel=accel_host.to("cpu")).numpy()
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
    print(f"phase 1 build: nvcc {' '.join(_build.NVCC_FLAGS)} -> "
          f"{os.path.relpath(_build.library_path())} in {time.perf_counter() - t0:.2f} s")

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

    ws_err, ws_ms, ws_plain = phase_wide_shade(accel, dev, gpu)
    counts = phase_slice(scene, accel, dev, gpu)
    phase_small_vs_cpu(scene_host, accel_host, dev, gpu)
    phase_identity(scene, accel, gpu)

    lt_ms, lt_plain = lt[(14, "pack")]
    print(json.dumps({"kernels": [
        {"name": "wide_shade", "route": "cuda",
         "source": "atray_tpu_torch/csrc/wide_shade.cu",
         "replaces": "atray_tpu/kernels/wide_shade.py:43",
         "launches": counts["wide_shade"][0], "max_abs_err": ws_err,
         "ms": ws_ms, "plain_ms": ws_plain},
        {"name": "lane_take", "route": "cuda",
         "source": "atray_tpu_torch/csrc/lane_take.cu",
         "replaces": "atray_tpu/kernels/lane_pack.py:202",
         "launches": counts["lane_take"][0], "max_abs_err": 0.0,
         "ms": lt_ms, "plain_ms": lt_plain},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
