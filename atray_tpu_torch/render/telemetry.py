"""Per-chunk cost telemetry (``atray_tpu/render/telemetry.py``).

- ``render_telemetry`` renders the frame through ``render()`` cut into
  ``n_chunks`` chunks of the film-tile-ordered rays, timing each into the
  ``Phase("chunk")`` registry from ``render``'s per-chunk callback: a
  tail-latency sample over spatially coherent ray blocks (sky chunks
  cheap, model chunks dear). The film is ``render()``'s at that
  ``ray_chunk``, whose padding, ray ids and key split are the reference's.
- ``tail_report`` prints min, p50, p90, max and imbalance (max over mean)
  of the chunk times and live rays, and of a sharded render's per-rank
  live rays (``rays_cast_per_shard`` of ``render(mesh=)``), in the
  reference's format.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from atray_tpu_torch.config import RenderSettings
from atray_tpu_torch.core.camera import Camera
from atray_tpu_torch.device import resolve_device
from atray_tpu_torch.render.wavefront import _accel_on, render
from atray_tpu_torch.utils.profiling import Phase


def render_telemetry(scene, camera: Camera, settings: RenderSettings, key, accel=None,
                     n_chunks: int = 16, device=None) -> Tuple[torch.Tensor, dict]:
    """The frame rendered as ``n_chunks`` chunks on ``device`` (None:
    "cuda"), each timed to its end (a ``Phase("chunk", block=True)``).
    The first chunk's time also holds the camera rays and the tables that
    ``render`` builds once a frame. Returns (film (H, W, 3), report):
    ``n_chunks``, ``chunk_rays``, ``chunk_s`` and ``chunk_live_rays`` (the
    rays cast in each chunk)."""
    dev = resolve_device(device)
    scene, accel = scene.to(dev), _accel_on(accel, dev)
    w, h = settings.resolution
    n = w * h * settings.samples_per_pixel
    chunk = -(-n // n_chunks)
    nc = -(-n // chunk)
    times_s, rays = [], []
    phase = Phase("chunk", block=True).__enter__()

    def tick(rays_cast: int):
        phase.__exit__(None, None, None)
        times_s.append(phase.seconds)
        rays.append(rays_cast)
        if len(rays) < nc:
            phase.__enter__()

    film, stats = render(scene, camera, dataclasses.replace(settings, ray_chunk=chunk), key,
                         accel=accel, return_stats=True, device=dev, progress_cb=tick)
    if nc == 1:     # render calls back only where it cuts the frame
        tick(int(stats["rays_cast"]))
    return film, {"n_chunks": nc, "chunk_rays": chunk, "chunk_s": times_s,
                  "chunk_live_rays": rays}


def _spread(xs) -> dict:
    a = np.asarray(xs, np.float64)
    return {"min": float(a.min()), "p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)), "max": float(a.max()),
            "imbalance": float(a.max() / max(a.mean(), 1e-12))}


def tail_report(report: dict, rays_per_shard: Optional[np.ndarray] = None, file=None) -> str:
    """min/p50/p90/max and imbalance (max / mean; 1.0 is a balanced static
    partition) of the chunk times and live rays, and of ``rays_per_shard``
    (a sharded render's live rays a rank) where given."""
    rows = [("chunk wall (s)", _spread(report["chunk_s"])),
            ("chunk live rays", _spread(report["chunk_live_rays"]))]
    if rays_per_shard is not None:
        rows.append(("shard live rays", _spread(rays_per_shard)))
    lines = [f"{'telemetry':<18}{'min':>11}{'p50':>11}{'p90':>11}{'max':>11}{'imbal':>8}"]
    for name, s in rows:
        lines.append(f"{name:<18}{s['min']:>11.4g}{s['p50']:>11.4g}{s['p90']:>11.4g}"
                     f"{s['max']:>11.4g}{s['imbalance']:>8.2f}")
    text = "\n".join(lines)
    if file is not None:
        print(text, file=file)
    return text
