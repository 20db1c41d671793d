"""Random numbers of the renderer, bit-equal to the JAX package's.

Keys are host numpy ``uint32[2]`` arrays; there is no global RNG state.

- ``prng_key``, ``split``, ``fold_in``, ``uniform`` and the threefry2x32
  bits under it (``random_bits``, ``random_bits_np``) live in
  ``core.threefry`` (the camera's jitter needs them too) and are
  re-exported here.
- ``ray_uniform_cols(key, ray_ids, bounce)`` reproduces the renderer's
  per-ray uniforms (``atray_tpu/render/wavefront.py:_ray_uniform_cols``): a
  chain of murmur3 fmix32 finalizers over (key, global ray id, bounce,
  channel), so every number is a pure function of the ray's global id and
  films do not depend on chunking or compaction order. ``ray_uniforms``
  stacks them to (R, channels) and ``draw_bounce_uniforms`` to (B, R,
  channels), the explicit uniforms ``render`` and ``trace_radiance`` take.

The 32-bit wrapping arithmetic runs on int64 tensors masked to 32 bits,
with multiplies split into 16-bit halves so no product reaches 2**63
(torch has no ``>>`` for uint32 tensors).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from atray_tpu_torch.core.threefry import (  # noqa: F401 (re-exported)
    _M32,
    fold_in,
    prng_key,
    random_bits,
    random_bits_np,
    split,
    uniform,
)
from atray_tpu_torch.device import resolve_device


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32) held in int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def ray_uniform_cols(key, ray_ids: torch.Tensor, bounce: int,
                     channels: int = 3) -> Tuple[torch.Tensor, ...]:
    """``channels`` flat (R,) float32 columns of uniforms in [-1, 1)."""
    kd = np.asarray(key, np.uint32).reshape(-1)
    s0, s1 = int(kd[0]), int(kd[-1])
    gid = ray_ids.to(torch.int64) & _M32
    base = mix32(gid ^ s0)
    hb = mix32((base + ((int(bounce) * 0x9E3779B9 + s1) & _M32)) & _M32)
    cols = []
    for c in range(channels):
        hc = mix32((hb + ((c + 1) * 0x85EBCA77 & _M32)) & _M32)
        u = (hc >> 8).to(torch.float32) * (1.0 / 16777216.0)
        cols.append(u * 2.0 - 1.0)
    return tuple(cols)


def ray_uniforms(key, ray_ids: torch.Tensor, bounce: int, channels: int = 3) -> torch.Tensor:
    """(R, channels) uniforms in [-1, 1): ``ray_uniform_cols`` stacked."""
    return torch.stack(ray_uniform_cols(key, ray_ids, bounce, channels), dim=1)


def draw_bounce_uniforms(key, bounces: int, num_rays: int, channels: int = 3,
                         device=None) -> torch.Tensor:
    """(B, R, channels) uniforms on ``device``: row b, ray i is
    ``ray_uniforms(key, i, b)``. 3 channels for plain path tracing, 6 with
    NEE (3 jitter, the light pick, 2 for the point on the light)."""
    ids = torch.arange(num_rays, dtype=torch.int32, device=resolve_device(device))
    return torch.stack([ray_uniforms(key, ids, b, channels) for b in range(bounces)])
