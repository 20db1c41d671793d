"""Random numbers of the renderer, bit-equal to the JAX package's.

Keys are host numpy ``uint32[2]`` arrays; there is no global RNG state.

- ``prng_key(seed)``, ``split(key, num)`` and ``fold_in(key, data)``
  reproduce ``jax.random.PRNGKey``, ``jax.random.split`` and
  ``jax.random.fold_in`` for the default threefry
  implementation with ``jax_threefry_partitionable`` on (the default of the
  jax the reference is tested with): split counts are a 64-bit iota given
  to threefry2x32 as (hi, lo) words.
- ``ray_uniform_cols(key, ray_ids, bounce)`` reproduces the renderer's
  per-ray uniforms (``atray_tpu/render/wavefront.py:_ray_uniform_cols``): a
  chain of murmur3 fmix32 finalizers over (key, global ray id, bounce,
  channel), so every number is a pure function of the ray's global id and
  films do not depend on chunking or compaction order.

The 32-bit wrapping arithmetic runs on int64 tensors masked to 32 bits,
with multiplies split into 16-bit halves so no product reaches 2**63
(torch has no ``>>`` for uint32 tensors).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x0, x1) -> Tuple[np.ndarray, np.ndarray]:
    """Threefry-2x32 with 20 rounds on uint32 numpy arrays."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, np.uint32(k1 ^ k2 ^ np.uint32(0x1BD11BDA)))
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the 64-bit seed as (hi, lo) words."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & _M32], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` -> (num, 2) uint32."""
    key = np.asarray(key, np.uint32).reshape(2)
    with np.errstate(over="ignore"):
        b1, b2 = threefry2x32(key[0], key[1], np.zeros(num, np.uint32),
                              np.arange(num, dtype=np.uint32))
    return np.stack([b1, b2], axis=1)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)``: threefry2x32 of the key over the
    32-bit ``data`` as the (0, data) word pair. The trainer's per-step keys
    are ``fold_in(prng_key(seed), step)``."""
    key = np.asarray(key, np.uint32).reshape(2)
    with np.errstate(over="ignore"):
        b1, b2 = threefry2x32(key[0], key[1], np.zeros(1, np.uint32),
                              np.array([int(data) & _M32], np.uint32))
    return np.array([b1[0], b2[0]], np.uint32)


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
