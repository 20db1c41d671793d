"""Keys and threefry2x32 bits, bit-equal to ``jax.random``'s.

Keys are host numpy ``uint32[2]`` arrays; there is no global RNG state.

- ``prng_key(seed)``, ``split(key, num)`` and ``fold_in(key, data)``
  reproduce ``jax.random.PRNGKey``, ``jax.random.split`` and
  ``jax.random.fold_in`` for the default threefry
  implementation with ``jax_threefry_partitionable`` on (the default of the
  jax the reference is tested with): split counts are a 64-bit iota given
  to threefry2x32 as (hi, lo) words.
- ``uniform(key, shape, minval, maxval)`` reproduces
  ``jax.random.uniform`` in float32 (the anti-aliasing jitter of
  ``core.camera.camera_rays``): ``random_bits`` runs threefry2x32 on the
  tensor's device over a 64-bit iota as (hi, lo) words and xors the two
  outputs (``jax._src.prng._threefry_random_bits_partitionable``); the
  numpy ``threefry2x32`` is its plain version.

The tensor version runs on int64 tensors masked to 32 bits (torch has no
``>>`` for uint32 tensors). ``render.rng`` re-exports all of it beside the
renderer's per-ray uniforms.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from atray_tpu_torch.device import resolve_device

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


def _rotl_t(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32_t(k1: int, k2: int, x0: torch.Tensor, x1: torch.Tensor):
    """``threefry2x32`` on int64 tensors holding uint32 words."""
    k1, k2 = int(k1), int(k2)
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl_t(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def random_bits(key, n: int, device=None) -> torch.Tensor:
    """The ``n`` 32-bit words of ``jax.random.bits(key, (n,))`` (any shape
    of n elements, flattened), as an int64 tensor on ``device``."""
    kd = np.asarray(key, np.uint32).reshape(2)
    count = torch.arange(n, dtype=torch.int64, device=resolve_device(device))
    b0, b1 = threefry2x32_t(kd[0], kd[1], count >> 32, count & _M32)
    return b0 ^ b1


def random_bits_np(key, n: int) -> np.ndarray:
    """Plain (numpy) version of ``random_bits``: uint32 words."""
    kd = np.asarray(key, np.uint32).reshape(2)
    count = np.arange(n, dtype=np.uint64)
    with np.errstate(over="ignore"):
        b0, b1 = threefry2x32(kd[0], kd[1], (count >> np.uint64(32)).astype(np.uint32),
                              (count & np.uint64(_M32)).astype(np.uint32))
    return b0 ^ b1


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` on
    ``device``: the top 23 bits of each word as a mantissa in [1, 2), minus
    1, scaled and shifted, then held at ``minval`` from below."""
    shape = tuple(int(s) for s in shape)
    bits = random_bits(key, int(np.prod(shape)), device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, f * (hi - lo) + lo).reshape(shape)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)`` as the JAX package runs it (64-bit
    types off): the seed's low 32 bits as the second word, the first 0,
    also for negative seeds and seeds of 2**32 and more."""
    return np.array([0, int(seed) & _M32], np.uint32)


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
