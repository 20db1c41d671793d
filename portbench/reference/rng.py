"""Keys and per-ray uniforms of the renderer, frozen here so that the
reference draws the random numbers the program's contract names without
reading the program.

Keys are host numpy ``uint32[2]`` arrays (``jax.random``'s threefry2x32
keys). ``prng_key``, ``split`` and ``fold_in`` derive keys; ``uniform_cols``
gives a ray's uniforms in [-1, 1) at a bounce: a chain of murmur3 fmix32
finalizers over (key, global ray id, bounce, channel), so every number is a
function of the ray's id alone. The 32-bit arithmetic runs on int64 tensors
masked to 32 bits, products split into 16-bit halves.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(k1, k2, x0, x1):
    """Threefry-2x32, 20 rounds, on uint32 numpy arrays."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, np.uint32(k1 ^ k2 ^ np.uint32(0x1BD11BDA)))
    with np.errstate(over="ignore"):
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
    """The key of ``seed``: its low 32 bits as the second word."""
    return np.array([0, int(seed) & M32], np.uint32)


def split(key, num: int = 2) -> np.ndarray:
    """(num, 2) keys."""
    key = np.asarray(key, np.uint32).reshape(2)
    b1, b2 = threefry2x32(key[0], key[1], np.zeros(num, np.uint32),
                          np.arange(num, dtype=np.uint32))
    return np.stack([b1, b2], axis=1)


def fold_in(key, data: int) -> np.ndarray:
    """The key folded with the 32-bit ``data``."""
    key = np.asarray(key, np.uint32).reshape(2)
    b1, b2 = threefry2x32(key[0], key[1], np.zeros(1, np.uint32),
                          np.array([int(data) & M32], np.uint32))
    return np.array([b1[0], b2[0]], np.uint32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _fmix32(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def uniform_cols(key, ray_ids: torch.Tensor, bounce: int, channels: int = 3):
    """``channels`` float32 columns in [-1, 1) for the rays ``ray_ids``;
    ``key`` is one key, or an (R, 2) int64 tensor of a key a ray."""
    if isinstance(key, torch.Tensor):
        s0, s1 = key[:, 0], key[:, 1]
    else:
        kd = np.asarray(key, np.uint32).reshape(-1)
        s0, s1 = int(kd[0]), int(kd[-1])
    base = _fmix32((ray_ids.to(torch.int64) & M32) ^ s0)
    hb = _fmix32((base + ((int(bounce) * 0x9E3779B9 + s1) & M32)) & M32)
    cols = []
    for c in range(channels):
        hc = _fmix32((hb + ((c + 1) * 0x85EBCA77 & M32)) & M32)
        cols.append((hc >> 8).to(torch.float32) * (1.0 / 16777216.0) * 2.0 - 1.0)
    return cols
