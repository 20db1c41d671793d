"""Film post-processing and PNG output (``atray_tpu/render/film.py``)."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch


def linear_to_srgb(c: torch.Tensor) -> torch.Tensor:
    """IEC 61966-2-1 transfer function."""
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92, 1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


def to_uint8(film) -> np.ndarray:
    """(H, W, 3) floats in [0, 1] -> uint8, rounding half up."""
    if isinstance(film, torch.Tensor):
        film = film.detach().cpu().numpy()
    a = np.asarray(film)
    return np.clip(a * 255.0 + 0.5, 0.0, 255.0).astype(np.uint8)


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """Minimal 8-bit RGB PNG encoder (standard library only)."""
    h, w, c = rgb.shape
    if c != 3 or rgb.dtype != np.uint8:
        raise ValueError("encode_png takes (H, W, 3) uint8")
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(raw, 6)) + _png_chunk(b"IEND", b""))


def unique_path(path: str) -> str:
    """``name.png`` -> the first free one of ``name.png``, ``name_1.png``,
    ``name_2.png``, ... (the reference's collision-avoiding naming)."""
    if not os.path.exists(path):
        return path
    stem, ext = os.path.splitext(path)
    n = 1
    while os.path.exists(f"{stem}_{n}{ext}"):
        n += 1
    return f"{stem}_{n}{ext}"


def save_png(path: str, film, srgb: bool = False, avoid_collision: bool = True) -> str:
    """Write the film to a PNG; returns the path written. With
    ``avoid_collision`` an existing file is kept and the film goes to
    ``unique_path(path)``; without it the file is overwritten."""
    if srgb:
        film = linear_to_srgb(torch.as_tensor(film))
    data = encode_png(to_uint8(film))
    if avoid_collision:
        path = unique_path(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(data)
    return path
