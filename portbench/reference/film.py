"""Where a film's samples lie among the rays of a frame: the frame's rays
are made sample-major, row-major, then put in film-tile order (tiles of
up to 16 rows by 128 columns, the samples of a tile adjacent), and a ray's
global id, which keys its random numbers, is its place in that order."""

from __future__ import annotations

import torch


def _largest_divisor_leq(n: int, cap: int) -> int:
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def ray_id(px: torch.Tensor, py: torch.Tensor, s: int, width: int, height: int,
           spp: int) -> torch.Tensor:
    """Global ids of sample ``s`` of pixels (px, py)."""
    th, tw = _largest_divisor_leq(height, 16), _largest_divisor_leq(width, 128)
    ty, iy = py // th, py % th
    tx, ix = px // tw, px % tw
    return (((ty * (width // tw) + tx) * spp + s) * th + iy) * tw + ix
