"""Vector helpers over the trailing axis (``atray_tpu/core/intersect.py``).

Only what the forward slice needs: the miss sentinel, the minimum hit
distance, ``dot``, ``cross`` and ``normalize`` with the reference's op
order (``v * reciprocal(sqrt(max(v.v, eps)))``).
"""

from __future__ import annotations

import torch

INF = 3.0e38        # miss sentinel (the reference's MAX_FLOAT stand-in)
T_MIN = 1.0e-4      # minimum hit distance (self-intersection guard)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-wise dot product over the trailing axis."""
    return torch.sum(a * b, dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def normalize(v: torch.Tensor, eps: float = 1.0e-20) -> torch.Tensor:
    """Safe normalize over the trailing axis."""
    return v * torch.reciprocal(torch.sqrt(torch.clamp_min(dot(v, v), eps)))[..., None]
