"""Pinhole camera rays: a right-handed basis from the eye and the target
with world up (0, 1, 0), computed in float64 and kept as float32; the film
spans [-1, 1] with pixel (0, 0) at the top left, its half-width ``h_fov``
and half-height ``h_fov / aspect``; a ray goes through the pixel's centre."""

from __future__ import annotations

import numpy as np
import torch


def basis(eye, target, h_fov: float, aspect: float) -> dict:
    """The camera's eye, right, up, forward and half extents, float32."""
    eye = np.asarray(eye, np.float64)
    fw = np.asarray(target, np.float64) - eye
    fw = fw / max(np.linalg.norm(fw), 1e-20)
    right = np.cross(fw, np.array([0.0, 1.0, 0.0]))
    right = right / max(np.linalg.norm(right), 1e-20)
    up = np.cross(right, fw)
    f32 = np.float32
    return {"eye": eye.astype(f32), "right": right.astype(f32), "up": up.astype(f32),
            "forward": fw.astype(f32), "half_width": f32(h_fov),
            "half_height": f32(h_fov / aspect)}


def pixel_rays(cam: dict, width: int, height: int, px: torch.Tensor, py: torch.Tensor,
               dtype=torch.float32):
    """(origins, directions), each (K, 3), of the pixels (px, py) (int
    tensors of one device), directions of unit length."""
    dev = px.device
    f32 = torch.float32
    fx = (px.to(f32) + 0.5) / width * 2.0 - 1.0
    fy = 1.0 - (py.to(f32) + 0.5) / height * 2.0

    def vec(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    hw = torch.tensor(cam["half_width"], dtype=f32, device=dev)
    hh = torch.tensor(cam["half_height"], dtype=f32, device=dev)
    d = fx[:, None] * (vec(cam["right"]) * hw) + fy[:, None] * (vec(cam["up"]) * hh) \
        + vec(cam["forward"])
    d = d * torch.reciprocal(torch.sqrt(torch.clamp_min(torch.sum(d * d, dim=-1),
                                                        1.0e-20)))[:, None]
    o = vec(cam["eye"]).expand(d.shape)
    return o.to(dtype).contiguous(), d.to(dtype).contiguous()
