"""Pinhole camera and batched camera-ray generation
(``atray_tpu/core/camera.py``).

Conventions are the reference's: right-handed basis from eye/look_dir with
world up (0, 1, 0); ``h_fov`` is the film half-width and the half-height is
``h_fov / aspect``; film coordinates span [-1, 1]; pixel (0, 0) is the
top-left. The basis is host numpy; rays are tensors on the device asked for.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from atray_tpu_torch.core.intersect import normalize


@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera basis and film geometry as float32 host arrays."""

    eye: np.ndarray          # (3,)
    right: np.ndarray        # (3,) unit
    up: np.ndarray           # (3,) unit
    forward: np.ndarray      # (3,) unit
    half_width: np.float32   # film half-width (= h_fov)
    half_height: np.float32  # film half-height (= h_fov / aspect)


def make_camera(eye, look_dir, h_fov: float = 1.0, aspect: float = 16.0 / 9.0) -> Camera:
    """Right-handed camera basis, computed in float64 and stored as float32."""
    eye = np.asarray(eye, np.float64)
    fw = np.asarray(look_dir, np.float64)
    fw = fw / max(np.linalg.norm(fw), 1e-20)
    up_w = np.array([0.0, 1.0, 0.0])
    right = np.cross(fw, up_w)
    right = right / max(np.linalg.norm(right), 1e-20)
    up = np.cross(right, fw)
    return Camera(
        eye=eye.astype(np.float32),
        right=right.astype(np.float32),
        up=up.astype(np.float32),
        forward=fw.astype(np.float32),
        half_width=np.float32(h_fov),
        half_height=np.float32(h_fov / aspect),
    )


def look_at_camera(eye, target, h_fov: float = 1.0, aspect: float = 16.0 / 9.0) -> Camera:
    eye_np = np.asarray(eye, np.float64)
    return make_camera(eye_np, np.asarray(target, np.float64) - eye_np, h_fov, aspect)


def camera_rays(
    cam: Camera, width: int, height: int, spp: int, device="cpu",
    anti_aliasing: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(origins, dirs), each (spp * height * width, 3) float32 on ``device``;
    dirs are unit length, order is sample-major then row-major."""
    if anti_aliasing:
        raise NotImplementedError(
            "anti_aliasing: AA jitter (threefry uniform bits) is not ported yet"
        )
    f32 = torch.float32
    xs = (torch.arange(width, dtype=f32, device=device) + 0.5) / width * 2.0 - 1.0
    ys = 1.0 - (torch.arange(height, dtype=f32, device=device) + 0.5) / height * 2.0
    fx = xs[None, None, :].expand(spp, height, width)
    fy = ys[None, :, None].expand(spp, height, width)

    def vec(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    hw = torch.tensor(cam.half_width, dtype=f32, device=device)
    hh = torch.tensor(cam.half_height, dtype=f32, device=device)
    dirs = (
        fx[..., None] * (vec(cam.right) * hw)
        + fy[..., None] * (vec(cam.up) * hh)
        + vec(cam.forward)
    )
    dirs = normalize(dirs).reshape(-1, 3)
    origins = vec(cam.eye).expand(dirs.shape).contiguous()
    return origins, dirs
