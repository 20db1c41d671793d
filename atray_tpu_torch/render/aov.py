"""AOV passes (``atray_tpu/render/aov.py``): one deterministic primary-ray
pass gives the compositing and denoising feature films: depth, shading
normal, albedo (modulated by the scene's texture where it has one),
emission, material id and hit mask.

The pass takes the beauty render's own hit machinery: ``nearest_hit_ids``
(the accel's walk; ``wide_shade`` for a ``ShadedWideBVH``) and the
differentiable ``resolve_hit`` recompute, so the films agree with what the
beauty pass saw. Rays go through the pixel centres, one a pixel, with no
random numbers.
"""

from __future__ import annotations

from typing import Dict

import torch

from atray_tpu_torch.core.camera import Camera, camera_rays
from atray_tpu_torch.device import resolve_device
from atray_tpu_torch.render.wavefront import (
    PRIM_TRI,
    _accel_on,
    _texture_mod_soa,
    build_face_table,
    build_face_uv,
    nearest_hit_ids,
    resolve_hit,
    resolve_material_rows,
)
from atray_tpu_torch.scene.data import Scene


def render_aovs(scene: Scene, camera: Camera, width: int, height: int, accel=None,
                device=None) -> Dict[str, torch.Tensor]:
    """The AOV films of one camera at (width, height) on ``device`` (None:
    "cuda"), in the beauty film's top-left-origin layout:

    - ``depth``       (H, W)    hit distance t; misses 0
    - ``normal``      (H, W, 3) shading normal; misses 0
    - ``albedo``      (H, W, 3) material albedo, times the texel where the
                                scene has a texture; misses 0
    - ``emission``    (H, W, 3) material emission; misses 0
    - ``material_id`` (H, W)    int32 material index; misses -1
    - ``hit``         (H, W)    float mask, 1.0 where a primitive was hit

    Differentiable where the beauty pass is (vertices, vertex normals,
    material tables, texels); the hit choice is detached."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    accel = _accel_on(accel, dev)
    orig, dirn = camera_rays(camera, width, height, 1, device=dev)
    ids = nearest_hit_ids(scene, orig, dirn, accel)
    ft = build_face_table(scene) if scene.mesh.num_faces > 0 else None
    t, normal, mat, hit = resolve_hit(scene, orig, dirn, ids, face_table=ft)
    em, al, _ = resolve_material_rows(scene, mat, hit)
    if scene.texture is not None and ft is not None:
        tr, tg, tb = _texture_mod_soa(
            scene.texture, ft, build_face_uv(scene), ids.prim_id,
            hit & (ids.prim_type == PRIM_TRI),
            orig[:, 0], orig[:, 1], orig[:, 2], dirn[:, 0], dirn[:, 1], dirn[:, 2])
        al = al * torch.stack([tr, tg, tb], dim=-1)
    hw = (height, width)
    return {
        "depth": torch.where(hit, t, 0.0).reshape(hw),
        "normal": torch.where(hit[:, None], normal, 0.0).reshape(hw + (3,)),
        "albedo": al.reshape(hw + (3,)),
        "emission": em.reshape(hw + (3,)),
        "material_id": torch.where(hit, mat, -1).reshape(hw),
        "hit": hit.to(torch.float32).reshape(hw),
    }


def aov_preview_films(aovs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Displayable (H, W, 3) films in [0, 1] from the raw AOVs. Depth is
    divided by twice the mean depth of the hit pixels (so a floor's long
    tail to the horizon does not crush the film to black; misses stay 0),
    then clamped; normals are mapped from [-1, 1] to [0, 1] (the normal-map
    encoding), misses 0; albedo and emission are clamped."""
    d = aovs["depth"]
    hitf = aovs["hit"]
    dref = torch.sum(d * hitf) / torch.clamp_min(torch.sum(hitf), 1.0)
    dmax = torch.clamp_min(2.0 * dref, 1.0e-8)
    return {
        "depth": torch.clamp(d / dmax, 0.0, 1.0)[..., None].repeat(1, 1, 3),
        "normal": torch.clamp(aovs["normal"] * 0.5 + 0.5, 0.0, 1.0) * hitf[..., None],
        "albedo": torch.clamp(aovs["albedo"], 0.0, 1.0),
        "emission": torch.clamp(aovs["emission"], 0.0, 1.0),
    }
