"""Scene authoring: SoA dataclasses, procedural meshes, host transforms."""

from atray_tpu_torch.scene import procedural, transforms
from atray_tpu_torch.scene.objio import load_obj, save_obj
from atray_tpu_torch.scene.data import (
    Materials,
    Planes,
    Scene,
    Spheres,
    TriMesh,
    build_scene,
    make_materials,
    merge_meshes,
)

__all__ = [
    "Materials", "Planes", "Scene", "Spheres", "TriMesh", "build_scene",
    "load_obj", "make_materials", "merge_meshes", "procedural", "save_obj", "transforms",
]
