"""The program's side of a cell: the configuration's inputs as the
program's scene and accel, and the per-cell numbers the metrics read off
the program's objects. The one module of the benchmark, with the drivers,
that imports ``atray_tpu_torch``."""

from __future__ import annotations

import time

import numpy as np


def scene(inp: dict):
    """The program's host scene of ``inputs.make``'s arrays."""
    from atray_tpu_torch.scene.data import Planes, TriMesh, build_scene, make_materials

    t = inp["faces"].shape[0]
    mesh = TriMesh(vertices=inp["vertices"], faces=inp["faces"], normals=inp["normals"],
                   face_normal_idx=inp["faces"], tex_coords=np.zeros((1, 2), np.float32),
                   face_tex_idx=np.full((t, 3), -1, np.int32), material_id=inp["tri_mat"])
    planes = None
    if inp["plane_off"].shape[0]:
        planes = Planes(normals=inp["plane_n"], offsets=inp["plane_off"],
                        material_id=inp["plane_mat"])
    mats = make_materials(list(zip(inp["emission"].tolist(), inp["albedo"].tolist(),
                                   inp["scatter"].tolist())))
    return build_scene([mesh], planes=planes, materials=mats)


def accel(host_scene, spec: dict):
    """(host accel, seconds of its build on the host clock)."""
    from atray_tpu_torch.accel.shaded import build_shaded_accel
    from atray_tpu_torch.accel.wide import make_accel
    from atray_tpu_torch.config import KDTreeConfig

    cfg = KDTreeConfig(leaf_size=spec["leaf_size"])
    t0 = time.perf_counter()
    if spec["kind"] == "shaded":
        acc = build_shaded_accel(host_scene, cfg)
    elif spec["kind"] == "wide":
        acc = make_accel(host_scene.mesh.vertices, host_scene.mesh.faces, cfg)
    else:
        raise ValueError(f"unknown accel kind {spec['kind']!r}")
    return acc, time.perf_counter() - t0


def table_bytes(acc, names) -> int:
    """Bytes of the accel's tables ``names``."""
    return int(sum(getattr(acc, k).nbytes for k in names))
