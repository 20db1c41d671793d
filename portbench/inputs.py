"""The inputs of a cell, made by the benchmark from its configuration and
handed alike to the program and to the reference.

``dragon_proxy`` is frozen here from the program's procedural generator
(``atray_tpu_torch/scene/procedural.py::dragon_proxy``, itself the JAX
package's): a unit UV sphere displaced by four octaves of seeded
sinusoidal noise, with area-weighted smooth vertex normals. A copy keeps
the scene of every cell fixed whatever later changes make to the
program's generator.
"""

from __future__ import annotations

import numpy as np


def _uv_sphere(rows: int, cols: int):
    ii = np.arange(rows + 1, dtype=np.float64)
    jj = np.arange(cols, dtype=np.float64)
    theta = ii / rows * np.pi
    phi = jj / cols * 2.0 * np.pi
    st, ct = np.sin(theta), np.cos(theta)
    sp, cp = np.sin(phi), np.cos(phi)
    v = np.stack([st[:, None] * cp[None, :], ct[:, None] * np.ones_like(sp)[None, :],
                  st[:, None] * sp[None, :]], axis=-1).reshape(-1, 3)
    i2 = np.arange(rows)[:, None]
    j2 = np.arange(cols)[None, :]
    a = i2 * cols + j2
    b = i2 * cols + (j2 + 1) % cols
    c = (i2 + 1) * cols + (j2 + 1) % cols
    d = (i2 + 1) * cols + j2
    upper = np.stack([a, b, c], axis=-1)[1:].reshape(-1, 3)
    lower = np.stack([a, c, d], axis=-1)[:-1].reshape(-1, 3)
    return v, np.concatenate([upper, lower])


def _vertex_normals(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    v64 = v.astype(np.float64)
    fn = np.cross(v64[f[:, 1]] - v64[f[:, 0]], v64[f[:, 2]] - v64[f[:, 0]])
    acc = np.zeros_like(v64)
    for c in range(3):
        np.add.at(acc, f[:, c], fn)
    norm = np.linalg.norm(acc, axis=1, keepdims=True)
    return (acc / np.maximum(norm, 1e-20)).astype(np.float32)


def dragon_proxy(target_tris: int, seed: int):
    """(vertices float32 (V, 3), faces int32 (T, 3), vertex normals)."""
    n = int(np.sqrt(target_tris / 2.0)) + 1
    v, f = _uv_sphere(n, n)
    rng = np.random.default_rng(seed)
    disp = np.zeros(v.shape[0])
    for freq in (3.0, 7.0, 13.0, 29.0):
        k = rng.normal(size=(3, 3)) * freq
        ph = rng.uniform(0, 2 * np.pi, size=3)
        disp = disp + 0.35 / freq * np.sin(v @ k.T + ph).sum(axis=1)
    v = np.ascontiguousarray(v * (1.0 + disp)[:, None], np.float32)
    f = np.ascontiguousarray(f, np.int32)
    return v, f, _vertex_normals(v, f)


def make(cfg: dict) -> dict:
    """The scene of a configuration as host arrays: ``vertices``, ``faces``,
    ``normals`` (one a vertex, indexed by the faces), ``tri_mat``,
    ``emission``, ``albedo``, ``scatter`` (row 0 the sky), ``plane_n``,
    ``plane_off``, ``plane_mat``."""
    vs, fs, ns, ms = [], [], [], []
    base = 0
    for m in cfg["meshes"]:
        if m["kind"] != "dragon_proxy":
            raise ValueError(f"unknown mesh kind {m['kind']!r}")
        v, f, n = dragon_proxy(m["target_tris"], m["seed"])
        v = v + np.asarray(m.get("translate", (0, 0, 0)), np.float32)
        vs.append(v)
        fs.append(f + base)
        ns.append(n)
        ms.append(np.full(f.shape[0], m["material"], np.int32))
        base += v.shape[0]
    mats = cfg["materials"]
    planes = cfg.get("planes", [])
    f32 = np.float32
    return {
        "vertices": np.concatenate(vs).astype(f32), "faces": np.concatenate(fs),
        "normals": np.concatenate(ns), "tri_mat": np.concatenate(ms),
        "emission": np.array([m[0] for m in mats], f32),
        "albedo": np.array([m[1] for m in mats], f32),
        "scatter": np.array([m[2] for m in mats], f32),
        "plane_n": np.array([p["normal"] for p in planes], f32).reshape(-1, 3),
        "plane_off": np.array([p["offset"] for p in planes], f32),
        "plane_mat": np.array([p["material"] for p in planes], np.int32),
    }
