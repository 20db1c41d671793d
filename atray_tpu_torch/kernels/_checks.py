"""Input checks shared by the hit-kernel wrappers: rays and the
``TreePack`` / ``WideBVH`` tables. Each returns the one device of the call
and raises on anything a kernel does not take."""

from __future__ import annotations

import torch

from atray_tpu_torch.accel.pack import PACK_NODE_WORDS, TRIS_PER_ROW
from atray_tpu_torch.accel.wide import NODE_WORDS


def check_rays(orig: torch.Tensor, dirn: torch.Tensor, kernel: str) -> torch.device:
    """(R, 3) float32 contiguous origins and directions on one CPU or CUDA device."""
    dev = orig.device
    for name, x in (("orig", orig), ("dirn", dirn)):
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != 3 or x.device != dev:
            raise TypeError(f"{name} must be an (R, 3) float32 tensor on one device")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if orig.shape != dirn.shape:
        raise TypeError("orig and dirn must have one shape")
    if dev.type not in ("cpu", "cuda"):
        raise TypeError(f"no {kernel} kernel for device {dev}")
    return dev


def _check_tables(owner: str, tabs: dict, dev: torch.device) -> None:
    for name, (tab, dtype) in tabs.items():
        if not isinstance(tab, torch.Tensor) or tab.device != dev or tab.dtype != dtype:
            raise TypeError(f"{owner}.{name} must be a {dtype} tensor on {dev}: "
                            f"call .to(device)")
        if not tab.is_contiguous():
            raise ValueError(f"{owner}.{name} must be contiguous")


def _check_leaf_rows(tris, leaf_size: int, owner: str) -> None:
    if tris.dim() != 2 or tris.shape[1] != 128:
        raise ValueError(f"{owner}.tris must be (rows, 128)")
    if leaf_size > TRIS_PER_ROW and leaf_size % TRIS_PER_ROW:
        raise ValueError("leaf_size must be <= 8 or a multiple of 8")


def check_treepack(pack, orig: torch.Tensor, dirn: torch.Tensor, kernel: str,
                   derived: bool = False) -> torch.device:
    """Rays and a ``TreePack`` uploaded to their device. With ``derived``,
    on a CUDA device only, also the kernel's node records ``cnodes`` (built
    here at first use): device, dtype, shape and 16-byte alignment."""
    dev = check_rays(orig, dirn, kernel)
    _check_tables("pack", {"nodebox": (pack.nodebox, torch.float32),
                           "ctrl": (pack.ctrl, torch.int32),
                           "tris": (pack.tris, torch.float32)}, dev)
    k = pack.num_nodes
    if pack.nodebox.shape != (6, k) or pack.ctrl.shape != (2, k):
        raise ValueError("pack node tables do not match num_nodes")
    _check_leaf_rows(pack.tris, pack.leaf_size, "pack")
    if derived and dev.type == "cuda":
        nodes = pack.cnodes
        _check_tables("pack", {"cnodes": (nodes, torch.int32)}, dev)
        if nodes.shape != (k, PACK_NODE_WORDS):
            raise ValueError("pack.cnodes does not match num_nodes")
        if nodes.data_ptr() % 16 or pack.tris.data_ptr() % 16:
            raise ValueError("pack.cnodes and pack.tris must be 16-byte aligned")
    return dev


def check_wide(accel, orig: torch.Tensor, dirn: torch.Tensor, kernel: str,
               stack_cap: int, derived: bool = False) -> torch.device:
    """Rays and a ``WideBVH`` uploaded to their device, shallow enough for
    a walk stack of ``stack_cap`` entries (``8 * (max_depth + 2)``). With
    ``derived``, on a CUDA device only, also the kernel's derived tables
    ``cnodes`` and ``cleaves`` (built here at first use): device, dtype,
    shape and 16-byte alignment."""
    dev = check_rays(orig, dirn, kernel)
    _check_tables("accel", {"cboxes": (accel.cboxes, torch.float32),
                            "clinks": (accel.clinks, torch.int32),
                            "tris": (accel.tris, torch.float32)}, dev)
    w = accel.num_nodes
    if accel.cboxes.shape != (w, 128) or accel.clinks.shape != (8, w):
        raise ValueError("accel node tables do not match num_nodes")
    _check_leaf_rows(accel.tris, accel.leaf_size, "accel")
    if 8 * (accel.max_depth + 2) > stack_cap:
        raise ValueError(
            f"wide depth {accel.max_depth} needs a stack of "
            f"{8 * (accel.max_depth + 2)} > STACK_CAP {stack_cap}")
    if derived and dev.type == "cuda":
        _check_derived(accel, dev)
    return dev


def _check_derived(accel, dev: torch.device) -> None:
    _check_tables("accel", {"caxis": (accel.caxis, torch.int32)}, dev)
    rows_per_leaf = accel.rows_per_leaf
    rows = accel.tris.shape[0]
    if rows % rows_per_leaf:
        raise ValueError("accel.tris does not hold whole leaves")
    lrec = TRIS_PER_ROW * rows_per_leaf
    nodes, leaves = accel.cnodes, accel.cleaves
    _check_tables("accel", {"cnodes": (nodes, torch.int32), "cleaves": (leaves, torch.float32)},
                  dev)
    if nodes.shape != (accel.num_nodes, NODE_WORDS):
        raise ValueError("accel.cnodes does not match num_nodes")
    if leaves.shape != (rows // rows_per_leaf, 9, lrec):
        raise ValueError("accel.cleaves does not match accel.tris")
    if nodes.data_ptr() % 16 or leaves.data_ptr() % 16:
        raise ValueError("accel.cnodes and accel.cleaves must be 16-byte aligned")
