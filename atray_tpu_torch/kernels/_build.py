"""Build, load and count the port's CUDA kernels.

``load()`` compiles every ``*.cu`` under ``atray_tpu_torch/csrc/`` with
``nvcc`` (one process per source, all started together) and links the
objects into one shared library with a plain C interface, loads it with
ctypes, and caches it for the process. The library lives in the git-ignored
``atray_tpu_torch/_build/`` under a name keyed by a hash of the sources and
flags, so a checkout builds what it needs at first use and never loads a
stale library. A failed build raises with nvcc's stderr. Nothing here runs
at import time: the CPU test suite imports every module without nvcc.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` (Hopper), ``--fmad=false``
(the kernels do the plain versions' IEEE ops in the same order) and no
fast-math or flush-to-zero flag, because face ids travel as denormal floats.
"""

from __future__ import annotations

import ctypes
import dataclasses
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LINK_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-shared"]

_P = ctypes.c_void_p
_SIGNATURES = {
    # rays, alive, n, node records, shaded records, leaf planes, leaf size,
    # 6 outputs, the two stats planes (or null), stream
    "atray_wide_shade": (
        [_P] * 7 + [ctypes.c_longlong] + [_P] * 3 + [ctypes.c_int] + [_P] * 9
    ),
    "atray_wide_shade_stack_cap": [],
    # cols, idx, out, planes, lanes, planes a group, stream
    "atray_lane_take": [_P, _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P],
    "atray_lane_scatter": [_P, _P, _P, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P],
    # rays, n, node records, stride-16 records, leaf planes, leaf size,
    # 4 outputs, stream
    "atray_wide_exact": (
        [_P, _P, ctypes.c_longlong, _P, _P, _P, ctypes.c_int] + [_P] * 5
    ),
    "atray_wide_exact_stack_cap": [],
    "atray_treelet_phase_a": (
        [_P] * 7 + [ctypes.c_longlong, _P, ctypes.c_int, ctypes.c_int] + [_P] * 3
    ),
    "atray_treelet_phase_a_max_k": [],
    # pairs, ptid, n, leaf planes, shaded records, leaf size, leaves a
    # treelet, 6 outputs, stream
    "atray_treelet_phase_b": (
        [_P] * 7 + [ctypes.c_longlong, _P, _P] + [ctypes.c_int] * 2 + [_P] * 7
    ),
    # rays, n, node records, stride-16 records, leaf size, 4 outputs, stream
    "atray_ppacket": [_P, _P, ctypes.c_longlong, _P, _P, ctypes.c_int] + [_P] * 5,
    # the TreePack lineage walks: rays, n, node records (the frustum walk
    # then num_nodes), stride-16 records, leaf size, 4 outputs, visit
    # stats, stream; the frustum walk's shared memory a block
    "atray_packet_walk": [_P, _P, ctypes.c_longlong, _P, _P, ctypes.c_int] + [_P] * 6,
    "atray_frustum_walk": (
        [_P, _P, ctypes.c_longlong, _P, ctypes.c_int, _P, ctypes.c_int] + [_P] * 6
    ),
    "atray_frustum_walk_smem": [ctypes.c_int],
    # the 8-wide lineage walks: rays, n, node records, stride-16 records,
    # leaf size, their stack and queue caps, 4 outputs, visit stats (the
    # persistent walk then its bundle counter and grid warps), stream; each
    # one's shared memory a block, and the persistent grid, at a leaf size
    "atray_wide_frustum": [_P, _P, ctypes.c_longlong, _P, _P] + [ctypes.c_int] * 3 + [_P] * 6,
    "atray_persistent_wide": (
        [_P, _P, ctypes.c_longlong, _P, _P] + [ctypes.c_int] * 3 + [_P] * 6 + [ctypes.c_int, _P]
    ),
    "atray_wide_frustum_smem": [ctypes.c_int],
    "atray_persistent_wide_smem": [ctypes.c_int],
    "atray_persistent_wide_grid": [ctypes.c_int],
    # the probes of the lane routing (``probes/``): operands, output, sizes, stream
    "atray_probe_dot": [_P, _P, _P] + [ctypes.c_int] * 4 + [_P],
    "atray_probe_dot_bf16": [_P, _P, _P, ctypes.c_int, ctypes.c_int, _P],
    "atray_probe_route_loop": [_P] * 4 + [ctypes.c_int] * 2 + [_P],
    "atray_probe_route_dyn": [_P] * 5,
    "atray_probe_route_nested": [_P] * 5 + [ctypes.c_int] * 3 + [_P],
    "atray_probe_route_bigread": [_P, _P, ctypes.c_int, _P, _P, _P, ctypes.c_int, _P],
    "atray_probe_take_rm": [_P, _P, _P, ctypes.c_int, ctypes.c_int, _P],
    "atray_probe_stream_take": [_P, _P, _P] + [ctypes.c_int] * 3 + [_P],
}


@dataclasses.dataclass
class Counter:
    """Per-kernel counts: ``launches`` of the CUDA kernel (bumped by the
    wrapper where it launches) and ``plain_calls`` of the plain version."""

    launches: int = 0
    plain_calls: int = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0


COUNTERS: Dict[str, Counter] = {
    name: Counter() for name in ("wide_shade", "lane_take", "lane_scatter", "wide_exact",
                                 "treelet_phase_a", "treelet_phase_b", "ppacket",
                                 "packet_walk", "frustum_walk", "wide_frustum",
                                 "persistent_wide",
                                 # the probes, one per TPU probe kernel (P1-P11)
                                 "probe_dot_t", "probe_dot_n", "probe_dot_bf16", "probe_dot_k",
                                 "probe_dot_indep", "probe_route_loop", "probe_route_dyn",
                                 "probe_route_nested", "probe_route_bigread", "probe_take_rm",
                                 "probe_stream_take")
}


class _Loaded:
    lib: Optional[ctypes.CDLL] = None
    log: str = ""        # ptxas resource lines of this process's build


_loaded = _Loaded()


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")) + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda/bin)")


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"libatray_kernels-{h.hexdigest()[:16]}.so")


def _compile(lib_path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cu = [s for s in _sources() if s.endswith(".cu")]
        objs = [os.path.join(tmp, os.path.basename(src) + ".o") for src in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(cu, objs)]
        errs = [proc.communicate()[1] for proc in procs]      # waits for every one
        _loaded.log += "".join(ln + "\n" for err in errs for ln in err.splitlines()
                               if "ptxas info" in ln or "bytes stack frame" in ln)
        failed = [f"{os.path.basename(src)} (exit {proc.returncode}):\n{err}"
                  for src, proc, err in zip(cu, procs, errs) if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        so = os.path.join(tmp, "lib.so")
        proc = subprocess.run([nvcc, *LINK_FLAGS, "-o", so, *objs],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(so, lib_path)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use in this process."""
    if _loaded.lib is None:
        path = library_path()
        if not os.path.exists(path):
            _compile(path)
        lib = ctypes.CDLL(path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded.lib = lib
    return _loaded.lib


def check(rc: int, name: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")
