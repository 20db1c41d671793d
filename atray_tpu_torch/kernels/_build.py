"""Build, load and count the port's CUDA kernels.

``load()`` compiles every ``*.cu`` under ``atray_tpu_torch/csrc/`` with
``nvcc`` into one shared library with a plain C interface, loads it with
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
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]

_P = ctypes.c_void_p
_SIGNATURES = {
    "atray_wide_shade": (
        [_P] * 7 + [ctypes.c_longlong] + [_P] * 3 + [ctypes.c_int]
        + [_P, ctypes.c_int] + [_P] * 7
    ),
    "atray_wide_shade_stack_cap": [],
    "atray_lane_take": [_P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P],
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


COUNTERS: Dict[str, Counter] = {"wide_shade": Counter(), "lane_take": Counter()}


class _Loaded:
    lib: Optional[ctypes.CDLL] = None


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"libatray_kernels-{h.hexdigest()[:16]}.so")


def _compile(lib_path: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cu = [s for s in _sources() if s.endswith(".cu")]
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed (exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


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
