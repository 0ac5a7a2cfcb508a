"""Build the package's native sources and bind them with ctypes.

Each `csrc/<name>.cu` (a CUDA kernel, nvcc for `sm_90a`) or
`csrc/<name>.cpp` (host code, g++) exposes a plain C interface and is
compiled on first use (or by `build`, which runs one compiler per source in
parallel) into `_build/<name>-<hash of the source>.so`; a changed source
gets a new file, so a stale library is never loaded. The first load of
one of the kernels a model's forward launches (`MODEL_SOURCES`) builds all
of them together. Nothing is compiled or loaded at import time: the CPU
tests import every module on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Sequence

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
# The CUDA sources a model's forward or training step launches.
MODEL_SOURCES = ("conv1", "roi_align", "nms", "affine")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}        # name -> nvcc's ptxas report


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                       "kernels are built from csrc/ at first use")


def _gxx() -> str:
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found on PATH: the host sources in csrc/ "
                           "are built at first use")
    return gxx


def _source(name: str) -> str:
    cu = os.path.join(CSRC_DIR, f"{name}.cu")
    return cu if os.path.exists(cu) else os.path.join(CSRC_DIR, f"{name}.cpp")


def _compile_cmd(src: str) -> list:
    if src.endswith(".cu"):
        return [_nvcc(), *NVCC_FLAGS]
    return [_gxx(), *GXX_FLAGS]


def _so_path(name: str) -> str:
    src = _source(name)
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"{name}-{digest}.so")


def build(names: Sequence[str]) -> None:
    """Compile every missing `csrc/<name>.cu` or `.cpp`, one compiler each,
    all started together; raise if any fails."""
    procs = []
    for name in names:
        so = _so_path(name)
        if os.path.exists(so):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        src = _source(name)
        procs.append((name, src, so, tmp, subprocess.Popen(
            [*_compile_cmd(src), "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)))
    failed = []
    for name, src, so, tmp, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{os.path.basename(proc.args[0])} failed for "
                          f"{src}:\n{err}")
            continue
        os.replace(tmp, so)
        build_logs[name] = err
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` or `.cpp` if needed (with the rest of
    `MODEL_SOURCES` if it is one of them) and return the loaded library."""
    with _lock:
        if name in _libs:
            return _libs[name]
        build(MODEL_SOURCES if name in MODEL_SOURCES else [name])
        lib = ctypes.CDLL(_so_path(name))
        if _source(name).endswith(".cu"):
            lib.dat_error_string.argtypes = [ctypes.c_int]
            lib.dat_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a kernel's C entry."""
    if err != 0:
        msg = lib.dat_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
