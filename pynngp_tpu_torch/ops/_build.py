"""Builds the hand-written CUDA kernels and binds them to PyTorch.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
compiles every ``pynngp_tpu_torch/csrc/*.cu`` into one shared library with a
plain C interface under ``build/pynngp_tpu_torch/`` at the root of the
checkout (``build/`` is git-ignored).  The library is named by a hash of its
sources and flags, built at first use, and loaded with ctypes; tensors pass
as ``data_ptr()`` and the stream as ``torch.cuda.current_stream().cuda_stream``,
both as ``c_void_p``.  Each C entry returns ``cudaGetLastError()`` and
:func:`check` raises on a non-zero code.  There is no fallback: a missing
nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

__all__ = ["LaunchCount", "BUILD_DIR", "library", "build_info", "check",
           "stream_handle"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pynngp_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # params, d_in, d_tri, nn_idx, y, n_pad, m, chains, family, f, r, part, stream
    "vecchia_suffstats_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    # params, d_in, d_tri, nn_idx, y, n_pad, m, chains, family, part, stream
    "vecchia_grad_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
}


class LaunchCount:
    """Counts of one wrapper: ``launches`` of its CUDA kernel, and ``plain``
    calls served by its plain PyTorch version (CPU tensors only)."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.plain = 0

    def reset(self) -> None:
        self.launches = 0
        self.plain = 0


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC, "*.cu*"))):
        with open(path, "rb") as fh:
            h.update(os.path.basename(path).encode() + fh.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels of pynngp_tpu_torch "
                       "are built from source at first use")


class _KernelLibrary:
    """Build-once, load-once holder for the kernel library."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self.info: dict = {}

    def load(self):
        with self._lock:
            if self._lib is None:
                self._lib = self._load()
            return self._lib

    def _load(self):
        digest = _digest()
        lib_path = os.path.join(BUILD_DIR, f"libvecchia-{digest}.so")
        log_path = lib_path[:-3] + ".ptxas.txt"
        nvcc = _nvcc()
        version = subprocess.run(
            [nvcc, "--version"], check=True, capture_output=True, text=True
        ).stdout.strip().splitlines()[-1]
        seconds = 0.0
        cached = os.path.exists(lib_path)
        if not cached:
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib_path}.tmp{os.getpid()}"
            cmd = [nvcc, *NVCC_FLAGS, "-I", CSRC, "-o", tmp, *_sources()]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=900)
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}"
                )
            with open(log_path, "w") as fh:
                fh.write(proc.stderr)
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(lib_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.vecchia_error_string.argtypes = [ctypes.c_int]
        lib.vecchia_error_string.restype = ctypes.c_char_p
        ptxas = ""
        if os.path.exists(log_path):
            with open(log_path) as fh:
                ptxas = fh.read()
        self.info = {"seconds": seconds, "cached": cached, "nvcc": version,
                     "lib": lib_path, "ptxas": ptxas}
        return lib


_LIBRARY = _KernelLibrary()


def library():
    """The loaded kernel library, built from ``csrc/`` on first use."""
    return _LIBRARY.load()


def build_info() -> dict:
    """Seconds, cache hit, nvcc version, path and ptxas report of the build."""
    library()
    return dict(_LIBRARY.info)


def check(code: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if code != 0:
        msg = library().vecchia_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code} ({msg})")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
