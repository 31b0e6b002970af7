"""ctypes loader for the native C++ neighbor search.

The C++ source is the reference package's ``pynngp_tpu/cpp/nngp_native.cpp``,
read by path and compiled with g++ at first use into ``build/pynngp_tpu_torch/``
at the root of the checkout.  It is not imported through ``pynngp_tpu``:
importing that package pulls in JAX, which the port never needs.  When g++ is
missing, :mod:`pynngp_tpu_torch.neighbors` takes its scipy/numpy path, which
gives the same table.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading

import numpy as np

__all__ = ["get_lib", "native_available", "neighbor_table"]

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "pynngp_tpu", "cpp", "nngp_native.cpp")
BUILD_DIR = os.path.join(_ROOT, "build", "pynngp_tpu_torch")


class _NativeLib:
    """Build-once, load-once holder for the shared library."""

    def __init__(self):
        self._lock = threading.Lock()
        self._lib = None
        self._failed = False

    def _lib_path(self) -> str:
        with open(_SRC, "rb") as fh:
            digest = hashlib.sha256(fh.read()).hexdigest()[:16]
        return os.path.join(BUILD_DIR, f"libnngp_native-{digest}.so")

    @staticmethod
    def _build(lib_path: str) -> bool:
        if shutil.which("g++") is None:
            print("pynngp_tpu_torch: g++ not found; using the scipy neighbor "
                  "search", file=sys.stderr)
            return False
        try:
            os.makedirs(BUILD_DIR, exist_ok=True)
        except OSError:
            return False
        tmp = lib_path + f".tmp{os.getpid()}"
        flag_sets = (["-O3", "-march=native", "-fopenmp"], ["-O3"])
        for flags in flag_sets:
            cmd = ["g++", *flags, "-shared", "-fPIC", "-o", tmp, _SRC]
            try:
                subprocess.run(cmd, check=True, capture_output=True, timeout=120)
            except (subprocess.CalledProcessError, subprocess.TimeoutExpired):
                continue
            os.replace(tmp, lib_path)
            return True
        print("pynngp_tpu_torch: native build failed; using the scipy "
              "neighbor search", file=sys.stderr)
        return False

    def get(self):
        with self._lock:
            if self._lib is not None or self._failed:
                return self._lib
            if not os.path.exists(_SRC):
                self._failed = True
                return None
            path = self._lib_path()
            if not os.path.exists(path) and not self._build(path):
                self._failed = True
                return None
            try:
                lib = ctypes.CDLL(path)
            except OSError:
                self._failed = True
                return None
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            lib.nngp_neighbor_table.argtypes = [
                f64p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p, u8p,
            ]
            lib.nngp_neighbor_table.restype = None
            self._lib = lib
            return lib


_NATIVE = _NativeLib()


def get_lib():
    return _NATIVE.get()


def native_available() -> bool:
    return get_lib() is not None


def neighbor_table(pts_ordered: np.ndarray, m: int):
    """(nn_idx, nn_mask) of the m nearest preceding neighbors (ordered space)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native neighbor search is not available")
    pts = np.ascontiguousarray(pts_ordered, np.float64)
    n, d = pts.shape
    nn_idx = np.zeros((n, m), np.int32)
    nn_mask = np.zeros((n, m), np.uint8)
    lib.nngp_neighbor_table(pts, n, d, m, nn_idx, nn_mask)
    return nn_idx, nn_mask.astype(bool)
