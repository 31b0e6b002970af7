"""ctypes loader for the native C++ host preprocessing: the neighbor
search, the children (reverse) index, the moral-graph colouring and the
max-min ordering.

The C++ source is the reference package's ``pynngp_tpu/cpp/nngp_native.cpp``,
read by path and compiled with g++ at first use into ``build/pynngp_tpu_torch/``
at the root of the checkout.  It is not imported through ``pynngp_tpu``:
importing that package pulls in JAX, which the port never needs.  When g++ is
missing, :mod:`pynngp_tpu_torch.neighbors` takes its scipy/numpy paths, which
give the same tables.
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

__all__ = ["get_lib", "native_available", "neighbor_table", "children_table",
           "color_moral", "order_maxmin"]

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
            lib.nngp_children_table.argtypes = [
                i32p, u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ]
            lib.nngp_children_table.restype = ctypes.c_int32
            lib.nngp_color_moral.argtypes = [
                i32p, u8p, i32p, i32p, u8p,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, i32p,
            ]
            lib.nngp_color_moral.restype = ctypes.c_int32
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            lib.nngp_order_maxmin.argtypes = [
                f64p, ctypes.c_int32, ctypes.c_int32, i64p,
            ]
            lib.nngp_order_maxmin.restype = ctypes.c_int32
            self._lib = lib
            return lib


_NATIVE = _NativeLib()


def get_lib():
    return _NATIVE.get()


def native_available() -> bool:
    return get_lib() is not None


def _require_lib():
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native host library is not available")
    return lib


def neighbor_table(pts_ordered: np.ndarray, m: int):
    """(nn_idx, nn_mask) of the m nearest preceding neighbors (ordered space)."""
    lib = _require_lib()
    pts = np.ascontiguousarray(pts_ordered, np.float64)
    n, d = pts.shape
    nn_idx = np.zeros((n, m), np.int32)
    nn_mask = np.zeros((n, m), np.uint8)
    lib.nngp_neighbor_table(pts, n, d, m, nn_idx, nn_mask)
    return nn_idx, nn_mask.astype(bool)


def children_table(nn_idx: np.ndarray, nn_mask: np.ndarray):
    """(child_idx, child_slot, child_mask), each (n, max_children): the sites
    that condition on site i and i's slot in their neighbor sets.  The first
    call sizes the table, the second fills it."""
    lib = _require_lib()
    nn_idx = np.ascontiguousarray(nn_idx, np.int32)
    mask_u8 = np.ascontiguousarray(nn_mask, np.uint8)
    n, m = nn_idx.shape
    max_c = int(lib.nngp_children_table(nn_idx, mask_u8, n, m, 0, None, None,
                                        None))
    child_idx = np.zeros((n, max_c), np.int32)
    child_slot = np.zeros((n, max_c), np.int32)
    child_mask = np.zeros((n, max_c), np.uint8)
    lib.nngp_children_table(
        nn_idx, mask_u8, n, m, max_c,
        child_idx.ctypes.data_as(ctypes.c_void_p),
        child_slot.ctypes.data_as(ctypes.c_void_p),
        child_mask.ctypes.data_as(ctypes.c_void_p),
    )
    return child_idx, child_slot, child_mask.astype(bool)


def color_moral(nn_idx, nn_mask, child_idx, child_slot, child_mask):
    """(n,) int32 balanced greedy colouring of the moral graph."""
    lib = _require_lib()
    n, m = nn_idx.shape
    colors = np.zeros(n, np.int32)
    lib.nngp_color_moral(
        np.ascontiguousarray(nn_idx, np.int32),
        np.ascontiguousarray(nn_mask, np.uint8),
        np.ascontiguousarray(child_idx, np.int32),
        np.ascontiguousarray(child_slot, np.int32),
        np.ascontiguousarray(child_mask, np.uint8),
        n, m, child_idx.shape[1], colors,
    )
    return colors


def order_maxmin(coords: np.ndarray):
    """(n,) int64 exact max-min ordering for d <= 3, or None where the
    native library is missing or refuses the input (d > 3); the caller then
    takes the Python lazy-heap path (``neighbors.order_maxmin``)."""
    lib = get_lib()
    if lib is None:
        return None
    pts = np.ascontiguousarray(coords, np.float64)
    n, d = pts.shape
    if d > 3:
        return None
    order = np.zeros(n, np.int64)
    rc = lib.nngp_order_maxmin(pts, n, d, order)
    return order if rc == 0 else None
