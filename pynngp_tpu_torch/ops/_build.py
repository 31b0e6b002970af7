"""Builds the hand-written CUDA kernels and binds them to PyTorch.

``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC -c``
compiles every ``pynngp_tpu_torch/csrc/*.cu`` to its own object, all files at
once (one nvcc process each: ptxas on the unrolled m = 20 instances is the
whole cost, and the files are independent), and one ``nvcc -shared`` links
them into one library with a plain C interface under
``build/pynngp_tpu_torch/`` at the root of the checkout (``build/`` is
git-ignored).  The library is named by a hash of its sources and flags,
built at first use, and loaded with ctypes; tensors pass
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
           "stream_handle", "with_variant_counts"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "pynngp_tpu_torch")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    # params, d_in, d_tri, nn_idx, y, y_stride, v, n_pad, m, chains, family,
    # group, grid_x, smem_bytes, scratch, f, r, part, stream (v: the
    # per-site noise weights, or null; group, grid_x, smem_bytes and the
    # scratch buffer of the large-m instances: ops/geometry.py)
    "vecchia_suffstats_f32":
        [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # params, d_in, d_tri, nn_idx, y, y_stride, v, n_pad, m, chains, family,
    # group, grid_x, smem_bytes, scratch, part, stream
    "vecchia_grad_f32": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    # params, d_in, d_tri, nn_idx, y, y_stride, v, n_pad, m, chains, family,
    # group, grid_x, smem_bytes, scratch, part, b, rof, stream
    "vecchia_grad_y_f32":
        [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    # params, d_in, d_tri, nn_idx, v, n_pad, m, chains, family, group, grid_x,
    # smem_bytes, scratch, b, f, stream
    "vecchia_bf_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # the general-nu Matern instances: no family; kernel 2 takes with_nu in
    # its place
    "vecchia_suffstats_nu_f32":
        [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "vecchia_grad_nu_f32": [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "vecchia_grad_y_nu_f32":
        [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "vecchia_bf_nu_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    # the coords-layout instances: the coordinate planes in the place of the
    # distance planes, and the coordinate dimension d after m
    "vecchia_suffstats_coords_f32":
        [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "vecchia_suffstats_nu_coords_f32":
        [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "vecchia_grad_coords_f32":
        [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "vecchia_grad_y_coords_f32":
        [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "vecchia_grad_nu_coords_f32":
        [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P],
    "vecchia_grad_y_nu_coords_f32":
        [_P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "vecchia_bf_coords_f32":
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    "vecchia_bf_nu_coords_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
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


VARIANTS = ("", "_hetero", "_large", "_large_hetero", "_large_cluster",
            "_large_cluster_hetero", "_large_scratch", "_large_scratch_hetero")


def with_variant_counts(*counts: LaunchCount) -> dict:
    """{name: count} of a wrapper's counts and, for each, counts of the same
    source's launches with heterogeneous-noise weights (``<name>_hetero``:
    the same C entry), of its large-m instance (``<name>_large``: m > 32),
    of both (``<name>_large_hetero``), of the cluster body above the
    kernel's shared-memory limit (``<name>_large_cluster``, with
    ``_hetero``: up to ``geometry.CLUSTER_M``), of the scratch body above
    that (``<name>_large_scratch``, with ``_hetero``: ``geometry.M_CLUSTER``
    for kernels 1 and 3, ``geometry.M_CLUSTER_GRAD`` for kernel 2), and of
    each of these in a call over
    several cells of a mesh (``..._sharded``), counted apart so that a run
    shows which paths drove which instance."""
    out = {}
    for count in counts:
        for sfx in VARIANTS + tuple(v + "_sharded" for v in VARIANTS):
            out[count.name + sfx] = count if not sfx else LaunchCount(count.name + sfx)
    return out


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


def _compile_and_link(nvcc: str, lib_path: str) -> str:
    """Compile each source to an object in its own nvcc process, all started
    together, then link; returns the compilers' stderr (the ptxas report).
    Raises on the first failure, after every process has ended."""
    tag = f"tmp{os.getpid()}"
    objects, procs = [], []
    for src in _sources():
        stem = os.path.splitext(os.path.basename(src))[0]
        obj = os.path.join(BUILD_DIR, f"{stem}-{tag}.o")
        objects.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", CSRC, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    logs, failed = [], None
    for src, proc in zip(_sources(), procs):
        try:
            _, err = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
            err += "\n(killed after 900 s)"
        logs.append(err)
        if proc.returncode != 0 and failed is None:
            failed = (src, proc.returncode, err)
    try:
        if failed is not None:
            src, code, err = failed
            raise RuntimeError(f"nvcc failed ({code}) on {os.path.basename(src)}:"
                               f"\n{err[-8000:]}")
        tmp = f"{lib_path}.{tag}"
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objects],
                              capture_output=True, text=True, timeout=900)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr[-8000:]}")
        os.replace(tmp, lib_path)
    finally:
        for obj in objects:
            if os.path.exists(obj):
                os.unlink(obj)
    return "".join(logs)


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
            t0 = time.perf_counter()
            log = _compile_and_link(nvcc, lib_path)
            seconds = time.perf_counter() - t0
            with open(log_path, "w") as fh:
                fh.write(log)
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
