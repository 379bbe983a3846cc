"""Build, bind and launch the CUDA GBDT inference kernel.

The kernel (``csrc/gbdt_predict.cu``) is the Hopper counterpart of the
Pallas TPU kernel ``repro/kernels/gbdt_predict.py::gbdt_predict``. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, on first use, into ``build/kernels/<source hash>/`` at the root
of the checkout (a git-ignored directory), and loaded with ``ctypes``. A
library already built from the same sources is reused; a failed build
raises. Nothing here runs at import time: CPU-only machines import this
module freely and never reach the compiler.

:data:`launches` counts kernel launches: :func:`launch` adds one each time
the kernel is launched, and nothing else touches it except a caller
resetting it to 0.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

from .ref import pairwise_program

__all__ = ["MAX_DEPTH", "build", "launch"]

MAX_DEPTH = 8

#: Kernel launches since import (or since a caller last reset it to 0).
launches = 0
#: The compiler's output from the build this process ran (ptxas register
#: and shared-memory report), or None when a cached library was loaded.
build_log: "str | None" = None

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SOURCES = sorted((_PKG / "csrc").glob("*.cu"))
_BUILD_ROOT = _PKG.parent.parent / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_lib = None
_lock = threading.Lock()
#: (T, device) -> the summation program for T trees, int32 on the device
_programs: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # only when building
    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the GBDT kernel (set CUDA_HOME)")


def build() -> ctypes.CDLL:
    """Build (or reuse) the kernel library and bind its C entry points."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
        for src in _SOURCES:
            h.update(src.name.encode())
            h.update(src.read_bytes())
        out_dir = _BUILD_ROOT / h.hexdigest()[:16]
        so = out_dir / "librepro_torch_kernels.so"
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f".tmp.{os.getpid()}.so"
            cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp),
                   *map(str, _SOURCES)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        ptr = ctypes.c_void_p
        lib.gbdt_predict_f64.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_double, ptr,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr]
        lib.gbdt_predict_f64.restype = ctypes.c_int
        lib.gbdt_predict_tile.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.gbdt_predict_tile.restype = ctypes.c_int
        lib.gbdt_predict_error_string.argtypes = [ctypes.c_int]
        lib.gbdt_predict_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


@functools.lru_cache(maxsize=None)
def _fits(F: int, depth: int) -> bool:
    """Do 8 trees of this depth fit beside 64 rows of F features?"""
    return build().gbdt_predict_tile(F, depth) >= 8


def launch(X: torch.Tensor, feats: torch.Tensor, thresholds: torch.Tensor,
           leaves: torch.Tensor, base: float, out: torch.Tensor) -> None:
    """Launch the kernel on the current stream; the caller has validated
    every argument (:func:`repro_torch.kernels.ops.gbdt_predict`). Raises
    if the runtime refuses the launch."""
    global launches
    lib = build()
    n, F = X.shape
    T, depth = thresholds.shape
    if not _fits(F, depth):
        raise ValueError(f"{F} features at depth {depth} do not fit the "
                         "kernel's shared-memory tile")
    prog = _programs.get((T, X.device))
    if prog is None:
        prog = torch.tensor(pairwise_program(T) or (0,), dtype=torch.int32,
                            device=X.device)
        _programs[(T, X.device)] = prog
    # the library's runtime launches into whichever card is current
    with torch.cuda.device(X.device):
        err = lib.gbdt_predict_f64(
            X.data_ptr(), feats.data_ptr(), thresholds.data_ptr(),
            leaves.data_ptr(), prog.data_ptr(), len(pairwise_program(T)),
            float(base), out.data_ptr(), n, F, T, depth,
            torch.cuda.current_stream(X.device).cuda_stream)
    if err != 0:
        msg = lib.gbdt_predict_error_string(err).decode()
        raise RuntimeError(f"gbdt_predict kernel launch failed: {msg}")
    launches += 1
