"""Bind and launch the CUDA GBDT inference kernel.

The kernel (``csrc/gbdt_predict.cu``) is the Hopper counterpart of the
Pallas TPU kernel ``repro/kernels/gbdt_predict.py::gbdt_predict``. It is
built with the port's other kernels into one library on first use
(:mod:`repro_torch.kernels.build`); nothing here runs at import time.

:data:`launches` counts kernel launches: :func:`launch` adds one each time
the kernel is launched, and nothing else touches it except a caller
resetting it to 0.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import library
from .ref import pairwise_program

__all__ = ["MAX_DEPTH", "build", "launch"]

MAX_DEPTH = 8

#: Kernel launches since import (or since a caller last reset it to 0).
launches = 0

#: (T, device) -> the summation program for T trees, int32 on the device
_programs: dict = {}


@functools.cache
def build() -> ctypes.CDLL:
    """Build (or reuse) the kernel library and bind this kernel's C entry
    points."""
    lib = library()
    ptr = ctypes.c_void_p
    lib.gbdt_predict_f64.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ctypes.c_int, ctypes.c_double, ptr,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ptr]
    lib.gbdt_predict_f64.restype = ctypes.c_int
    lib.gbdt_predict_tile.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.gbdt_predict_tile.restype = ctypes.c_int
    lib.gbdt_predict_error_string.argtypes = [ctypes.c_int]
    lib.gbdt_predict_error_string.restype = ctypes.c_char_p
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
