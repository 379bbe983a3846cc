"""Bind and launch the CUDA Mamba-1 selective-scan kernel.

The kernel (``csrc/mamba_scan.cu``) is the Hopper counterpart of the
Pallas TPU kernel ``repro/kernels/mamba_scan.py::mamba_scan``, and also
writes the final state ``h_last``. It is built with the port's other
kernels into one library on first use (:mod:`repro_torch.kernels.build`);
nothing here runs at import time.

:data:`launches` counts kernel launches: :func:`launch` adds one each time
the kernel is launched, and nothing else touches it except a caller
resetting it to 0.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .build import library

__all__ = ["MAX_STATE", "build", "launch"]

MAX_STATE = 64

#: Kernel launches since import (or since a caller last reset it to 0).
launches = 0


@functools.cache
def build() -> ctypes.CDLL:
    """Build (or reuse) the kernel library and bind this kernel's C entry
    points."""
    lib = library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mamba_scan_fwd.argtypes = [ptr] * 8 + [i32] * 4 + [ptr]
    lib.mamba_scan_fwd.restype = i32
    lib.mamba_scan_error_string.argtypes = [i32]
    lib.mamba_scan_error_string.restype = ctypes.c_char_p
    return lib


def launch(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
           y: torch.Tensor, h_last: torch.Tensor) -> None:
    """Launch the kernel on the current stream; the caller has validated
    every argument (:func:`repro_torch.kernels.ops.mamba_scan`). Raises if
    the runtime refuses the launch."""
    global launches
    lib = build()
    B, L, Di = u.shape
    N = A.shape[1]
    with torch.cuda.device(u.device):
        err = lib.mamba_scan_fwd(
            u.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            B, L, Di, N, torch.cuda.current_stream(u.device).cuda_stream)
    if err != 0:
        msg = lib.mamba_scan_error_string(err).decode()
        raise RuntimeError(f"mamba_scan kernel launch failed: {msg}")
    launches += 1
