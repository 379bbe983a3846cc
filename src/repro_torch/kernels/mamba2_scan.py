"""Bind and launch the CUDA Mamba-2 scan kernel (K3's Mamba-2 route).

The kernel (``csrc/mamba2_scan.cu``, ``mamba_scan_mamba2_kernel``) runs a
Mamba-2 prompt's scan over every head and B/C group in one launch, one
decay a head-step, reading x, B and C in the activation dtype as strided
views of the in-projection. Its plain version is
:func:`repro_torch.kernels.ref.mamba2_scan_ref`. It is built with the
port's other kernels into one library on first use
(:mod:`repro_torch.kernels.build`); nothing here runs at import time.

:data:`launches` counts kernel launches: :func:`launch` adds one each time
the kernel is launched, and nothing else touches it except a caller
resetting it to 0. With :mod:`repro_torch.obs` on, each launch also counts
one ``mamba.scan_kernel``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from .. import obs
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
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mamba2_scan_fwd.argtypes = [ptr] * 8 + [i64] * 6 + [i32] * 7 + [ptr]
    lib.mamba2_scan_fwd.restype = i32
    lib.mamba2_scan_error_string.argtypes = [i32]
    lib.mamba2_scan_error_string.restype = ctypes.c_char_p
    return lib


def launch(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
           y: torch.Tensor, h_last: torch.Tensor) -> None:
    """Launch the kernel on the current stream; the caller has validated
    every argument (:func:`repro_torch.kernels.ops.mamba2_scan`). x: (B,
    L, H, P) and Bm, Cm: (B, L, G, N), each with its last two dims
    contiguous; y: (B, L, H, P) in x's dtype and h_last: (B, H, P, N),
    contiguous. Raises if the runtime refuses the launch."""
    global launches
    lib = build()
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    with torch.cuda.device(x.device):
        err = lib.mamba2_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), D.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            x.stride(0), x.stride(1), Bm.stride(0), Bm.stride(1),
            Cm.stride(0), Cm.stride(1), B, L, H, P, G, N,
            int(x.dtype == torch.bfloat16),
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        msg = lib.mamba2_scan_error_string(err).decode()
        raise RuntimeError(f"mamba2_scan kernel launch failed: {msg}")
    launches += 1
    obs.count("mamba.scan_kernel", 1)
