"""Bind and launch the CUDA flash-attention kernel.

The kernel (``csrc/flash_attention.cu``) is the Hopper counterpart of the
Pallas TPU kernel ``repro/kernels/flash_attention.py::flash_attention``.
It is built with the port's other kernels into one library on first use
(:mod:`repro_torch.kernels.build`); nothing here runs at import time.

:data:`launches` counts kernel launches: :func:`launch` adds one each time
the kernel is launched, and nothing else touches it except a caller
resetting it to 0.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .build import library

__all__ = ["MAX_HEAD_DIM", "build", "launch"]

MAX_HEAD_DIM = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches since import (or since a caller last reset it to 0).
launches = 0


@functools.cache
def build() -> ctypes.CDLL:
    """Build (or reuse) the kernel library and bind this kernel's C entry
    points."""
    lib = library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i32,
        ctypes.c_float, ptr]
    lib.flash_attention_fwd.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool, window) -> None:
    """Launch the kernel on the current stream; the caller has validated
    every argument (:func:`repro_torch.kernels.ops.flash_attention`).
    q, out: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd). Raises if the runtime
    refuses the launch."""
    global launches
    lib = build()
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], B, Sq, Sk, Hq, Hkv, hd, int(causal),
            int(window or 0), 1.0 / math.sqrt(hd),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg}")
    launches += 1
