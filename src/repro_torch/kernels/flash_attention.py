"""Bind and launch the CUDA flash-attention kernels.

Two kernels are the Hopper counterparts of the Pallas TPU kernel
``repro/kernels/flash_attention.py::flash_attention``, on two routes that
:func:`route` chooses before each launch:

* ``"wgmma"`` (``csrc/flash_attention_sm90.cu``): bf16 on the tensor
  cores, fed by TMA, for head dims that are a multiple of 16 up to
  :data:`MAX_HEAD_DIM` (256) on 16-byte-aligned tensors;
* ``"simt"`` (``csrc/flash_attention.cu``): everything else the wrapper
  takes (fp32, other head dims, unaligned tensors) up to
  :data:`MAX_SIMT_HEAD_DIM` (128), on the fp32 pipes. A call above that
  which the wgmma route does not take raises.

Both are built with the port's other kernels into one library on first
use (:mod:`repro_torch.kernels.build`); nothing here runs at import time.
A failed build or launch of either raises: neither route falls back to the
other.

:data:`launches` counts kernel launches on both routes and
:data:`route_launches` counts them by route: :func:`launch` adds one to
both each time it launches a kernel, and nothing else touches them except
a caller resetting them to 0.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from .build import library

__all__ = ["MAX_HEAD_DIM", "MAX_SIMT_HEAD_DIM", "ROUTES", "build",
           "launch", "max_head_dim", "route", "tolerance"]

#: the largest head dim of the wgmma route (bf16; 144..256 pad to 256)
MAX_HEAD_DIM = 256
#: the largest head dim of the SIMT route (fp32, and what wgmma refuses)
MAX_SIMT_HEAD_DIM = 128
ROUTES = ("wgmma", "simt")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: Kernel launches since import (or since a caller last reset it to 0).
launches = 0
#: The same launches by route.
route_launches = {r: 0 for r in ROUTES}


def route(dtype: torch.dtype, hd: int, aligned: bool) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` for bf16 with a head dim
    that is a multiple of 16 in [16, 256] when every tensor starts on a
    16-byte boundary (what TMA and the tensor cores take), else
    ``"simt"`` (which takes head dims up to 128)."""
    if (dtype == torch.bfloat16 and hd % 16 == 0
            and 16 <= hd <= MAX_HEAD_DIM and aligned):
        return "wgmma"
    return "simt"


def max_head_dim(dtype: torch.dtype) -> int:
    """The largest head dim a call in ``dtype`` may have: bf16 reaches
    the wgmma route's 256 (a multiple of 16 on aligned tensors above
    128), fp32 the SIMT route's 128."""
    return MAX_HEAD_DIM if dtype == torch.bfloat16 else MAX_SIMT_HEAD_DIM


def tolerance(route_name: str, dtype: torch.dtype,
              v: torch.Tensor) -> tuple[float, float]:
    """(atol, rtol) of a kernel against its plain version
    (``|got - want| <= atol + rtol |want|``) on the given route.

    fp32: 2e-5 both, the summation order being the only difference. bf16
    on the SIMT route: one output ulp (2**-7 relative), since kernel and
    plain version compute in fp32 and each rounds once. bf16 on the wgmma
    route adds one rounding: the tensor cores take p in bf16, so each p
    moves by at most 2**-9 |p| (round to nearest, 8 significant bits),
    while l sums the fp32 p. The output ``sum_j p_j v_j / l`` therefore
    moves by at most ``2**-9 sum_j p_j |v_j| / l <= 2**-9 max|v|`` before
    its own rounding, and the bound is ``2**-9 max|v| + 2**-7 |want|``.
    Q.K^T adds nothing of that size: bf16 q and k multiply exactly and
    only the fp32 summation order differs."""
    if dtype == torch.float32:
        return 2e-5, 2e-5
    if route_name == "wgmma":
        return 2.0 ** -9 * float(v.detach().abs().max()), 2.0 ** -7
    return 1e-6, 2.0 ** -7


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
    lib.flash_attention_sm90_fwd.argtypes = [
        ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32,
        ctypes.c_float, ptr]
    lib.flash_attention_sm90_fwd.restype = i32
    lib.flash_attention_error_string.argtypes = [i32]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, causal: bool, window) -> None:
    """Launch the kernel of :func:`route` on the current stream; the caller
    has validated every argument
    (:func:`repro_torch.kernels.ops.flash_attention`). q, out: (B, Sq, Hq,
    hd); k, v: (B, Sk, Hkv, hd). Raises if the runtime refuses the
    launch."""
    global launches
    lib = build()
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    aligned = all(t.data_ptr() % 16 == 0 for t in (q, k, v, out))
    which = route(q.dtype, hd, aligned)
    if which == "simt" and hd > MAX_SIMT_HEAD_DIM:
        raise ValueError(f"head dim {hd} takes the wgmma route only (bf16, "
                         f"a multiple of 16, 16-byte-aligned tensors); the "
                         f"SIMT route stops at {MAX_SIMT_HEAD_DIM}")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    dims = (B, Sq, Sk, Hq, Hkv, hd, int(causal), int(window or 0),
            1.0 / math.sqrt(hd))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if which == "wgmma":
            err = lib.flash_attention_sm90_fwd(*ptrs, *dims, stream)
        else:
            err = lib.flash_attention_fwd(*ptrs, _DTYPES[q.dtype], *dims,
                                          stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed ({which} "
                           f"route): {msg}")
    launches += 1
    route_launches[which] += 1
