"""Bind and launch the CUDA decode-attention kernel (K4), and its plain
version.

The kernel (``csrc/decode_attention.cu``) replaces no TPU kernel: the
reference's decode attention is plain einsums. It computes one new
token's GQA attention over a layer's bf16 KV cache, (B, Hkv, S_max, hd)
as ``models/attention.py`` ``attention_decode`` holds it, reading each
live cached K and V once, with the plain path's numerics (:func:`plain`:
:func:`repro_torch.kernels.ref.gqa_ref` over the decode mask). It takes
bf16 alone, the served dtype: an fp32 model's decode takes the plain path
(``attention.uses_decode_kernel``). It is built with the port's other
kernels into one library on first use (:mod:`repro_torch.kernels.build`);
nothing here runs at import time.

:func:`live_range` is the live range of the decode mask; the kernel
computes the same range on the card from ``pos`` (a host int, or a 0-d
int64 tensor on the card that a CUDA graph rewrites between replays),
and ``attention.count_positions`` counts from it.

:data:`launches` counts kernel launches: :func:`launch` adds one each
time the kernel is launched, and nothing else touches it except a caller
resetting it to 0.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from .build import library
from .ref import gqa_ref

__all__ = ["MAX_GROUP", "MAX_HEAD_DIM", "build", "is_ring", "launch",
           "live_range", "plain", "tolerance"]

#: the largest head dim (a multiple of 16) the kernel takes
MAX_HEAD_DIM = 256
#: the most query heads a KV head may have (G): a block serves them all
MAX_GROUP = 8

#: Kernel launches since import (or since a caller last reset it to 0).
launches = 0


def is_ring(S_max: int, window=None) -> bool:
    """Whether a cache of ``S_max`` slots under a sliding ``window`` is a
    ring: window-sized or smaller, position ``pos`` in slot ``pos %
    S_max``."""
    return window is not None and S_max <= window


def live_range(pos: int, S_max: int, window=None) -> tuple[int, int]:
    """The cache slots ``[lo, hi)`` that a decode step at ``pos`` attends,
    as ``attention_decode``'s mask keeps them: those up to ``pos``,
    within the window when set; on a ring (:func:`is_ring`) every slot
    once ``pos >= S_max``."""
    hi = max(0, min(pos + 1, S_max))
    if window is None or is_ring(S_max, window):
        return 0, hi
    return min(max(0, pos - window + 1), hi), hi


def plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos,
          window=None) -> torch.Tensor:
    """The kernel's function in plain torch: q (B, 1, Hq, hd) over the
    cache k, v (B, Hkv, S_max, hd) at ``pos`` (an int or a 0-d int64
    tensor), keys outside :func:`live_range` masked. Returns
    (B, 1, Hq*hd) in q's dtype."""
    S_max = k.shape[2]
    lo, hi = live_range(int(pos), S_max, window)
    kj = torch.arange(S_max, device=q.device)
    return gqa_ref(q, k, v, (kj >= lo) & (kj < hi))


def tolerance(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos,
              window=None):
    """(atol, rtol) of the kernel against :func:`plain` on the card at
    these bf16 inputs: ``|got - want| <= atol + rtol |want|``
    elementwise, ``atol`` a (B, 1, Hq*hd) tensor.

    Derived from the inputs. The products are exact (bf16 x bf16
    fits fp32's significand); only the fp32 sums' order differs. Bound
    each side's fp32 probability p~_j against the exact p_j (computed
    here in fp64) over the n live slots, with u = 2**-24 and at most one
    ulp (2u, which also covers the tensor cores' truncating sums) for
    each addition of a sum, at most n - 1 of them for n terms in any
    order:

    * score: ``|s~_j - s_j| <= d_j = 2 hd u a_j + 3u |s_j|``, with
      ``a_j = scale sum_i |q_i k_ji|`` (the sum; the scale's rounding and
      its product or quotient);
    * the max: off by at most ``d* = max_j d_j``;
    * ``e_j = exp(s_j - max)``: relative ``c_j = d_j + d* + u |s_j - max|
      + 4u`` (the subtraction; expf's 2 ulp);
    * the denominator: relative ``max_j c_j + 2nu``;
    * ``p_j = e_j / l`` (a quotient, or a product with the reciprocal):
      ``eta_j = 1.01 (c_j + max_j c_j + 2nu + 2u)``, the 1.01 for the
      second-order terms.

    Both sides' p~_j lie in ``[p_j (1 - eta_j), p_j (1 + eta_j)]``, and
    rounding is monotone, so their bf16 roundings differ by at most
    ``f_j = bf16(p_j (1 + eta_j)) - bf16(p_j (1 - eta_j))``: 0 where no
    rounding boundary falls within, one ulp where one does (the ends are
    widened by 4u more, so that fp64 -> bf16 rounding twice cannot hide
    a boundary). The p.V sums, n terms each, are each side within
    ``2nu sum_j bf16(p_j (1 + eta_j)) |v_jd|`` of exact. So before the
    output's own rounding the two differ by at most ``A_d = sum_j f_j
    |v_jd| + 4nu sum_j bf16(p_j (1 + eta_j)) |v_jd|``, and after it (half
    an ulp, 2**-8 relative, on each side) by ``(1 + 2**-8) A_d +
    2**-7 (1 + 2**-8) |want|``.

    The bound is elementwise, so a fault that moves an output element by
    more than the few one-ulp flips of p around it fails it: a slot
    dropped or added at ``pos``, at the window's edge or at a slice's
    boundary moves the rows where that slot's p is large by about
    ``p_j |v_jd - out_d|`` (tests/test_torch_decode_attention.py holds
    such faults to failing)."""
    B, _, Hq, hd = q.shape
    Hkv, S_max = k.shape[1], k.shape[2]
    lo, hi = live_range(int(pos), S_max, window)
    n, u = hi - lo, 2.0 ** -24
    scale = 1.0 / math.sqrt(hd)
    qd = q.reshape(B, Hkv, Hq // Hkv, hd).double()
    kd = k[:, :, lo:hi].double()
    s = (qd @ kd.transpose(-1, -2)) * scale               # (B, Hkv, G, n)
    a = (qd.abs() @ kd.abs().transpose(-1, -2)) * scale
    del kd
    d = 2 * hd * u * a + 3 * u * s.abs()
    x = s - s.amax(-1, keepdim=True)
    c = d + d.amax(-1, keepdim=True) + u * x.abs() + 4 * u
    eta = 1.01 * (c + c.amax(-1, keepdim=True) + 2 * n * u + 2 * u) + 4 * u
    p = torch.softmax(x, dim=-1)
    up = (p * (1 + eta)).to(torch.bfloat16).double()
    flips = up - (p * (1 - eta)).to(torch.bfloat16).double()
    va = v[:, :, lo:hi].double().abs()
    A = flips @ va + 4 * n * u * (up @ va)                 # (B, Hkv, G, hd)
    return ((1 + 2.0 ** -8) * A).reshape(B, 1, Hq * hd), \
        2.0 ** -7 * (1 + 2.0 ** -8)


@functools.cache
def _plan(B: int, Hkv: int, G: int, S_max: int, hd: int,
          index: int) -> tuple[int, int]:
    """The kernel's own launch plan on card ``index``
    (``decode_attention_plan``): the cluster size and the bytes of the
    scores' scratch in device memory (0: they fit in shared memory)."""
    lib = build()
    splits, scratch = ctypes.c_int(), ctypes.c_longlong()
    with torch.cuda.device(index):
        err = lib.decode_attention_plan(B, Hkv, G, S_max, hd,
                                        ctypes.byref(splits),
                                        ctypes.byref(scratch))
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention plan failed: {msg}")
    return splits.value, scratch.value


@functools.cache
def build() -> ctypes.CDLL:
    """Build (or reuse) the kernel library and bind this kernel's C entry
    points."""
    lib = library()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_plan.argtypes = [
        i32, i32, i32, i32, i32, ctypes.POINTER(i32),
        ctypes.POINTER(ctypes.c_longlong)]
    lib.decode_attention_plan.restype = i32
    lib.decode_attention_fwd.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ctypes.c_longlong, i32, i32, i32, i32,
        i32, i32, i32, ctypes.c_float, ptr, ptr]
    lib.decode_attention_fwd.restype = i32
    lib.decode_attention_error_string.argtypes = [i32]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, pos,
           window, out: torch.Tensor) -> None:
    """Launch the kernel on the current stream; the caller has validated
    every argument (:func:`repro_torch.kernels.ops.decode_attention`).
    q: (B, 1, Hq, hd); k, v: (B, Hkv, S_max, hd); out: (B, 1, Hq*hd), all
    bf16; ``pos`` an int or a 0-d int64 tensor on q's device, read by the
    kernel. Raises if the runtime refuses the launch."""
    global launches
    lib = build()
    B, _, Hq, hd = q.shape
    Hkv, S_max = k.shape[1], k.shape[2]
    G = Hq // Hkv
    index = q.device.index if q.device.index is not None \
        else torch.cuda.current_device()
    n, scratch_bytes = _plan(B, Hkv, G, S_max, hd, index)
    scratch = (torch.empty(scratch_bytes, dtype=torch.uint8, device=q.device)
               if scratch_bytes else None)
    on_device = isinstance(pos, torch.Tensor)
    # the score scale as the plain path's fp32 division by sqrt(hd) on
    # the card computes it: times the fp32 reciprocal of fp32 sqrt(hd)
    scale = float(np.float32(1.0) / np.float32(math.sqrt(hd)))
    with torch.cuda.device(q.device):
        err = lib.decode_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            pos.data_ptr() if on_device else None,
            0 if on_device else int(pos), B, Hkv, G, S_max, hd,
            int(window or 0), n, scale,
            None if scratch is None else scratch.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention kernel launch failed: {msg}")
    launches += 1
