"""Bind and launch the CUDA Mamba-2 decode state step (K5), and its plain
version.

The kernel (``csrc/mamba2_step.cu``) replaces no TPU kernel: the
reference's decode recurrence is plain arithmetic. It runs one token of
a Mamba-2 mixer for every sequence, head and B/C group in two launches
(``mamba2_conv_step_kernel``: the conv window, SiLU and the conv state's
shift; ``mamba2_state_step_kernel``: dt, the decay, the SSM state and y),
reading the in-projection's columns as strided views and updating the
layer's conv and fp32 SSM state in place, each state element read and
written once. Its plain version is :func:`plain`, the Mamba-2 block's
former decode step through the model's plain functions. It is built
with the port's other kernels into one library on first use
(:mod:`repro_torch.kernels.build`); nothing here runs at import time.

:data:`launches` counts kernel calls: :func:`launch` adds one each time it
launches the pair, and nothing else touches it except a caller resetting
it to 0.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .build import library

__all__ = ["MAX_CONV", "MAX_STATE", "build", "launch", "plain"]

MAX_STATE = 64
MAX_CONV = 8

#: Kernel calls (each a conv and a state launch) since import (or since a
#: caller last reset it to 0).
launches = 0


def plain(xBC: torch.Tensor, dt_raw: torch.Tensor, conv_w: torch.Tensor,
          conv_b: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor,
          D: torch.Tensor, conv_state: torch.Tensor,
          ssm_state: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain torch: the Mamba-2 block's decode
    step as it ran before the kernel, through the model's own plain
    functions (``ssm.causal_conv1d`` over the token, SiLU, the softplus
    of dt, ``ssm.mamba2_scan`` over one step with B and C of (B, 1, N)
    for one group, else (B, 1, G, N)). Arguments as
    :func:`repro_torch.kernels.ops.mamba2_state_step`; ``conv_state`` and
    ``ssm_state`` are written in place. Returns y (B, 1, H P) in xBC's
    dtype."""
    from ..models import ssm     # imports this package: not at load time
    dtype = xBC.dtype
    B, _, C = xBC.shape
    H, P, N = ssm_state.shape[1:]
    Di = H * P
    G = (C - Di) // (2 * N)
    xBC, new_conv = ssm.causal_conv1d(xBC, conv_w, conv_b,
                                      conv_state.to(dtype))
    xs, Bm, Cm = torch.split(F.silu(xBC), [Di, G * N, G * N], dim=-1)
    if G > 1:
        Bm, Cm = Bm.unflatten(-1, (G, N)), Cm.unflatten(-1, (G, N))
    dt = F.softplus(dt_raw.float() + dt_bias[None, None])
    y, h = ssm.mamba2_scan(xs.reshape(B, 1, H, P), dt, -torch.exp(A_log),
                           Bm, Cm, D, ssm_state)
    conv_state.copy_(new_conv)
    ssm_state.copy_(h)
    return y.reshape(B, 1, Di).to(dtype)


@functools.cache
def build() -> ctypes.CDLL:
    """Build (or reuse) the kernel library and bind this kernel's C entry
    points."""
    lib = library()
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mamba2_conv_step_fwd.argtypes = ([ptr, i64] + [ptr] * 4 + [i32] * 5
                                         + [ptr])
    lib.mamba2_conv_step_fwd.restype = i32
    lib.mamba2_state_step_fwd.argtypes = ([ptr, ptr, i64] + [ptr] * 5
                                          + [i32] * 6 + [ptr])
    lib.mamba2_state_step_fwd.restype = i32
    lib.mamba2_step_error_string.argtypes = [i32]
    lib.mamba2_step_error_string.restype = ctypes.c_char_p
    return lib


def launch(xBC: torch.Tensor, dt_raw: torch.Tensor, conv_w: torch.Tensor,
           conv_b: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor,
           D: torch.Tensor, conv_state: torch.Tensor,
           ssm_state: torch.Tensor, act: torch.Tensor,
           y: torch.Tensor) -> None:
    """Launch the conv kernel, then the state kernel, on the current
    stream; the caller has validated every argument
    (:func:`repro_torch.kernels.ops.mamba2_state_step`). ``act``: a (B, C)
    scratch in xBC's dtype; ``y``: (B, 1, H P) in xBC's dtype, both
    contiguous. Raises if the runtime refuses a launch."""
    global launches
    lib = build()
    B, _, C = xBC.shape
    K = conv_w.shape[1]
    H, P, N = ssm_state.shape[1:]
    G = (C - H * P) // (2 * N)
    bf16 = int(xBC.dtype == torch.bfloat16)
    with torch.cuda.device(xBC.device):
        stream = torch.cuda.current_stream(xBC.device).cuda_stream
        err = lib.mamba2_conv_step_fwd(
            xBC.data_ptr(), xBC.stride(0), conv_w.data_ptr(),
            conv_b.data_ptr(), conv_state.data_ptr(), act.data_ptr(), B, C,
            K, bf16, int(conv_state.dtype == torch.bfloat16), stream)
        if err == 0:
            err = lib.mamba2_state_step_fwd(
                act.data_ptr(), dt_raw.data_ptr(), dt_raw.stride(0),
                dt_bias.data_ptr(), A_log.data_ptr(), D.data_ptr(),
                ssm_state.data_ptr(), y.data_ptr(), B, H, P, G, N, bf16,
                stream)
    if err != 0:
        msg = lib.mamba2_step_error_string(err).decode()
        raise RuntimeError(f"mamba2_step kernel launch failed: {msg}")
    launches += 1
