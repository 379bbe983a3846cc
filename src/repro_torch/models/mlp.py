"""SwiGLU / GELU MLP blocks."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import obs
from .common import (FSDP, TP, P, dense_init, dtype_of, matmul, param,
                     residual)


class MLP(nn.Module):
    """SwiGLU (``w_gate``, ``w_up``, ``w_down``) or, with ``gelu``, the
    Whisper-style 2-matrix GELU MLP (``w_in``, ``w_out``)."""

    def __init__(self, cfg, device, d_ff=None, gelu: bool = False):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        D, Fh = cfg.d_model, d_ff or cfg.d_ff
        if gelu:
            self.w_in = param((D, Fh), dt, device)
            self.w_out = param((Fh, D), dt, device)
        else:
            self.w_gate = param((D, Fh), dt, device)
            self.w_up = param((D, Fh), dt, device)
            self.w_down = param((Fh, D), dt, device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        for w in self.parameters():
            w.copy_(dense_init(generator, w.shape, w.dtype, w.device))


def init_mlp(cfg, generator, device, d_ff=None, gelu: bool = False):
    m = MLP(cfg, device, d_ff=d_ff, gelu=gelu)
    m.reset_parameters(generator)
    return m


def spec_mlp(gelu: bool = False):
    if gelu:
        return {"w_in": P(FSDP, TP), "w_out": P(TP, FSDP)}
    return {"w_gate": P(FSDP, TP), "w_up": P(FSDP, TP),
            "w_down": P(TP, FSDP)}


def mlp(p: MLP, x):
    with obs.span("mlp"):
        if hasattr(p, "w_in"):
            h = F.gelu(matmul(x, p.w_in.to(x.dtype)),
                       approximate="tanh")                 # jax's default
            return residual(matmul(h, p.w_out.to(x.dtype)))
        g = matmul(x, p.w_gate.to(x.dtype))
        u = matmul(x, p.w_up.to(x.dtype))
        return residual(matmul(F.silu(g) * u, p.w_down.to(x.dtype)))
