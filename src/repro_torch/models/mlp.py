"""SwiGLU / GELU MLP blocks."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .. import obs
from .common import (FSDP, TP, P, dense_init, dtype_of, matmul, param,
                     residual)


class MLP(nn.Module):
    """The gated MLP (``w_gate``, ``w_up``, ``w_down``): SwiGLU, or with
    ``cfg.hidden_act == "gelu"`` gated GELU (erf, as Zamba2's); or, with
    ``gelu``, the Whisper-style 2-matrix GELU MLP (``w_in``, ``w_out``)."""

    def __init__(self, cfg, device, d_ff=None, gelu: bool = False):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        D, Fh = cfg.d_model, d_ff or cfg.d_ff
        if cfg.hidden_act not in ("silu", "gelu"):
            raise ValueError(f"hidden_act must be silu or gelu, got "
                             f"{cfg.hidden_act!r}")
        self.act = cfg.hidden_act
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


def mlp(p: MLP, x, adapter=None):
    """``adapter``: None, or a module with ``lora_a`` (D, r) and
    ``lora_b`` (r, 2F) whose product is added to the gate (its first F
    columns) and the up projection (the rest) before the activation, as
    Zamba2's per-application LoRA on ``gate_up``."""
    with obs.span("mlp"):
        if hasattr(p, "w_in"):
            h = F.gelu(matmul(x, p.w_in.to(x.dtype)),
                       approximate="tanh")                 # jax's default
            return residual(matmul(h, p.w_out.to(x.dtype)))
        g = matmul(x, p.w_gate.to(x.dtype))
        u = matmul(x, p.w_up.to(x.dtype))
        if adapter is not None:
            with obs.span("shared.adapter"):
                gu = matmul(matmul(x, adapter.lora_a.to(x.dtype)),
                            adapter.lora_b.to(x.dtype))
                g = g + gu[..., :g.shape[-1]]
                u = u + gu[..., g.shape[-1]:]
        act = F.gelu(g) if p.act == "gelu" else F.silu(g)
        return residual(matmul(act * u, p.w_down.to(x.dtype)))
