"""Shared model building blocks: dtypes, initializers, norms, RoPE,
sinusoidal positions and the embedding tables.

Parameters live in ``nn.Module``s and keep the reference's names and
layouts: a projection is stored ``(in, out)`` and applied as ``x @ w``, so
a weight carries between the packages as a plain copy
(:mod:`repro_torch.convert`). Modules allocate their parameters and
``reset_parameters(generator)`` fills them; the model code itself is plain
functions on tensors. Parameters are made frozen (``requires_grad=False``)
for serving; the trainer turns grads on explicitly, with
``model.init(..., trainable=True)`` or ``params.requires_grad_(True)``
(:mod:`repro_torch.train.step`). Training runs the differentiable
``impl="xla"`` route: the attention and scan kernels are forward-only.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def param(shape, dtype, device) -> nn.Parameter:
    """An uninitialized, frozen parameter."""
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


#: the full-sequence routes: the forward-only kernels ("flash", serving)
#: or the differentiable plain path ("xla", training)
IMPLS = ("flash", "xla")


def check_impl(impl: str) -> None:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


def layer_call(cfg, fn, *args):
    """``fn(*args)``, rematerialised in the backward pass when
    ``cfg.remat == "full"`` (the reference wraps its layer bodies in
    ``jax.checkpoint``): only the layer's inputs are kept, and its
    activations are recomputed when the gradient reaches it."""
    if cfg.remat == "full":
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------- #
#  Initializers (fp32 normal draws scaled, then cast, as the reference)
# ---------------------------------------------------------------------- #
def _normal(generator: torch.Generator, shape, device) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=device,
                       dtype=torch.float32)


def dense_init(generator, shape, dtype, device, fan_in=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    return (_normal(generator, shape, device)
            * (1.0 / math.sqrt(fan_in))).to(dtype)


def embed_init(generator, shape, dtype, device):
    return (_normal(generator, shape, device) * 0.02).to(dtype)


# ---------------------------------------------------------------------- #
#  Norms (computed in fp32, cast back)
# ---------------------------------------------------------------------- #
def rms_norm(x, weight, eps):
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layer_norm(x, weight, bias, eps):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm parameters as the reference's ``{"w", "b"}`` leaves."""

    def __init__(self, cfg, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.w = param((cfg.d_model,), dt, device)
        self.b = param((cfg.d_model,), dt, device)

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        self.w.fill_(1.0)
        self.b.zero_()


def ln(x, p: LayerNorm, eps):
    return layer_norm(x, p.w, p.b, eps)


# ---------------------------------------------------------------------- #
#  Rotary position embeddings (full head dim, split-half rotation)
# ---------------------------------------------------------------------- #
def rope_freqs(head_dim: int, theta: float, device=None):
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                   # (hd/2,)
    angles = positions[..., :, None].float() * freqs         # (..., S, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                 # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------- #
#  Sinusoidal positions (Whisper encoder)
# ---------------------------------------------------------------------- #
def sinusoidal_positions(n_pos: int, dim: int, device=None) -> torch.Tensor:
    """(n_pos, dim) fp32: computed in float64 numpy and rounded once, as
    the reference computes it."""
    pos = np.arange(n_pos)[:, None]
    i = np.arange(dim // 2)[None, :]
    angle = pos / np.power(10_000, 2 * i / dim)
    out = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.from_numpy(out.astype(np.float32)).to(device)


# ---------------------------------------------------------------------- #
#  Embedding / unembedding
# ---------------------------------------------------------------------- #
class Embeddings(nn.Module):
    """``tok`` (vocab, d_model) and, unless tied, ``unembed`` (d_model,
    vocab)."""

    def __init__(self, cfg, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.tok = param((cfg.vocab_size, cfg.d_model), dt, device)
        self.unembed = (None if cfg.tie_embeddings else
                        param((cfg.d_model, cfg.vocab_size), dt, device))

    @torch.no_grad()
    def reset_parameters(self, generator):
        dev = self.tok.device
        self.tok.copy_(embed_init(generator, self.tok.shape, self.tok.dtype,
                                  dev))
        if self.unembed is not None:
            self.unembed.copy_(dense_init(generator, self.unembed.shape,
                                          self.unembed.dtype, dev))


def init_embeddings(cfg, generator, device):
    emb = Embeddings(cfg, device)
    emb.reset_parameters(generator)
    return emb


def embed_tokens(p: Embeddings, tokens, cfg):
    return p.tok[tokens.long()].to(dtype_of(cfg.activation_dtype))


def unembed(p: Embeddings, x, cfg):
    w = p.unembed if p.unembed is not None else p.tok.T
    return x @ w.to(x.dtype)
