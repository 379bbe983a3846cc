"""Decoder-only dense LM: embed → N (attention + SwiGLU) blocks → head.

The reference stacks its layers on a leading axis and scans over them;
here they are an ``nn.ModuleList`` walked by a Python loop. The MoE and
VLM families, which the reference builds in the same module, are not
ported yet: :mod:`repro_torch.models.model` refuses them.
"""
from __future__ import annotations

import torch
from torch import nn

from . import attention as attn_mod
from .common import (Embeddings, dtype_of, embed_tokens, param, rms_norm,
                     unembed)
from .mlp import MLP, mlp


class DenseLayer(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.attn_norm = param((cfg.d_model,), dt, device)
        self.mlp_norm = param((cfg.d_model,), dt, device)
        self.attn = attn_mod.Attention(cfg, device)
        self.mlp = MLP(cfg, device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.attn_norm.fill_(1.0)
        self.mlp_norm.fill_(1.0)
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)


class DenseLM(nn.Module):
    """Parameters named as the reference's tree: ``embed.tok``,
    ``layers.<i>.attn.wq``, ``layers.<i>.mlp.w_gate``, ``final_norm``, …"""

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        self.embed = Embeddings(cfg, device)
        self.layers = nn.ModuleList(DenseLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = param((cfg.d_model,), dtype_of(cfg.param_dtype),
                                device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.embed.reset_parameters(generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        self.final_norm.fill_(1.0)


def init_lm(cfg, generator, device) -> DenseLM:
    m = DenseLM(cfg, device)
    m.reset_parameters(generator)
    return m


def _layer_fwd(x, lp: DenseLayer, cfg):
    h, kv = attn_mod.attention(lp.attn, rms_norm(x, lp.attn_norm,
                                                 cfg.norm_eps), cfg)
    x = x + h
    x = x + mlp(lp.mlp, rms_norm(x, lp.mlp_norm, cfg.norm_eps))
    return x, kv


def forward(params: DenseLM, tokens, cfg):
    """Teacher-forcing forward. tokens: (B, S) integer.
    Returns (logits (B, S, vocab) fp32, aux_loss)."""
    x = embed_tokens(params.embed, tokens, cfg)
    for lp in params.layers:
        x, _ = _layer_fwd(x, lp, cfg)
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    logits = unembed(params.embed, x, cfg).float()
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------- #
#  Serving: prefill + decode with a stacked KV cache
# ---------------------------------------------------------------------- #
def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None):
    """k/v caches (n_layers, B, Hkv, S_alloc, hd); with a sliding window
    ``S_alloc = min(max_seq, window)`` and the slots form a ring."""
    hd = cfg.resolved_head_dim
    if cfg.sliding_window is not None:
        max_seq = min(max_seq, cfg.sliding_window)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, hd)
    return {"layers": {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device)}}


def decode_step(params: DenseLM, cache, tokens, pos: int, cfg):
    """tokens: (B, 1); pos: the position being written. Returns (logits,
    cache); the cache tensors are updated in place (a copy of a multi-GB
    cache per token would dominate decode)."""
    x = embed_tokens(params.embed, tokens, cfg)
    ck, cv = cache["layers"]["k"], cache["layers"]["v"]
    for i, lp in enumerate(params.layers):
        h, _, _ = attn_mod.attention_decode(
            lp.attn, rms_norm(x, lp.attn_norm, cfg.norm_eps), ck[i], cv[i],
            pos, cfg)
        x = x + h
        x = x + mlp(lp.mlp, rms_norm(x, lp.mlp_norm, cfg.norm_eps))
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(params.embed, x, cfg).float(), cache


def _cache_write(kv, cache_side):
    """Write one layer's (B, K, S, hd) kv into its cache slice, handling
    the sliding-window ring layout (slot = abs_pos % S_alloc)."""
    S = kv.shape[2]
    S_alloc = cache_side.shape[2]
    if S > S_alloc:  # keep the last window, rolled into ring slots
        kv = torch.roll(kv[:, :, S - S_alloc:], shifts=S % S_alloc, dims=2)
        S = S_alloc
    cache_side[:, :, :S] = kv.to(cache_side.dtype)


def prefill(params: DenseLM, tokens, cfg, max_seq: int,
            cache_dtype=torch.bfloat16):
    """Run the prompt; return (logits, cache) with kv written at [0, S)."""
    x = embed_tokens(params.embed, tokens, cfg)
    cache = init_cache(cfg, x.shape[0], max_seq, cache_dtype, x.device)
    ck, cv = cache["layers"]["k"], cache["layers"]["v"]
    for i, lp in enumerate(params.layers):
        x, (k, v) = _layer_fwd(x, lp, cfg)
        _cache_write(k.transpose(1, 2), ck[i])
        _cache_write(v.transpose(1, 2), cv[i])
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(params.embed, x, cfg).float(), cache
