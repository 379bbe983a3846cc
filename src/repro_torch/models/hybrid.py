"""Zamba2-style hybrid: a Mamba-2 backbone with one *shared* attention
block.

Zamba2-7B runs 81 Mamba-2 blocks and, after every ``hybrid_attn_period``
of them, one transformer block whose weights are shared by every
application; each application keeps its own KV cache. As in the
reference, the shared block consumes the hidden state directly (no concat
with the embedding and no per-application LoRA). With 81 blocks and a
period of 6 that is 13 segments of 6 blocks, each followed by the shared
block, and a tail of 3 blocks.

A prompt runs the scan kernel in every Mamba-2 block and the attention
kernel in every application; decode is the plain single step of each.
``forward`` takes the route by its ``impl`` argument (``"xla"`` to train)
and, with ``cfg.remat == "full"``, rematerialises each Mamba-2 block, as
the reference does (its shared block is not rematerialised).
"""
from __future__ import annotations

import torch
from torch import nn

from . import attention as attn_mod
from .common import (FSDP, TP, Embeddings, P, assign, dtype_of,
                     embed_tokens, layer_call, mesh_zeros, param, podify,
                     rms_norm, spec_embeddings, unembed)
from .mlp import MLP, mlp, spec_mlp
from .ssm import Mamba2, mamba2_block, spec_mamba
from .transformer import cache_write


def n_attn_applications(cfg) -> int:
    return (cfg.n_layers // cfg.hybrid_attn_period
            if cfg.hybrid_attn_period else 0)


class HybridLayer(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.norm = param((cfg.d_model,), dtype_of(cfg.param_dtype), device)
        self.mamba = Mamba2(cfg, device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.norm.fill_(1.0)
        self.mamba.reset_parameters(generator)


class SharedBlock(nn.Module):
    """``attn_norm``, ``mlp_norm``, ``attn``, ``mlp``: one set of weights
    for every application."""

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


class HybridLM(nn.Module):
    """Parameters named as the reference's tree: ``embed.tok``,
    ``layers.<i>.norm``, ``layers.<i>.mamba.in_proj``,
    ``shared_attn.attn.wq``, ``final_norm``, …"""

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        self.embed = Embeddings(cfg, device)
        self.layers = nn.ModuleList(HybridLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        if cfg.hybrid_attn_period:
            self.shared_attn = SharedBlock(cfg, device)
        self.final_norm = param((cfg.d_model,), dtype_of(cfg.param_dtype),
                                device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.embed.reset_parameters(generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        if hasattr(self, "shared_attn"):
            self.shared_attn.reset_parameters(generator)
        self.final_norm.fill_(1.0)


LM = HybridLM


def init_lm(cfg, generator, device) -> HybridLM:
    m = HybridLM(cfg, device)
    m.reset_parameters(generator)
    return m


def lm_param_specs(cfg):
    p = {"embed": spec_embeddings(cfg),
         "layers": {"norm": P(None), "mamba": spec_mamba(cfg)},
         "final_norm": P(None)}
    if cfg.hybrid_attn_period:
        p["shared_attn"] = {"attn_norm": P(None), "mlp_norm": P(None),
                            "attn": attn_mod.spec_attention(cfg),
                            "mlp": spec_mlp()}
    return p


def cache_specs(cfg):
    p = {"conv": P(None, FSDP, None, TP), "ssm": P(None, FSDP, TP, None, None)}
    if n_attn_applications(cfg):
        p["attn_k"] = P(None, FSDP, None, TP, None)
        p["attn_v"] = P(None, FSDP, None, TP, None)
    return p


def _segments(cfg):
    """(first, end) layer index of each segment: one per attention
    application, ``period`` blocks each, then the tail if any."""
    period = cfg.hybrid_attn_period or cfg.n_layers
    n_apps = n_attn_applications(cfg)
    segs = [(i * period, (i + 1) * period) for i in range(n_apps)]
    if n_apps * period < cfg.n_layers:
        segs.append((n_apps * period, cfg.n_layers))
    return segs


def _shared_fwd(sp: SharedBlock, x, cfg, impl: str = "flash"):
    h, kv = attn_mod.attention(sp.attn, rms_norm(x, sp.attn_norm,
                                                 cfg.norm_eps), cfg,
                               impl=impl)
    x = x + h
    x = x + mlp(sp.mlp, rms_norm(x, sp.mlp_norm, cfg.norm_eps))
    return x, kv


def _head(params: HybridLM, x, cfg):
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(params.embed, x, cfg).float()


def _run(params: HybridLM, x, cfg, cache=None, impl: str = "flash"):
    """The prompt through every segment and application; with ``cache``,
    each block's conv and ssm state and each application's k/v are
    written there; without one (the training forward) each Mamba-2 block
    runs through :func:`~repro_torch.models.common.layer_call`."""
    n_apps = n_attn_applications(cfg)

    def block(x, lp):
        h, st = mamba2_block(lp.mamba, rms_norm(x, lp.norm, cfg.norm_eps),
                             cfg, impl=impl)
        return x + h, st

    for a, (lo, hi) in enumerate(_segments(cfg)):
        for i in range(lo, hi):
            if cache is None:
                x, _ = layer_call(cfg, block, x, params.layers[i])
                continue
            x, st = block(x, params.layers[i])
            assign(cache["conv"], (i,), st["conv"])
            assign(cache["ssm"], (i,), st["ssm"])
        if a < n_apps:
            x, (k, v) = _shared_fwd(params.shared_attn, x, cfg, impl)
            if cache is not None:
                cache_write(k.transpose(1, 2), cache["attn_k"][a])
                cache_write(v.transpose(1, 2), cache["attn_v"][a])
    return x


def forward(params: HybridLM, tokens, cfg, impl: str = "flash"):
    x = _run(params, embed_tokens(params.embed, tokens, cfg), cfg,
             impl=impl)
    return (_head(params, x, cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------- #
#  Serving
# ---------------------------------------------------------------------- #
def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None):
    """conv (L, B, K-1, Di+2N) and ssm (L, B, H, Pd, N) fp32 per block;
    attn_k/attn_v (n_apps, B, Hkv, max_seq, hd) per application."""
    Di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    Pd = cfg.ssm_head_dim
    L = cfg.n_layers
    n_apps = n_attn_applications(cfg)
    cache = {
        "conv": torch.zeros((L, batch, K - 1, Di + 2 * N), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((L, batch, Di // Pd, Pd, N), dtype=torch.float32,
                           device=device),
    }
    if n_apps:
        shape = (n_apps, batch, cfg.n_kv_heads, max_seq,
                 cfg.resolved_head_dim)
        cache["attn_k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["attn_v"] = torch.zeros(shape, dtype=dtype, device=device)
    return cache


def prefill(params: HybridLM, tokens, cfg, max_seq: int,
            cache_dtype=torch.bfloat16, impl: str = "flash"):
    x = embed_tokens(params.embed, tokens, cfg)
    cache = mesh_zeros(lambda dev: init_cache(cfg, x.shape[0], max_seq,
                                              cache_dtype, dev),
                       podify(cache_specs(cfg)), x.device)
    x = _run(params, x, cfg, cache, impl)
    return _head(params, x, cfg), cache


def decode_step(params: HybridLM, cache, tokens, pos: int, cfg):
    """tokens: (B, 1). Returns (logits, cache); the cache tensors are
    updated in place."""
    x = embed_tokens(params.embed, tokens, cfg)
    n_apps = n_attn_applications(cfg)
    for a, (lo, hi) in enumerate(_segments(cfg)):
        for i in range(lo, hi):
            lp = params.layers[i]
            h, st = mamba2_block(
                lp.mamba, rms_norm(x, lp.norm, cfg.norm_eps), cfg,
                state={"conv": cache["conv"][i].to(x.dtype),
                       "ssm": cache["ssm"][i]})
            x = x + h
            assign(cache["conv"], (i,), st["conv"])
            assign(cache["ssm"], (i,), st["ssm"])
        if a < n_apps:
            sp = params.shared_attn
            h, _, _ = attn_mod.attention_decode(
                sp.attn, rms_norm(x, sp.attn_norm, cfg.norm_eps),
                cache["attn_k"][a], cache["attn_v"][a], pos, cfg)
            x = x + h
            x = x + mlp(sp.mlp, rms_norm(x, sp.mlp_norm, cfg.norm_eps))
    return _head(params, x, cfg), cache
