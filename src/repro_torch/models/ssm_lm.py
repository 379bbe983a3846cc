"""Attention-free Mamba-1 LM (falcon-mamba-7b): embed → N mamba blocks →
head. ``forward`` takes the scan route by its ``impl`` argument
(``"xla"`` to train) and, with ``cfg.remat == "full"``, rematerialises
each layer body."""
from __future__ import annotations

import torch
from torch import nn

from .common import (FSDP, TP, Embeddings, P, assign, dtype_of, embed_tokens,
                     layer_call, mesh_zeros, param, podify, rms_norm,
                     spec_embeddings, unembed)
from .ssm import Mamba1, mamba1_block, spec_mamba


class MambaLayer(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.norm = param((cfg.d_model,), dtype_of(cfg.param_dtype), device)
        self.mamba = Mamba1(cfg, device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.norm.fill_(1.0)
        self.mamba.reset_parameters(generator)


class MambaLM(nn.Module):
    """Parameters named as the reference's tree: ``embed.tok``,
    ``layers.<i>.norm``, ``layers.<i>.mamba.A_log``, ``final_norm``, …"""

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        self.embed = Embeddings(cfg, device)
        self.layers = nn.ModuleList(MambaLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = param((cfg.d_model,), dtype_of(cfg.param_dtype),
                                device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.embed.reset_parameters(generator)
        for layer in self.layers:
            layer.reset_parameters(generator)
        self.final_norm.fill_(1.0)


LM = MambaLM


def init_lm(cfg, generator, device) -> MambaLM:
    m = MambaLM(cfg, device)
    m.reset_parameters(generator)
    return m


def lm_param_specs(cfg):
    return {"embed": spec_embeddings(cfg),
            "layers": {"norm": P(None), "mamba": spec_mamba(cfg)},
            "final_norm": P(None)}


def cache_specs(cfg):
    return {"conv": P(None, FSDP, None, TP),
            "ssm": P(None, FSDP, TP, None)}


def _head(params: MambaLM, x, cfg):
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(params.embed, x, cfg).float()


def forward(params: MambaLM, tokens, cfg, impl: str = "flash"):
    x = embed_tokens(params.embed, tokens, cfg)

    def body(x, lp):
        h, _ = mamba1_block(lp.mamba, rms_norm(x, lp.norm, cfg.norm_eps), cfg,
                            impl=impl)
        return x + h

    for lp in params.layers:
        x = layer_call(cfg, body, x, lp)
    return (_head(params, x, cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------- #
#  Serving: constant-size recurrent state
# ---------------------------------------------------------------------- #
def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None):
    del max_seq  # state size independent of context length
    Di, N, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    L = cfg.n_layers
    return {
        "conv": torch.zeros((L, batch, K - 1, Di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((L, batch, Di, N), dtype=torch.float32,
                           device=device),
    }


def decode_step(params: MambaLM, cache, tokens, pos, cfg):
    """tokens: (B, 1). Returns (logits, cache); the cache tensors are
    updated in place."""
    del pos  # recurrent state carries position implicitly
    x = embed_tokens(params.embed, tokens, cfg)
    for i, lp in enumerate(params.layers):
        h, st = mamba1_block(
            lp.mamba, rms_norm(x, lp.norm, cfg.norm_eps), cfg,
            state={"conv": cache["conv"][i].to(x.dtype),
                   "ssm": cache["ssm"][i]})
        x = x + h
        assign(cache["conv"], (i,), st["conv"])
        assign(cache["ssm"], (i,), st["ssm"])
    return _head(params, x, cfg), cache


def prefill(params: MambaLM, tokens, cfg, max_seq: int,
            cache_dtype=torch.bfloat16, impl: str = "flash"):
    x = embed_tokens(params.embed, tokens, cfg)
    cache = mesh_zeros(lambda dev: init_cache(cfg, x.shape[0], max_seq,
                                              cache_dtype, dev),
                       podify(cache_specs(cfg)), x.device)
    for i, lp in enumerate(params.layers):
        h, st = mamba1_block(lp.mamba, rms_norm(x, lp.norm, cfg.norm_eps),
                             cfg, impl=impl)
        x = x + h
        assign(cache["conv"], (i,), st["conv"])
        assign(cache["ssm"], (i,), st["ssm"])
    return _head(params, x, cfg), cache
