"""Whisper-style encoder-decoder backbone (the audio frontend is a stub).

The conv frontend is stubbed as in the reference: the caller gives frame
embeddings ``frames`` (B, encoder_seq, D) (:func:`repro_torch.models.
model.extra_inputs` makes them). Encoder: sinusoidal positions added to
the frames, bidirectional self-attention, GELU MLP, LayerNorms with bias.
Decoder: causal self-attention with RoPE and a KV cache, cross-attention
over the encoder's states, GELU MLP.

Two behaviours follow the reference on purpose. The encoder's
self-attention rotates q and k by RoPE at positions ``0 .. S-1`` (the
reference's ``encode`` passes ``positions=None``, which its ``attention``
turns into ``arange(S)``). Cross-attention has no RoPE, and at every
decode step it re-projects its K/V from the encoder's states, which the
cache holds (``enc_out``, in the cache dtype). One behaviour does not:
the encoder stays bidirectional through the attention kernel
(``causal=False``), where the reference's flash route ignores its mask.
``forward`` takes the attention route by its ``impl`` argument (``"xla"``
to train: the reference's default route, where cross-attention has no
mask and the encoder's mask is all true) and, with ``cfg.remat ==
"full"``, rematerialises each encoder and decoder layer body.
"""
from __future__ import annotations

import torch
from torch import nn

from . import attention as attn_mod
from .common import (FSDP, TP, Embeddings, LayerNorm, P, assign,
                     embed_tokens, layer_call, ln, mesh_zeros, podify,
                     sinusoidal_positions, spec_embeddings, unembed)
from .mlp import MLP, mlp, spec_mlp


class EncoderLayer(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.attn_norm = LayerNorm(cfg, device)
        self.mlp_norm = LayerNorm(cfg, device)
        self.attn = attn_mod.Attention(cfg, device)
        self.mlp = MLP(cfg, device, gelu=True)

    @torch.no_grad()
    def reset_parameters(self, generator):
        for norm in (self.attn_norm, self.mlp_norm):
            norm.reset_parameters()
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)


class DecoderLayer(nn.Module):
    def __init__(self, cfg, device):
        super().__init__()
        self.self_norm = LayerNorm(cfg, device)
        self.cross_norm = LayerNorm(cfg, device)
        self.mlp_norm = LayerNorm(cfg, device)
        self.self_attn = attn_mod.Attention(cfg, device)
        self.cross_attn = attn_mod.Attention(cfg, device)
        self.mlp = MLP(cfg, device, gelu=True)

    @torch.no_grad()
    def reset_parameters(self, generator):
        for norm in (self.self_norm, self.cross_norm, self.mlp_norm):
            norm.reset_parameters()
        self.self_attn.reset_parameters(generator)
        self.cross_attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)


class EncDecLM(nn.Module):
    """Parameters named as the reference's tree: ``embed.tok``,
    ``enc_layers.<i>.attn_norm.w``, ``dec_layers.<i>.cross_attn.wq``,
    ``enc_final_norm.b``, ``final_norm.w``, …"""

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        self.embed = Embeddings(cfg, device)
        self.enc_layers = nn.ModuleList(EncoderLayer(cfg, device)
                                        for _ in range(cfg.n_encoder_layers))
        self.dec_layers = nn.ModuleList(DecoderLayer(cfg, device)
                                        for _ in range(cfg.n_layers))
        self.enc_final_norm = LayerNorm(cfg, device)
        self.final_norm = LayerNorm(cfg, device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.embed.reset_parameters(generator)
        for layer in (*self.enc_layers, *self.dec_layers):
            layer.reset_parameters(generator)
        self.enc_final_norm.reset_parameters()
        self.final_norm.reset_parameters()


LM = EncDecLM


def init_lm(cfg, generator, device) -> EncDecLM:
    m = EncDecLM(cfg, device)
    m.reset_parameters(generator)
    return m


def _spec_ln():
    return {"w": P(None), "b": P(None)}


def lm_param_specs(cfg):
    return {
        "embed": spec_embeddings(cfg),
        "enc_layers": {"attn_norm": _spec_ln(), "mlp_norm": _spec_ln(),
                       "attn": attn_mod.spec_attention(cfg),
                       "mlp": spec_mlp(gelu=True)},
        "dec_layers": {"self_norm": _spec_ln(), "cross_norm": _spec_ln(),
                       "mlp_norm": _spec_ln(),
                       "self_attn": attn_mod.spec_attention(cfg),
                       "cross_attn": attn_mod.spec_attention(cfg),
                       "mlp": spec_mlp(gelu=True)},
        "enc_final_norm": _spec_ln(),
        "final_norm": _spec_ln(),
    }


def cache_specs(cfg):
    return {"k": P(None, FSDP, None, TP, None),
            "v": P(None, FSDP, None, TP, None),
            "enc_out": P(FSDP, None, None)}


def _need_frames(frames, what):
    if frames is None:
        raise ValueError(f"encoder-decoder {what} needs `frames`")


def encode(params: EncDecLM, frames, cfg, impl: str = "flash"):
    """frames: (B, S_enc, D) stub frame embeddings → encoder states."""
    S = frames.shape[1]
    pos = sinusoidal_positions(S, cfg.d_model, frames.device)
    x = frames + pos.to(frames.dtype)[None]

    def body(x, lp):
        h, _ = attn_mod.attention(lp.attn, ln(x, lp.attn_norm, cfg.norm_eps),
                                  cfg, causal=False, impl=impl)
        x = x + h
        return x + mlp(lp.mlp, ln(x, lp.mlp_norm, cfg.norm_eps))

    for lp in params.enc_layers:
        x = layer_call(cfg, body, x, lp, keep_rows=True)
    return ln(x, params.enc_final_norm, cfg.norm_eps)


def _dec_layer(x, lp: DecoderLayer, enc_out, cfg, impl: str = "flash"):
    h, kv = attn_mod.attention(lp.self_attn,
                               ln(x, lp.self_norm, cfg.norm_eps), cfg,
                               impl=impl)
    x = x + h
    x = x + attn_mod.cross_attention(
        lp.cross_attn, ln(x, lp.cross_norm, cfg.norm_eps), enc_out, cfg,
        impl=impl)
    x = x + mlp(lp.mlp, ln(x, lp.mlp_norm, cfg.norm_eps))
    return x, kv


def _head(params: EncDecLM, x, cfg):
    x = ln(x, params.final_norm, cfg.norm_eps)
    return unembed(params.embed, x, cfg).float()


def forward(params: EncDecLM, tokens, cfg, frames=None,
            impl: str = "flash"):
    """tokens: (B, S_dec); frames: (B, S_enc, D) stub embeddings."""
    _need_frames(frames, "forward")
    enc_out = encode(params, frames, cfg, impl)
    x = embed_tokens(params.embed, tokens, cfg)

    def body(x, lp):
        return _dec_layer(x, lp, enc_out, cfg, impl)[0]

    for lp in params.dec_layers:
        x = layer_call(cfg, body, x, lp, keep_rows=True)
    return (_head(params, x, cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------- #
#  Serving: decoder KV cache + the encoder's states
# ---------------------------------------------------------------------- #
def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None):
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq,
             cfg.resolved_head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "enc_out": torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                               dtype=dtype, device=device),
    }


def prefill(params: EncDecLM, tokens, cfg, max_seq: int, frames=None,
            cache_dtype=torch.bfloat16, impl: str = "flash"):
    _need_frames(frames, "prefill")
    enc_out = encode(params, frames, cfg, impl)
    x = embed_tokens(params.embed, tokens, cfg)
    cache = mesh_zeros(lambda dev: init_cache(cfg, x.shape[0], max_seq,
                                              cache_dtype, dev),
                       podify(cache_specs(cfg)), x.device)
    S = x.shape[1]
    for i, lp in enumerate(params.dec_layers):
        x, (k, v) = _dec_layer(x, lp, enc_out, cfg, impl)
        rows = (i, slice(None), slice(None), slice(0, S))
        assign(cache["k"], rows, k.transpose(1, 2))
        assign(cache["v"], rows, v.transpose(1, 2))
    cache["enc_out"] = enc_out.to(cache_dtype)
    return _head(params, x, cfg), cache


def decode_step(params: EncDecLM, cache, tokens, pos: int, cfg):
    """tokens: (B, 1). Returns (logits, cache); the self-attention caches
    are updated in place."""
    x = embed_tokens(params.embed, tokens, cfg)
    enc_out = cache["enc_out"]
    for i, lp in enumerate(params.dec_layers):
        h, _, _ = attn_mod.attention_decode(
            lp.self_attn, ln(x, lp.self_norm, cfg.norm_eps), cache["k"][i],
            cache["v"][i], pos, cfg)
        x = x + h
        x = x + attn_mod.cross_attention_decode(
            lp.cross_attn, ln(x, lp.cross_norm, cfg.norm_eps), enc_out, cfg)
        x = x + mlp(lp.mlp, ln(x, lp.mlp_norm, cfg.norm_eps))
    return _head(params, x, cfg), cache
