"""Decoder-only LM (dense / MoE / VLM): embed → N (attention + SwiGLU or
MoE) blocks → head.

The reference stacks its layers on a leading axis and scans over them;
here they are ``nn.ModuleList``s walked by a Python loop. The MoE family
runs its first ``first_dense_layers`` layers as a separate dense stack
(``dense_layers``), and sums the MoE layers' load-balance losses. The VLM
family prepends stub patch embeddings (``vision_embeds``, (B, V, D)) to
the text tokens' embeddings. ``forward`` takes the attention route by
its ``impl`` argument (``"xla"`` to train) and, with ``cfg.remat ==
"full"``, rematerialises each layer body.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import obs
from . import attention as attn_mod
from . import moe as moe_mod
from .common import (FSDP, TP, Embeddings, P, assign, current_mesh,
                     dtype_of, embed_tokens, layer_call, mesh_zeros, param,
                     podify,
                     rms_norm, sanitize_spec, shard_map, spec_embeddings,
                     unembed)
from .mlp import MLP, mlp, spec_mlp


class Layer(nn.Module):
    """``attn_norm``, ``mlp_norm``, ``attn`` and either ``mlp`` or
    ``moe``."""

    def __init__(self, cfg, device, use_moe: bool = False):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        self.attn_norm = param((cfg.d_model,), dt, device)
        self.mlp_norm = param((cfg.d_model,), dt, device)
        self.attn = attn_mod.Attention(cfg, device)
        if use_moe:
            self.moe = moe_mod.MoE(cfg, device)
        else:
            self.mlp = MLP(cfg, device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.attn_norm.fill_(1.0)
        self.mlp_norm.fill_(1.0)
        self.attn.reset_parameters(generator)
        (self.moe if hasattr(self, "moe") else self.mlp).reset_parameters(
            generator)


def _n_dense(cfg) -> int:
    return cfg.first_dense_layers if cfg.family == "moe" else 0


class TransformerLM(nn.Module):
    """Parameters named as the reference's tree: ``embed.tok``,
    ``layers.<i>.attn.wq``, ``layers.<i>.mlp.w_gate`` (or
    ``layers.<i>.moe.router``), ``dense_layers.<i>.…``, ``final_norm``, …"""

    def __init__(self, cfg, device):
        super().__init__()
        self.cfg = cfg
        n_dense = _n_dense(cfg)
        self.embed = Embeddings(cfg, device)
        if n_dense:
            self.dense_layers = nn.ModuleList(Layer(cfg, device)
                                              for _ in range(n_dense))
        self.layers = nn.ModuleList(
            Layer(cfg, device, use_moe=cfg.family == "moe")
            for _ in range(cfg.n_layers - n_dense))
        self.final_norm = param((cfg.d_model,), dtype_of(cfg.param_dtype),
                                device)

    def stacks(self):
        """The layer stacks in the order they run, with their cache keys."""
        out = [("dense_layers", self.dense_layers)] if hasattr(
            self, "dense_layers") else []
        return out + [("layers", self.layers)]

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.embed.reset_parameters(generator)
        for _, stack in self.stacks():
            for layer in stack:
                layer.reset_parameters(generator)
        self.final_norm.fill_(1.0)


LM = TransformerLM


def spec_layer(cfg, use_moe: bool):
    p = {"attn_norm": P(None), "mlp_norm": P(None),
         "attn": attn_mod.spec_attention(cfg)}
    if use_moe:
        p["moe"] = moe_mod.spec_moe(cfg)
    else:
        p["mlp"] = spec_mlp()
    return p


def lm_param_specs(cfg):
    """Per-layer specs under each stack's name (the reference's stacked
    specs with the leading layer entry dropped)."""
    specs = {"embed": spec_embeddings(cfg)}
    if _n_dense(cfg):
        specs["dense_layers"] = spec_layer(cfg, use_moe=False)
    specs["layers"] = spec_layer(cfg, use_moe=cfg.family == "moe")
    specs["final_norm"] = P(None)
    return specs


def cache_specs(cfg):
    """KV cache sharded: batch → data, sequence → model (flash-decode
    SP); the cache keeps the reference's stacked layout."""
    s = {"k": P(None, FSDP, None, TP, None),
         "v": P(None, FSDP, None, TP, None)}
    out = {"layers": dict(s)}
    if _n_dense(cfg):
        out["dense_layers"] = dict(s)
    return out


def init_lm(cfg, generator, device) -> TransformerLM:
    m = TransformerLM(cfg, device)
    m.reset_parameters(generator)
    return m


def _ffn(lp: Layer, x, cfg):
    """The layer's MLP or MoE on its normed input: (out, aux loss)."""
    hin = rms_norm(x, lp.mlp_norm, cfg.norm_eps)
    if hasattr(lp, "moe"):
        return moe_mod.moe(lp.moe, hin, cfg)
    return mlp(lp.mlp, hin), None


def _layer_fwd(x, lp: Layer, cfg, impl: str = "flash"):
    h, kv = attn_mod.attention(lp.attn, rms_norm(x, lp.attn_norm,
                                                 cfg.norm_eps), cfg,
                               impl=impl)
    x = x + h
    h, aux = _ffn(lp, x, cfg)
    return x + h, aux, kv


def _embed(params: TransformerLM, tokens, cfg, vision_embeds):
    x = embed_tokens(params.embed, tokens, cfg)
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
    return x


def forward(params: TransformerLM, tokens, cfg, vision_embeds=None,
            impl: str = "flash"):
    """Teacher-forcing forward. tokens: (B, S[-V]) integer; VLM:
    ``vision_embeds`` (B, V, D) are prepended, giving total sequence S.
    Returns (logits (B, S, vocab) fp32, aux_loss fp32)."""
    x = _embed(params, tokens, cfg, vision_embeds)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(x, lp):
        x, aux, _ = _layer_fwd(x, lp, cfg, impl)
        return x, aux

    for _, stack in params.stacks():
        for lp in stack:
            x, aux = layer_call(cfg, body, x, lp, keep_rows=True)
            if aux is not None:
                aux_total = aux_total + aux
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return unembed(params.embed, x, cfg).float(), aux_total


# ---------------------------------------------------------------------- #
#  Serving: prefill + decode with a stacked KV cache
# ---------------------------------------------------------------------- #
def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None):
    """k/v caches (n, B, Hkv, S_alloc, hd) per layer stack (``layers``,
    and ``dense_layers`` for a first dense stack); with a sliding window
    ``S_alloc = min(max_seq, window)`` and the slots form a ring."""
    hd = cfg.resolved_head_dim
    if cfg.sliding_window is not None:
        max_seq = min(max_seq, cfg.sliding_window)
    n_dense = _n_dense(cfg)

    def mk(n):
        shape = (n, batch, cfg.n_kv_heads, max_seq, hd)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    cache = {"layers": mk(cfg.n_layers - n_dense)}
    if n_dense:
        cache["dense_layers"] = mk(n_dense)
    return cache


#: the families of this module whose decode step can be captured in a
#: CUDA graph (:func:`repro_torch.train.serve.make_serve_step`): with a
#: tensor ``pos`` it makes no host sync. The MoE and VLM steps are not
#: yet held to their eager steps under a graph on a card, so stay eager.
GRAPH_DECODE_FAMILIES = ("dense",)


def count_decode_step(cfg, cache, pos: int) -> None:
    """The position counters of one decode step's attentions over each
    stack of ``cache`` (:func:`attention.count_positions`), on the route
    the step takes (:func:`attention.uses_decode_kernel`)."""
    for stack in cache.values():
        n, B, _, S_max, _ = stack["k"].shape
        attn_mod.count_positions(
            B, S_max, pos, cfg.sliding_window, n,
            kernel=attn_mod.uses_decode_kernel(
                stack["k"], dtype_of(cfg.activation_dtype)))


def decode_step(params: TransformerLM, cache, tokens, pos, cfg):
    """tokens: (B, 1); pos: the position being written, an int or a 0-d
    int64 tensor on the tokens' device (:func:`attention.attention_decode`).
    Returns (logits, cache); the cache tensors are updated in place (a
    copy of a multi-GB cache per token would dominate decode)."""
    with obs.span("embed"):
        x = embed_tokens(params.embed, tokens, cfg)
    for name, stack in params.stacks():
        ck, cv = cache[name]["k"], cache[name]["v"]
        for i, lp in enumerate(stack):
            with obs.span("layer"):
                h, _, _ = attn_mod.attention_decode(
                    lp.attn, rms_norm(x, lp.attn_norm, cfg.norm_eps), ck[i],
                    cv[i], pos, cfg)
                x = x + h
                x = x + _ffn(lp, x, cfg)[0]
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return _logits(params, x, cfg), cache


def _logits(params: TransformerLM, x, cfg):
    """The fp32 logits of the normed final states."""
    with obs.span("unembed"):
        return unembed(params.embed, x, cfg).float()


def cache_write(kv, cache_side):
    """Write one layer's (B, K, S, hd) kv into its cache slice, handling
    the sliding-window ring layout (slot = abs_pos % S_alloc)."""
    S = kv.shape[2]
    S_alloc = cache_side.shape[2]
    if S > S_alloc:  # keep the last window, rolled into ring slots
        kv = _roll_seq(kv[:, :, S - S_alloc:], S % S_alloc)
        S = S_alloc
    assign(cache_side, (slice(None), slice(None), slice(0, S)),
           kv.to(cache_side.dtype))


def _roll_seq(kv, shift: int):
    """``torch.roll`` over kv's sequence dim; under a mesh on each rank's
    batch shard (the sequence is whole there; some torch versions have
    no DTensor rule for ``roll``)."""
    mesh = current_mesh()
    if mesh is None:
        return torch.roll(kv, shifts=shift, dims=2)
    spec = sanitize_spec(P(("pod", FSDP), None, None, None),
                         tuple(kv.shape), mesh)
    (out,) = shard_map(lambda t: (torch.roll(t, shifts=shift, dims=2),),
                       mesh, [spec], [spec])(kv)
    return out


def prefill(params: TransformerLM, tokens, cfg, max_seq: int,
            vision_embeds=None, cache_dtype=torch.bfloat16,
            impl: str = "flash"):
    """Run the prompt (VLM: after ``vision_embeds``); return (logits,
    cache) with kv written at [0, S). Under a mesh the cache is laid out
    as :func:`cache_specs` says, its batch over (pod, data)."""
    with obs.span("embed"):
        x = _embed(params, tokens, cfg, vision_embeds)
    cache = mesh_zeros(lambda dev: init_cache(cfg, x.shape[0], max_seq,
                                              cache_dtype, dev),
                       podify(cache_specs(cfg)), x.device)
    for name, stack in params.stacks():
        ck, cv = cache[name]["k"], cache[name]["v"]
        for i, lp in enumerate(stack):
            with obs.span("layer"):
                x, _, (k, v) = _layer_fwd(x, lp, cfg, impl)
                with obs.span("attention.cache_write"):
                    cache_write(k.transpose(1, 2), ck[i])
                    cache_write(v.transpose(1, 2), cv[i])
    x = rms_norm(x, params.final_norm, cfg.norm_eps)
    return _logits(params, x, cfg), cache
