"""Zamba2-style hybrid: a Mamba-2 backbone with shared attention blocks.

``cfg.shared_block`` picks the shared block's form.

``"residual"`` (the default, and the reference's): one transformer block
whose weights every application shares runs after every
``hybrid_attn_period`` Mamba-2 blocks, over the hidden state, with its
own residual adds (``x + attn``, ``x + mlp``); each application keeps its
own KV cache. With 81 blocks and a period of 6 that is 13 segments of 6
blocks, each followed by the shared block, and a tail of 3 blocks.

``"zamba2"`` (Zamba2-7B as published, ``modeling_zamba2.py``):
``cfg.num_mem_blocks`` shared blocks taken in turn (application a runs
block ``a % num_mem_blocks``) at the layers ``cfg.hybrid_layer_ids``.
Application a at layer l reads ``c = concat(h, x_emb)`` (2D wide: the
hidden state entering layer l and the token embedding) and computes

    t  = attn(n_in(c))                 q, k, v: 2D -> Hq*hd; o: -> D
    t  = mlp_a(n_ff(t))                gate_up + its own rank-r LoRA
    t' = t @ linear_a                  its own D x D
    h  = h + mamba_l(n_l(h + t'))

with no residual inside the block: t' enters layer l's mixer input alone.
Scores are scaled by ``(hd/2)^-1/2`` (:attr:`ModelConfig.query_scale`).
``cfg.adapter_rank`` (0: no LoRA) and ``cfg.hidden_act`` (the MLP's
activation) complete it; ``cfg.mamba_ngroups`` (B/C groups,
:func:`~repro_torch.models.ssm.mamba2_block`) applies to either form. At
their defaults these fields give the reference's bits; the mesh path
takes none of them (it raises, naming them).

A prompt runs the scan kernel in every Mamba-2 block and the attention
kernel in every application; a decode step runs the state-step kernel
(K5) in every Mamba-2 block and the decode-attention kernel in every
application, on the card.
``forward`` takes the route by its ``impl`` argument (``"xla"`` to train)
and, with ``cfg.remat == "full"``, rematerialises each Mamba-2 block, as
the reference does (its shared block is not rematerialised).

Spans (:mod:`repro_torch.obs`): ``shared`` around each application of
the ``"zamba2"`` form (from the concat to ``linear_a``), ``mamba`` and
``mamba.scan`` in each mixer; counters ``mamba.state_bytes``: the conv
and SSM state a decode step reads and writes, and
``mamba.state_step_kernel``: one a layer's decode step through K5, both
counted on the host.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import obs
from . import attention as attn_mod
from .common import (FSDP, TP, Embeddings, P, assign, current_mesh,
                     dense_init, dtype_of, embed_tokens, layer_call,
                     matmul, mesh_zeros, param, podify, rms_norm,
                     spec_embeddings, unembed)
from .mlp import MLP, mlp, spec_mlp
from .ssm import Mamba2, mamba2_block, spec_mamba, uses_state_step_kernel
from .transformer import cache_write


def n_attn_applications(cfg) -> int:
    if cfg.shared_block == "zamba2":
        return len(cfg.hybrid_layer_ids)
    return (cfg.n_layers // cfg.hybrid_attn_period
            if cfg.hybrid_attn_period else 0)


def _check_form(cfg) -> None:
    """Raise on a shared-block form the fields do not make whole."""
    if cfg.shared_block == "residual":
        extra = [n for n in ("num_mem_blocks", "adapter_rank",
                             "hybrid_layer_ids")
                 if n in cfg.port_fields_set()]
        if extra:
            raise ValueError(f"{extra} are fields of the shared_block="
                             "'zamba2' form, not of 'residual'")
        return
    if cfg.shared_block != "zamba2":
        raise ValueError(f"shared_block must be 'residual' or 'zamba2', "
                         f"got {cfg.shared_block!r}")
    ids = list(cfg.hybrid_layer_ids)
    if not ids or ids != sorted(set(ids)) or ids[0] < 0 or \
            ids[-1] >= cfg.n_layers:
        raise ValueError(f"hybrid_layer_ids must be distinct increasing "
                         f"layers below {cfg.n_layers}, got {ids}")
    if cfg.num_mem_blocks < 1 or cfg.adapter_rank < 0:
        raise ValueError("num_mem_blocks must be >= 1 and adapter_rank "
                         ">= 0")


def _no_mesh(cfg) -> None:
    """The mesh path takes none of the port's added fields."""
    fields = cfg.port_fields_set()
    if fields and current_mesh() is not None:
        raise ValueError(f"the hybrid's {fields} are not supported under a "
                         "mesh")


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
    for every application (of this block). In the ``"zamba2"`` form
    ``attn_norm`` and the attention's input are 2D wide (the concat)."""

    def __init__(self, cfg, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        d_in = cfg.d_model * (2 if cfg.shared_block == "zamba2" else 1)
        self.attn_norm = param((d_in,), dt, device)
        self.mlp_norm = param((cfg.d_model,), dt, device)
        self.attn = attn_mod.Attention(cfg, device, d_in=d_in)
        self.mlp = MLP(cfg, device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.attn_norm.fill_(1.0)
        self.mlp_norm.fill_(1.0)
        self.attn.reset_parameters(generator)
        self.mlp.reset_parameters(generator)


class Application(nn.Module):
    """One application's own weights in the ``"zamba2"`` form: the
    LoRA on the MLP's gate_up, ``lora_a`` (D, r) and ``lora_b`` (r, 2F)
    (none with ``adapter_rank`` 0), and ``linear`` (D, D)."""

    def __init__(self, cfg, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        D, r = cfg.d_model, cfg.adapter_rank
        if r:
            self.lora_a = param((D, r), dt, device)
            self.lora_b = param((r, 2 * cfg.d_ff), dt, device)
        self.linear = param((D, D), dt, device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        for w in self.parameters():
            w.copy_(dense_init(generator, w.shape, w.dtype, w.device))


class HybridLM(nn.Module):
    """Parameters named as the reference's tree: ``embed.tok``,
    ``layers.<i>.norm``, ``layers.<i>.mamba.in_proj``,
    ``shared_attn.attn.wq``, ``final_norm``, …; in the ``"zamba2"`` form
    ``shared.<b>.attn.wq`` for each shared block and
    ``apps.<a>.lora_a``, ``apps.<a>.linear`` for each application in
    place of ``shared_attn``."""

    def __init__(self, cfg, device):
        super().__init__()
        _check_form(cfg)
        self.cfg = cfg
        self.embed = Embeddings(cfg, device)
        self.layers = nn.ModuleList(HybridLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        if cfg.shared_block == "zamba2":
            self.shared = nn.ModuleList(SharedBlock(cfg, device)
                                        for _ in range(cfg.num_mem_blocks))
            self.apps = nn.ModuleList(Application(cfg, device)
                                      for _ in cfg.hybrid_layer_ids)
        elif cfg.hybrid_attn_period:
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
        for m in [*getattr(self, "shared", ()), *getattr(self, "apps", ())]:
            m.reset_parameters(generator)
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
    block = {"attn_norm": P(None), "mlp_norm": P(None),
             "attn": attn_mod.spec_attention(cfg), "mlp": spec_mlp()}
    if cfg.shared_block == "zamba2":
        p["shared"] = block
        p["apps"] = {"linear": P(FSDP, TP)}
        if cfg.adapter_rank:
            p["apps"].update(lora_a=P(FSDP, None), lora_b=P(None, TP))
    elif cfg.hybrid_attn_period:
        p["shared_attn"] = block
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


def _application(params: HybridLM, a: int, x, emb, cfg, attend):
    """Application ``a`` of the ``"zamba2"`` form on the hidden state
    ``x`` and the embedding ``emb``: (t', what ``attend`` gave beside
    its output). ``attend(attn, c) -> (out, extra)`` runs the shared
    block's attention on the normed concat ``c`` (a prompt's, or one
    decode step's over the cache)."""
    with obs.span("shared"):
        sp, ap = params.shared[a % cfg.num_mem_blocks], params.apps[a]
        c = rms_norm(torch.cat([x, emb], dim=-1), sp.attn_norm,
                     cfg.norm_eps)
        t, extra = attend(sp.attn, c)
        t = mlp(sp.mlp, rms_norm(t, sp.mlp_norm, cfg.norm_eps),
                ap if cfg.adapter_rank else None)
        return matmul(t, ap.linear.to(t.dtype)), extra


def _mamba_in(lp, x, t, cfg):
    """Layer ``lp``'s mixer input: n_l(h), or n_l(h + t') where an
    application feeds it."""
    return rms_norm(x if t is None else x + t, lp.norm, cfg.norm_eps)


def _run_zamba2(params: HybridLM, x, cfg, cache=None, impl: str = "flash"):
    """:func:`_run` in the ``"zamba2"`` form: at each layer of
    ``hybrid_layer_ids`` its application first, whose t' enters that
    layer's mixer input."""
    emb = x
    at = {layer: a for a, layer in enumerate(cfg.hybrid_layer_ids)}

    def block(x, lp, t):
        h, st = mamba2_block(lp.mamba, _mamba_in(lp, x, t, cfg), cfg,
                             impl=impl)
        return x + h, st

    for i, lp in enumerate(params.layers):
        t = None
        if i in at:
            t, (k, v) = _application(
                params, at[i], x, emb, cfg,
                lambda p, c: attn_mod.attention(p, c, cfg, impl=impl))
            if cache is not None:
                cache_write(k.transpose(1, 2), cache["attn_k"][at[i]])
                cache_write(v.transpose(1, 2), cache["attn_v"][at[i]])
        if cache is None:
            x, _ = layer_call(cfg, block, x, lp, t)
            continue
        x, st = block(x, lp, t)
        assign(cache["conv"], (i,), st["conv"])
        assign(cache["ssm"], (i,), st["ssm"])
    return x


def forward(params: HybridLM, tokens, cfg, impl: str = "flash"):
    _no_mesh(cfg)
    run = _run_zamba2 if cfg.shared_block == "zamba2" else _run
    x = run(params, embed_tokens(params.embed, tokens, cfg), cfg, impl=impl)
    return (_head(params, x, cfg),
            torch.zeros((), dtype=torch.float32, device=x.device))


# ---------------------------------------------------------------------- #
#  Serving
# ---------------------------------------------------------------------- #
def init_cache(cfg, batch: int, max_seq: int, dtype=torch.bfloat16,
               device=None):
    """conv (L, B, K-1, Di+2GN) and ssm (L, B, H, Pd, N) fp32 per block;
    attn_k/attn_v (n_apps, B, Hkv, max_seq, hd) per application."""
    Di, K = cfg.d_inner, cfg.ssm_conv
    N = cfg.ssm_state
    Pd = cfg.ssm_head_dim
    L = cfg.n_layers
    n_apps = n_attn_applications(cfg)
    cache = {
        "conv": torch.zeros((L, batch, K - 1,
                             Di + 2 * cfg.mamba_ngroups * N), dtype=dtype,
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
    _no_mesh(cfg)
    x = embed_tokens(params.embed, tokens, cfg)
    cache = mesh_zeros(lambda dev: init_cache(cfg, x.shape[0], max_seq,
                                              cache_dtype, dev),
                       podify(cache_specs(cfg)), x.device)
    run = _run_zamba2 if cfg.shared_block == "zamba2" else _run
    x = run(params, x, cfg, cache, impl)
    return _head(params, x, cfg), cache


#: the families of this module whose decode step can be captured in a
#: CUDA graph (:func:`repro_torch.train.serve.make_serve_step`): with a
#: tensor ``pos`` it makes no host sync
GRAPH_DECODE_FAMILIES = ("hybrid",)
#: the cache entries a decode step rewrites beyond its position: the
#: conv and SSM state (``model.graph_policy``)
RECURRENT_CACHE = ("conv", "ssm")
#: a graph holds the cache weakly and captures anew on a new request's:
#: at Zamba2-7B's 32 x 2048 positions a cache is 29 GB, and holding the
#: last request's beside the next one's would fill the card
GRAPH_RECAPTURES = True


def count_decode_step(cfg, cache, pos: int) -> None:
    """What one decode step at ``pos`` counts: the applications'
    attention positions (:func:`attention.count_positions`, on the
    route the step takes) and the mixers' state (:func:`_count_states`)."""
    if "attn_k" in cache:
        n, B, _, S_max, _ = cache["attn_k"].shape
        attn_mod.count_positions(
            B, S_max, pos, cfg.sliding_window, n,
            kernel=attn_mod.uses_decode_kernel(
                cache["attn_k"], dtype_of(cfg.activation_dtype)))
    _count_states(cache)


def _count_states(cache) -> None:
    """The conv and SSM state a decode step reads and writes
    (``mamba.state_bytes``) and, where its mixers go through K5
    (:func:`~repro_torch.models.ssm.uses_state_step_kernel`), one
    ``mamba.state_step_kernel`` a layer."""
    obs.count("mamba.state_bytes",
              2 * (cache["conv"].nbytes + cache["ssm"].nbytes))
    if uses_state_step_kernel(cache["ssm"]):
        obs.count("mamba.state_step_kernel", cache["ssm"].shape[0])


def decode_step(params: HybridLM, cache, tokens, pos, cfg):
    """tokens: (B, 1); pos: an int, or a 0-d int64 tensor on the tokens'
    device (:func:`attention.attention_decode`; nothing is counted then,
    the caller counts: :func:`count_decode_step`). Returns (logits,
    cache); the cache tensors are updated in place."""
    _no_mesh(cfg)
    if obs.on and not isinstance(pos, torch.Tensor):
        _count_states(cache)
    if cfg.shared_block == "zamba2":
        return _decode_zamba2(params, cache, tokens, pos, cfg)
    x = embed_tokens(params.embed, tokens, cfg)
    n_apps = n_attn_applications(cfg)
    for a, (lo, hi) in enumerate(_segments(cfg)):
        for i in range(lo, hi):
            lp = params.layers[i]
            x = x + _state_step(lp, rms_norm(x, lp.norm, cfg.norm_eps),
                                cache, i, cfg)
        if a < n_apps:
            sp = params.shared_attn
            h, _, _ = attn_mod.attention_decode(
                sp.attn, rms_norm(x, sp.attn_norm, cfg.norm_eps),
                cache["attn_k"][a], cache["attn_v"][a], pos, cfg)
            x = x + h
            x = x + mlp(sp.mlp, rms_norm(x, sp.mlp_norm, cfg.norm_eps))
    return _head(params, x, cfg), cache


def _state_step(lp, x, cache, i: int, cfg):
    """Layer ``i``'s mixer over one token (its normed input ``x``) from
    the cached conv and SSM state, written back in place: by the block
    itself off a mesh (it returns the cache's own tensors), else here."""
    state = {n: cache[n][i] for n in RECURRENT_CACHE}
    h, st = mamba2_block(lp.mamba, x, cfg, state=state)
    for n in RECURRENT_CACHE:
        if st[n] is not state[n]:
            assign(cache[n], (i,), st[n])
    return h


def _decode_zamba2(params: HybridLM, cache, tokens, pos, cfg):
    """:func:`decode_step` in the ``"zamba2"`` form."""
    x = emb = embed_tokens(params.embed, tokens, cfg)
    at = {layer: a for a, layer in enumerate(cfg.hybrid_layer_ids)}
    for i, lp in enumerate(params.layers):
        t = None
        if i in at:
            a = at[i]
            t, _ = _application(
                params, a, x, emb, cfg,
                lambda p, c: attn_mod.attention_decode(
                    p, c, cache["attn_k"][a], cache["attn_v"][a], pos,
                    cfg)[:2])
        x = x + _state_step(lp, _mamba_in(lp, x, t, cfg), cache, i, cfg)
    return _head(params, x, cfg), cache
