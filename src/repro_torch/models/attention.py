"""GQA attention with RoPE, optional QKV bias, sliding window, KV cache.

Layouts, as the reference's:
  q:  (B, S, Hq, hd)    k/v: (B, S, Hkv, hd)
  KV cache (decode): k/v (B, Hkv, S_max, hd), written in place at ``pos``.

Full-sequence attention always goes through the flash kernel
(:func:`repro_torch.kernels.ops.flash_attention`), with the reference's
``attn_impl="flash"`` semantics. Single-token decode is plain torch, as
in the reference: no kernel there.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..kernels import ops as kops
from ..kernels.ref import NEG_INF
from .common import apply_rope, dense_init, dtype_of, param


class Attention(nn.Module):
    """``wq`` (D, Hq*hd), ``wk``/``wv`` (D, Hkv*hd), ``wo`` (Hq*hd, D),
    and with ``cfg.qkv_bias`` the biases ``bq``, ``bk``, ``bv``."""

    def __init__(self, cfg, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        D, hd = cfg.d_model, cfg.resolved_head_dim
        Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
        self.wq = param((D, Hq * hd), dt, device)
        self.wk = param((D, Hkv * hd), dt, device)
        self.wv = param((D, Hkv * hd), dt, device)
        self.wo = param((Hq * hd, D), dt, device)
        if cfg.qkv_bias:
            self.bq = param((Hq * hd,), dt, device)
            self.bk = param((Hkv * hd,), dt, device)
            self.bv = param((Hkv * hd,), dt, device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        for name, w in self.named_parameters():
            if name.startswith("b"):
                w.zero_()
            else:
                w.copy_(dense_init(generator, w.shape, w.dtype, w.device))


def init_attention(cfg, generator, device):
    a = Attention(cfg, device)
    a.reset_parameters(generator)
    return a


def _project_qkv(p: Attention, x, cfg, positions):
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p.wq.to(x.dtype)
    k = x @ p.wk.to(x.dtype)
    v = x @ p.wv.to(x.dtype)
    if cfg.qkv_bias:
        q = q + p.bq.to(x.dtype)
        k = k + p.bk.to(x.dtype)
        v = v + p.bv.to(x.dtype)
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def causal_mask(Sq: int, Sk: int, window=None, offset: int = 0,
                device=None):
    """(1, Sq, Sk) boolean: query i attends key j iff j <= i + offset, and
    within the sliding window when set."""
    qi = torch.arange(Sq, device=device)[:, None] + offset
    kj = torch.arange(Sk, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m = m & (kj > qi - window)
    return m[None]


def attention(p: Attention, x, cfg, positions=None):
    """Full-sequence attention (prefill). Returns (out, (k, v)) with k, v
    in (B, S, Hkv, hd)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = kops.flash_attention(q, k, v, causal=True,
                               window=cfg.sliding_window)
    out = out.reshape(B, S, cfg.n_heads * cfg.resolved_head_dim)
    return out @ p.wo.to(x.dtype), (k, v)


def attention_decode(p: Attention, x, cache_k, cache_v, pos: int, cfg):
    """Single-token decode with a KV cache.

    x: (B, 1, D); cache_k/v: (B, Hkv, S_max, hd), written in place at the
    slot of ``pos`` (the same position for every sequence). With a sliding
    window and a window-sized cache the slots form a ring. Returns
    (out (B, 1, D), cache_k, cache_v)."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    S_max = cache_k.shape[2]
    ring = cfg.sliding_window is not None and S_max <= cfg.sliding_window
    write_idx = pos % S_max if ring else pos
    cache_k[:, :, write_idx] = k[:, 0].to(cache_k.dtype)
    cache_v[:, :, write_idx] = v[:, 0].to(cache_v.dtype)
    kj = torch.arange(S_max, device=x.device)
    if ring:
        valid = (kj <= pos) | (pos >= S_max)  # warmup, then all slots live
    else:
        valid = kj <= pos
        if cfg.sliding_window is not None:
            valid = valid & (kj > pos - cfg.sliding_window)
    # scores against the cache in its own (B, K, S, hd) layout: products of
    # the q-dtype values, summed in fp32 (the reference's einsums with
    # preferred_element_type=float32); probabilities rounded to q's dtype
    K = cfg.n_kv_heads
    G = cfg.n_heads // K
    qg = q.reshape(B, K, G, hd).float()
    kc = cache_k.to(q.dtype).float()
    vc = cache_v.to(q.dtype).float()
    scores = (qg @ kc.transpose(-1, -2)) / math.sqrt(hd)     # (B, K, G, S)
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype).float()
    out = (probs @ vc).to(x.dtype).reshape(B, 1, cfg.n_heads * hd)
    return out @ p.wo.to(x.dtype), cache_k, cache_v
