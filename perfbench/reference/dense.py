"""Plain reference of a dense GQA decoder, written from Mistral-NeMo-12B
as published (Mistral-Nemo-Base-2407's ``config.json``, a
``MistralForCausalLM``):

    x_0 = E[t]                                      token table (V, D)
    h   = x + W_o · attn(rope(W_q n_a(x)), rope(W_k n_a(x)), W_v n_a(x))
    x'  = h + W_down (silu(W_gate n_m(h)) ⊙ W_up n_m(h))
    logits = W_unembed n_f(x_L)

``n`` is RMSNorm with a weight (eps ``rms_norm_eps``); attention is
causal over all earlier positions (``sliding_window`` null), 32 query
heads on 8 KV heads of 128, scores scaled by ``1/sqrt(head_dim)``; RoPE
rotates the pairs (i, i + hd/2) by ``pos * theta^(-2i/hd)``. No biases;
the unembedding is its own matrix. No departures.

Everything is fp32 with TF32 off; one sequence at a time, layer by layer
(each layer's weights widened from the bf16 inputs as it runs), attention
in blocks of queries, and the logits in blocks of rows, so that an
8192-token prompt fits beside nothing else on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import linear

BLOCK = 1024


def weight_shapes(c: dict) -> dict:
    """{name: (shape, init)} of the weights, in the order they are made:
    ``init`` is a standard deviation, or ``"norm"`` (a norm weight,
    ``1 + N(0, 0.1^2)``). Layer weights are stacked on a leading axis
    under ``layers.``; a projection is stored (in, out)."""
    D, L = c["hidden_size"], c["num_hidden_layers"]
    Hq, Hkv = c["num_attention_heads"], c["num_key_value_heads"]
    hd = c.get("head_dim") or D // Hq
    Fh, V = c["intermediate_size"], c["vocab_size"]
    return {
        "embed.tok": ((V, D), 0.02),
        "embed.unembed": ((D, V), D ** -0.5),
        "layers.attn_norm": ((L, D), "norm"),
        "layers.mlp_norm": ((L, D), "norm"),
        "layers.attn.wq": ((L, D, Hq * hd), D ** -0.5),
        "layers.attn.wk": ((L, D, Hkv * hd), D ** -0.5),
        "layers.attn.wv": ((L, D, Hkv * hd), D ** -0.5),
        "layers.attn.wo": ((L, Hq * hd, D), (Hq * hd) ** -0.5),
        "layers.mlp.w_gate": ((L, D, Fh), D ** -0.5),
        "layers.mlp.w_up": ((L, D, Fh), D ** -0.5),
        "layers.mlp.w_down": ((L, Fh, D), Fh ** -0.5),
        "final_norm": ((D,), "norm"),
    }


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) \
        * w.float()


def rope(x, theta: float):
    """x: (S, H, hd) at positions 0 .. S-1; angles in float64."""
    S, _, hd = x.shape
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float64,
                                  device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] \
        * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q, k, v, window=None):
    """q: (S, Hq, hd), k, v: (S, Hkv, hd), fp32. Returns (S, Hq*hd)."""
    S, Hq, hd = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    kt = k.permute(1, 2, 0)                              # (Hkv, hd, S)
    vt = v.permute(1, 0, 2)                              # (Hkv, S, hd)
    out = torch.empty((S, Hq, hd), dtype=torch.float32, device=q.device)
    keys = torch.arange(S, device=q.device)
    for lo in range(0, S, BLOCK):
        hi = min(S, lo + BLOCK)
        qb = q[lo:hi].reshape(hi - lo, Hkv, G, hd).permute(1, 2, 0, 3)
        s = (qb @ kt[:, None]) / math.sqrt(hd)           # (Hkv, G, b, S)
        rows = torch.arange(lo, hi, device=q.device)[:, None]
        keep = keys[None, :] <= rows
        if window is not None:
            keep = keep & (keys[None, :] > rows - window)
        s = s.masked_fill(~keep, float("-inf"))
        p = torch.softmax(s, dim=-1)
        o = p @ vt[:, None]                              # (Hkv, G, b, hd)
        out[lo:hi] = o.permute(2, 0, 1, 3).reshape(hi - lo, Hq, hd)
    return out.reshape(S, Hq * hd)


def hidden(c: dict, W: dict, tokens: torch.Tensor,
           precision: str = "fp32") -> torch.Tensor:
    """The final normed hidden state (S, D) of one sequence ``tokens``
    (S,), fp32."""
    D, L = c["hidden_size"], c["num_hidden_layers"]
    Hq, Hkv = c["num_attention_heads"], c["num_key_value_heads"]
    hd = c.get("head_dim") or D // Hq
    eps, theta = c["rms_norm_eps"], c["rope_theta"]
    S = tokens.shape[0]
    x = W["embed.tok"][tokens.long()].float()
    for i in range(L):
        def w(name):
            return W[f"layers.{name}"][i]
        h = rms_norm(x, w("attn_norm"), eps)
        q = rope(linear(h, w("attn.wq"), precision).view(S, Hq, hd), theta)
        k = rope(linear(h, w("attn.wk"), precision).view(S, Hkv, hd), theta)
        v = linear(h, w("attn.wv"), precision).view(S, Hkv, hd)
        a = causal_attention(q, k, v, c.get("sliding_window"))
        x = x + linear(a, w("attn.wo"), precision)
        h = rms_norm(x, w("mlp_norm"), eps)
        g = F.silu(linear(h, w("mlp.w_gate"), precision))
        x = x + linear(g * linear(h, w("mlp.w_up"), precision),
                       w("mlp.w_down"), precision)
    return rms_norm(x, W["final_norm"], eps)


def logit_blocks(c: dict, W: dict, tokens: torch.Tensor,
                 precision: str = "fp32", first: int = 0):
    """Yield ``(lo, logits)`` for the positions ``first`` .. S-1 of one
    sequence, ``BLOCK`` rows at a time: logits (rows, V) fp32 at
    positions lo, lo + 1, ..."""
    x = hidden(c, W, tokens, precision)
    for lo in range(first, x.shape[0], BLOCK):
        yield lo, linear(x[lo:lo + BLOCK], W["embed.unembed"], precision)
