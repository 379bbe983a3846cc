"""Plain reference of Zamba2 (a Mamba-2 backbone with shared transformer
blocks), written from Zamba2-7B-Instruct as published (its
``config.json``, a ``Zamba2ForCausalLM``; the equations as
``modeling_zamba2.py`` computes them):

    x_0 = E[t]                                   token table (V, D), tied
    at layer l = hybrid_layer_ids[a], block b = a mod num_mem_blocks:
      c  = n_in,b(concat(x, x_0))                2D wide
      t  = W_o,b attn(rope(W_q,b c), rope(W_k,b c), W_v,b c)
      f  = n_ff,b(t)
      g, u = W_gate_up,b f + B_a (A_a f)         the LoRA of application a
      t' = W_lin,a (W_down,b (gelu(g) * u))      no residual in the block
      x  = x + mamba_l(n_l(x + t'))
    at every other layer l:  x = x + mamba_l(n_l(x))
    logits = E n_f(x_L)

Attention is causal, 32 query heads on 32 KV heads of ``attention_head_dim``
224, scores scaled by ``(hd/2)^-1/2`` (q multiplied by sqrt(2) before
:func:`dense.causal_attention`'s ``1/sqrt(hd)``), RoPE (theta
``rope_theta``) over all hd dims; gelu is the erf form. The Mamba-2 mixer:

    z, xBC, dt = split(W_in h)                   Di, Di + 2 G N, H
    xBC = silu(causal depthwise conv_K(xBC) + bias)
    x, B, C = split(xBC)                         B, C: (G, N); head j reads
                                                 group j // (H / G)
    dt = softplus(dt + dt_bias)                  no clamp (time_step_limit
                                                 null)
    y  = SSD(x, dt, A = -exp(A_log), B, C) + D x
    y  = n_group(y * silu(z)) w                  RMS over each group's Di/G
    out = W_out y

``n`` is RMSNorm with a weight (eps ``rms_norm_eps``; the gated norm's
1e-5). No biases but the conv's. No departures.

Everything is fp32 with TF32 off; one sequence at a time, layer by layer
(each layer's weights widened from the bf16 inputs as it runs), the scan in
the exact chunked SSD form of ``torch_forward`` (chunks of ``chunk_size``:
within a chunk the masked decay matrix, across chunks the carried state),
attention in blocks of queries, and the logits in blocks of rows, so that
a 4096-token prompt fits beside nothing else on the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import linear
from .dense import BLOCK, causal_attention, rms_norm, rope


def dims(c: dict) -> dict:
    D = c["hidden_size"]
    Di = c["mamba_expand"] * D
    return {"D": D, "L": c["num_hidden_layers"], "Di": Di,
            "H": c["n_mamba_heads"], "P": c["mamba_headdim"],
            "G": c["mamba_ngroups"], "N": c["mamba_d_state"],
            "K": c["mamba_d_conv"], "Hq": c["num_attention_heads"],
            "Hkv": c["num_key_value_heads"], "hd": c["attention_head_dim"],
            "F": c["intermediate_size"], "V": c["vocab_size"],
            "r": c["adapter_rank"], "nb": c["num_mem_blocks"],
            "apps": list(c["hybrid_layer_ids"])}


def weight_shapes(c: dict) -> dict:
    """{name: (shape, init[, "float32"])} of the weights, in the order
    they are made (:func:`perfbench.weights.make`): ``init`` a standard
    deviation, a (mean, standard deviation) pair, or ``"norm"``. Layer
    weights are stacked under ``layers.``, the shared blocks' under
    ``shared.``, each application's LoRA and linear under ``apps.``; a
    projection is stored (in, out). A_log, dt_bias and D are fp32."""
    d = dims(c)
    D, L, Di, H, G, N, K = (d[k] for k in "D L Di H G N K".split())
    Hq, Hkv, hd, Fh, V, r = (d[k] for k in "Hq Hkv hd F V r".split())
    nb, n_apps = d["nb"], len(d["apps"])
    conv = Di + 2 * G * N
    return {
        "embed.tok": ((V, D), 0.02),
        "layers.norm": ((L, D), "norm"),
        "layers.mamba.in_proj": ((L, D, Di + conv + H), D ** -0.5),
        "layers.mamba.conv_w": ((L, conv, K), K ** -0.5),
        "layers.mamba.conv_b": ((L, conv), 0.1),
        # A = exp(A_log) about 1.5 .. 11 (log 4, spread 0.5); softplus(dt)
        # about 1e-3 .. 0.1 once the projection's N(0, 1) dt is added
        "layers.mamba.A_log": ((L, H), (math.log(4.0), 0.5), "float32"),
        "layers.mamba.dt_bias": ((L, H), (-4.6, 0.5), "float32"),
        "layers.mamba.D": ((L, H), "norm", "float32"),
        "layers.mamba.norm_w": ((L, Di), "norm"),
        "layers.mamba.out_proj": ((L, Di, D), Di ** -0.5),
        "shared.attn_norm": ((nb, 2 * D), "norm"),
        "shared.mlp_norm": ((nb, D), "norm"),
        "shared.attn.wq": ((nb, 2 * D, Hq * hd), (2 * D) ** -0.5),
        "shared.attn.wk": ((nb, 2 * D, Hkv * hd), (2 * D) ** -0.5),
        "shared.attn.wv": ((nb, 2 * D, Hkv * hd), (2 * D) ** -0.5),
        "shared.attn.wo": ((nb, Hq * hd, D), (Hq * hd) ** -0.5),
        "shared.mlp.w_gate": ((nb, D, Fh), D ** -0.5),
        "shared.mlp.w_up": ((nb, D, Fh), D ** -0.5),
        "shared.mlp.w_down": ((nb, Fh, D), Fh ** -0.5),
        # the LoRA adds a quarter of gate_up's scale
        "apps.lora_a": ((n_apps, D, r), D ** -0.5),
        "apps.lora_b": ((n_apps, r, 2 * Fh), 0.25 * r ** -0.5),
        "apps.linear": ((n_apps, D, D), D ** -0.5),
        "final_norm": ((D,), "norm"),
    }


def conv1d(x, w, b):
    """Causal depthwise conv: x (S, C), w (C, K), b (C,); position t sees
    x[t-K+1 .. t], zeros before the first."""
    S, K = x.shape[0], w.shape[1]
    xp = torch.cat([x.new_zeros(K - 1, x.shape[1]), x])
    return sum(xp[i:i + S] * w[:, i].float() for i in range(K)) + b.float()


def ssd(x, dt, A, B, C, chunk: int):
    """The Mamba-2 scan in the chunked SSD form, from a zero state: x (S,
    H, P), dt (S, H), A (H,), B, C (S, G, N) (head j reads group
    ``j // (H / G)``). Returns y (S, H, P), without the D skip:
    ``y_t = sum_{s<=t} exp(sum_{s<r<=t} dt_r A) (C_t . B_s) dt_s x_s``."""
    S, H, P = x.shape
    rep = H // B.shape[1]
    Bh = B.repeat_interleave(rep, dim=1)                      # (S, H, N)
    Ch = C.repeat_interleave(rep, dim=1)
    state = x.new_zeros(H, P, B.shape[-1])
    out = torch.empty_like(x)
    for lo in range(0, S, chunk):
        hi = min(S, lo + chunk)
        xdt = x[lo:hi] * dt[lo:hi, :, None]                   # (l, H, P)
        cum = torch.cumsum(dt[lo:hi] * A, dim=0)              # (l, H)
        seg = cum[:, None, :] - cum[None, :, :]               # (l, s, H)
        keep = torch.ones(hi - lo, hi - lo, dtype=torch.bool,
                          device=x.device).tril()
        decay = torch.exp(seg.masked_fill(~keep[..., None], float("-inf")))
        w = torch.einsum("lhn,shn->lsh", Ch[lo:hi], Bh[lo:hi]) * decay
        y = torch.einsum("lsh,shp->lhp", w, xdt)
        y = y + torch.einsum("lhn,hpn->lhp", Ch[lo:hi], state) \
            * torch.exp(cum)[..., None]
        to_end = torch.exp(cum[-1][None] - cum)               # (l, H)
        state = state * torch.exp(cum[-1])[:, None, None] + torch.einsum(
            "shn,sh,shp->hpn", Bh[lo:hi], to_end, xdt)
        out[lo:hi] = y
    return out


def mamba(c: dict, W: dict, i: int, h, precision: str):
    """Layer ``i``'s Mamba-2 mixer on its normed input h (S, D)."""
    d = dims(c)
    Di, H, P, G, N = (d[k] for k in "Di H P G N".split())
    S = h.shape[0]

    def w(name):
        return W[f"layers.mamba.{name}"][i]
    proj = linear(h, w("in_proj"), precision)
    z, xBC, dt = proj.split([Di, Di + 2 * G * N, H], dim=-1)
    xBC = F.silu(conv1d(xBC, w("conv_w"), w("conv_b")))
    x, B, C = xBC.split([Di, G * N, G * N], dim=-1)
    dt = F.softplus(dt + w("dt_bias"))
    A = -torch.exp(w("A_log"))
    xh = x.reshape(S, H, P)
    y = ssd(xh, dt, A, B.reshape(S, G, N), C.reshape(S, G, N),
            c["chunk_size"]) + w("D")[:, None] * xh
    y = (y.reshape(S, Di) * F.silu(z)).reshape(S, G, Di // G)
    y = y * torch.rsqrt((y * y).mean(dim=-1, keepdim=True) + 1e-5)
    y = y.reshape(S, Di) * w("norm_w").float()
    return linear(y, w("out_proj"), precision)


def shared(c: dict, W: dict, a: int, x, emb, precision: str):
    """Application ``a``'s t' (S, D) on the hidden state x and the
    embedding emb."""
    d = dims(c)
    Hq, Hkv, hd, Fh = d["Hq"], d["Hkv"], d["hd"], d["F"]
    b = a % d["nb"]
    S = x.shape[0]

    def w(name):
        return W[f"shared.{name}"][b]
    h = rms_norm(torch.cat([x, emb], dim=-1), w("attn_norm"),
                 c["rms_norm_eps"])
    q = rope(linear(h, w("attn.wq"), precision).view(S, Hq, hd),
             c["rope_theta"])
    k = rope(linear(h, w("attn.wk"), precision).view(S, Hkv, hd),
             c["rope_theta"])
    v = linear(h, w("attn.wv"), precision).view(S, Hkv, hd)
    t = linear(causal_attention(q * math.sqrt(2.0), k, v), w("attn.wo"),
               precision)
    f = rms_norm(t, w("mlp_norm"), c["rms_norm_eps"])
    lora = linear(linear(f, W["apps.lora_a"][a], precision),
                  W["apps.lora_b"][a], precision)
    g = linear(f, w("mlp.w_gate"), precision) + lora[:, :Fh]
    u = linear(f, w("mlp.w_up"), precision) + lora[:, Fh:]
    t = linear(F.gelu(g) * u, w("mlp.w_down"), precision)
    return linear(t, W["apps.linear"][a], precision)


def hidden(c: dict, W: dict, tokens: torch.Tensor,
           precision: str = "fp32") -> torch.Tensor:
    """The final normed hidden state (S, D) of one sequence ``tokens``
    (S,), fp32."""
    at = {layer: a for a, layer in enumerate(c["hybrid_layer_ids"])}
    x = emb = W["embed.tok"][tokens.long()].float()
    for i in range(c["num_hidden_layers"]):
        t = shared(c, W, at[i], x, emb, precision) if i in at else None
        h = rms_norm(x if t is None else x + t, W["layers.norm"][i],
                     c["rms_norm_eps"])
        x = x + mamba(c, W, i, h, precision)
    return rms_norm(x, W["final_norm"], c["rms_norm_eps"])


def logit_blocks(c: dict, W: dict, tokens: torch.Tensor,
                 precision: str = "fp32", first: int = 0):
    """Yield ``(lo, logits)`` for the positions ``first`` .. S-1 of one
    sequence, ``BLOCK`` rows at a time: logits (rows, V) fp32 at
    positions lo, lo + 1, ... (the tied unembedding, E^T)."""
    x = hidden(c, W, tokens, precision)
    for lo in range(first, x.shape[0], BLOCK):
        yield lo, linear(x[lo:lo + BLOCK], W["embed.tok"].T, precision)
