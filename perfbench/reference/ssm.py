"""Plain reference of FalconMamba (an attention-free stack of Mamba-1
mixers), written from falcon-mamba-7b as published (its ``config.json``,
a ``FalconMambaForCausalLM``; the equations as
``modeling_falcon_mamba.py`` computes them):

    x_0 = E[t]                                   token table (V, D)
    at every layer l:  x = x + mamba_l(n_l(x))   (the residual stream)
    logits = W_head n_f(x_L)                     LM head (D, V), untied

The Mamba-1 mixer, on its normed input h:

    x, z = split(W_in h)                         Di each
    x  = silu(causal depthwise conv_K(x) + bias)
    dt, B, C = split(W_x x)                      R, N, N
    dt, B, C = r(dt), r(B), r(C)                 weightless RMS norms
    dt = softplus(W_dt dt + dt_bias)             (Di,) a step
    h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t   A = -exp(A_log) (Di, N),
                                                 elementwise; h_0 = 0
    y_t = h_t C_t + D x_t
    out = W_out (y * silu(z))

``n`` is RMSNorm with a weight (eps ``layer_norm_epsilon``); ``r``
normalises dt over its R ranks, B and C over their N states, each to
unit RMS with no weight (eps ``mixer_rms_eps``). No biases but the
conv's and dt's. No departures: the published model holds the stream in
fp32 (``residual_in_fp32``) and rounds elsewhere to bf16; here nothing is
rounded.

Everything is fp32 with TF32 off; one sequence at a time, layer by layer
(each layer's weights widened from the bf16 inputs as it runs), the scan
in the exact chunked form of :func:`scan`, and the logits in blocks of
rows. On an H100 80GB HBM3 an 8 224-token sequence (64 layers, then
every position's logits) takes 6.5 s.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import linear
from .dense import BLOCK, rms_norm
from .hybrid import conv1d

#: steps of the scan's chunks (:func:`scan`)
CHUNK = 64


def dims(c: dict) -> dict:
    return {"D": c["hidden_size"], "L": c["num_hidden_layers"],
            "Di": c["intermediate_size"], "N": c["state_size"],
            "K": c["conv_kernel"], "R": c["time_step_rank"],
            "V": c["vocab_size"]}


def weight_shapes(c: dict) -> dict:
    """{name: (shape, init[, "float32"])} of the weights, in the order
    they are made (:func:`perfbench.weights.make`): ``init`` a standard
    deviation, a (mean, standard deviation) pair, or ``"norm"``. Layer
    weights are stacked under ``layers.``; a projection is stored (in,
    out). dt_bias, A_log and D are fp32."""
    d = dims(c)
    D, L, Di, N, K, R, V = (d[k] for k in "D L Di N K R V".split())
    return {
        "embed.tok": ((V, D), 0.02),
        "layers.norm": ((L, D), "norm"),
        "layers.mamba.in_proj": ((L, D, 2 * Di), D ** -0.5),
        "layers.mamba.conv_w": ((L, Di, K), K ** -0.5),
        "layers.mamba.conv_b": ((L, Di), 0.1),
        "layers.mamba.x_proj": ((L, Di, R + 2 * N), Di ** -0.5),
        "layers.mamba.dt_proj": ((L, R, Di), R ** -0.5),
        # softplus(dt) about 1e-3 .. 0.1 (time_step_min .. time_step_max)
        # once the projection's N(0, 1) dt is added
        "layers.mamba.dt_bias": ((L, Di), (-4.6, 0.5), "float32"),
        # A = exp(A_log) about 1 .. 16: the published init's log(1 .. N)
        # in mean and spread
        "layers.mamba.A_log": ((L, Di, N), (math.log(6.0), 0.75),
                               "float32"),
        "layers.mamba.D": ((L, Di), "norm", "float32"),
        "layers.mamba.out_proj": ((L, Di, D), Di ** -0.5),
        "final_norm": ((D,), "norm"),
        "embed.unembed": ((D, V), D ** -0.5),
    }


def unit_rms(x, eps):
    """x over its last dim to unit RMS, no weight."""
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)


def scan(x, dt, A, B, C, chunk: int = CHUNK):
    """The Mamba-1 recurrence from a zero state: x, dt (S, Di); A (Di,
    N); B, C (S, N). Returns y (S, Di) without the D skip,
    ``y_t = sum_n C_t[n] sum_{s<=t} exp(A[:, n] sum_{s<r<=t} dt_r)
    dt_s x_s B_s[n]``.

    Exact in a chunked form: the steps of every chunk of ``chunk`` run as
    the recurrence from a zero state, all chunks at once; then the
    chunks' end states are carried from one chunk to the next, and each
    position adds the state carried into its chunk, decayed by
    ``exp(A sum dt)`` over the chunk's steps up to it. A zero padding
    (dt 0) fills the last chunk."""
    S, Di = x.shape
    N = A.shape[1]
    n = -(-S // chunk)
    pad = n * chunk - S
    xdt, dt, B, C = (F.pad(t, (0, 0, 0, pad)) for t in (x * dt, dt, B, C))
    xdt, dt = xdt.view(n, chunk, Di), dt.view(n, chunk, Di)
    B, C = B.view(n, chunk, N), C.view(n, chunk, N)
    h = x.new_zeros(n, Di, N)
    y = x.new_empty(n, chunk, Di)
    for j in range(chunk):
        h = torch.exp(dt[:, j, :, None] * A) * h \
            + xdt[:, j, :, None] * B[:, j, None, :]
        y[:, j] = torch.einsum("cdn,cn->cd", h, C[:, j])
    cum = torch.cumsum(dt, dim=1)                            # (n, l, Di)
    carried = x.new_zeros(Di, N)
    for k in range(n):
        if k:
            y[k] += torch.einsum("ldn,ln->ld", torch.exp(
                cum[k, :, :, None] * A) * carried, C[k])
        carried = torch.exp(cum[k, -1, :, None] * A) * carried + h[k]
    return y.view(n * chunk, Di)[:S]


def mamba(c: dict, W: dict, i: int, h, precision: str):
    """Layer ``i``'s Mamba-1 mixer on its normed input h (S, D)."""
    d = dims(c)
    Di, N, R = d["Di"], d["N"], d["R"]
    eps = c["mixer_rms_eps"]

    def w(name):
        return W[f"layers.mamba.{name}"][i]
    x, z = linear(h, w("in_proj"), precision).split([Di, Di], dim=-1)
    x = F.silu(conv1d(x, w("conv_w"), w("conv_b")))
    dt, B, C = linear(x, w("x_proj"), precision).split([R, N, N], dim=-1)
    dt, B, C = unit_rms(dt, eps), unit_rms(B, eps), unit_rms(C, eps)
    dt = F.softplus(linear(dt, w("dt_proj"), precision) + w("dt_bias"))
    A = -torch.exp(w("A_log"))
    y = scan(x, dt, A, B, C) + w("D") * x
    return linear(y * F.silu(z), w("out_proj"), precision)


def hidden(c: dict, W: dict, tokens: torch.Tensor,
           precision: str = "fp32") -> torch.Tensor:
    """The final normed hidden state (S, D) of one sequence ``tokens``
    (S,), fp32."""
    eps = c["layer_norm_epsilon"]
    x = W["embed.tok"][tokens.long()].float()
    for i in range(c["num_hidden_layers"]):
        x = x + mamba(c, W, i, rms_norm(x, W["layers.norm"][i], eps),
                      precision)
    return rms_norm(x, W["final_norm"], eps)


def logit_blocks(c: dict, W: dict, tokens: torch.Tensor,
                 precision: str = "fp32", first: int = 0):
    """Yield ``(lo, logits)`` for the positions ``first`` .. S-1 of one
    sequence, ``BLOCK`` rows at a time: logits (rows, V) fp32 at
    positions lo, lo + 1, ... (the LM head, untied)."""
    x = hidden(c, W, tokens, precision)
    for lo in range(first, x.shape[0], BLOCK):
        yield lo, linear(x[lo:lo + BLOCK], W["embed.unembed"], precision)
