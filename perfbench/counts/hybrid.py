"""Counts of Zamba2 (a Mamba-2 backbone with shared transformer blocks)
from its configuration file's keys: a prefill of B prompts of S tokens,
one decode step of B sequences, and the Mamba-2 scan of one layer.

A prefill needs the prompt through every layer (each Mamba-2 mixer's
projections and scan; at each of the ``hybrid_layer_ids`` the shared
block's products, its application's LoRA and linear, attention over the
live pairs), the KV cache and the conv and SSM state written, and the
logits of the last position; a decode step needs every weight once, the
cached positions attended, the new K and V written, each layer's conv
and SSM state read and written, and the logits. The weights, the KV and
conv caches are bf16 as served, the SSM state, A_log, dt_bias and D fp32,
the logits fp32; the unembedding is the token table (tied), read once.
Norms, RoPE, the conv and the activations are left out of the operations
(a few per element, against thousands per element in the products)."""
from __future__ import annotations

from . import attention

BF16, FP32 = 2, 4


def dims(c: dict) -> dict:
    D = c["hidden_size"]
    Di = c["mamba_expand"] * D
    G, N = c["mamba_ngroups"], c["mamba_d_state"]
    return {"D": D, "L": c["num_hidden_layers"], "Di": Di,
            "H": c["n_mamba_heads"], "P": c["mamba_headdim"], "G": G,
            "N": N, "K": c["mamba_d_conv"], "conv": Di + 2 * G * N,
            "Hq": c["num_attention_heads"], "Hkv": c["num_key_value_heads"],
            "hd": c["attention_head_dim"], "F": c["intermediate_size"],
            "V": c["vocab_size"], "r": c["adapter_rank"],
            "nb": c["num_mem_blocks"], "apps": len(c["hybrid_layer_ids"])}


def mamba_matmul_params(c: dict) -> int:
    """Weights of one Mamba-2 mixer's products: in_proj, out_proj."""
    d = dims(c)
    return d["D"] * (d["Di"] + d["conv"] + d["H"]) + d["Di"] * d["D"]


def shared_matmul_params(c: dict) -> int:
    """Weights of one application's products: the shared block's q, k,
    v (from the 2D-wide concat), o and gated MLP, and the application's
    own LoRA and linear."""
    d = dims(c)
    D, hd, F, r = d["D"], d["hd"], d["F"], d["r"]
    return (2 * D * (d["Hq"] + 2 * d["Hkv"]) * hd + d["Hq"] * hd * D
            + 3 * D * F + D * r + r * 2 * F + D * D)


def weight_bytes(c: dict) -> int:
    """Every weight once: each layer's mixer (its products, the conv
    and its bias, the gated norm, the layer norm in bf16; A_log, dt_bias
    and D in fp32), the shared blocks and the applications' own weights,
    the final norm and the token table (the tied unembedding)."""
    d = dims(c)
    D, L, F, hd = d["D"], d["L"], d["F"], d["hd"]
    layer = (mamba_matmul_params(c) + d["conv"] * (d["K"] + 1) + d["Di"]
             + D)
    block = (2 * D * (d["Hq"] + 2 * d["Hkv"]) * hd + d["Hq"] * hd * D
             + 3 * D * F + 2 * D + D)
    app = D * d["r"] + d["r"] * 2 * F + D * D
    return (BF16 * (L * layer + d["nb"] * block + d["apps"] * app + D
                    + d["V"] * D)
            + FP32 * L * 3 * d["H"])


def kv_bytes_per_position(c: dict) -> int:
    d = dims(c)
    return BF16 * d["apps"] * 2 * d["Hkv"] * d["hd"]


def state_bytes(c: dict) -> int:
    """One sequence's conv state (bf16) and SSM state (fp32), every
    layer."""
    d = dims(c)
    return d["L"] * (BF16 * (d["K"] - 1) * d["conv"]
                     + FP32 * d["H"] * d["P"] * d["N"])


def scan(B: int, L: int, H: int, P: int, G: int, N: int
         ) -> tuple[int, int]:
    """(operations, bytes) of one layer's Mamba-2 scan over B sequences of
    L steps: H heads of P channels, G groups of B and C with N states.
    Operations: the recurrence's two multiply-adds a state element and
    step, the input ``(dt x) B`` into the state and the state into ``y``
    through C (the decay's multiply left out), at two operations each;
    no chunked form computes fewer. Bytes once at the served dtypes: x
    and y bf16, dt (a head) and B and C bf16, the final state written
    fp32, A and D fp32."""
    ops = 2 * 2 * B * L * H * P * N
    nbytes = (BF16 * (2 * B * L * H * P + B * L * H + 2 * B * L * G * N)
              + FP32 * (B * H * P * N + 2 * H))
    return ops, nbytes


def prefill(c: dict, B: int, S: int) -> tuple[int, int]:
    """(operations, bytes) of one prefill of B prompts of S tokens."""
    d = dims(c)
    D, L, V = d["D"], d["L"], d["V"]
    attn_ops, _ = attention(B, S, S, d["Hq"], d["Hkv"], d["hd"], BF16)
    scan_ops, _ = scan(B, S, d["H"], d["P"], d["G"], d["N"])
    ops = (2 * B * S * (L * mamba_matmul_params(c)
                        + d["apps"] * shared_matmul_params(c))
           + L * scan_ops + d["apps"] * attn_ops + 2 * B * D * V)
    nbytes = (weight_bytes(c) + BF16 * B * S * D + 4 * B * S
              + B * S * kv_bytes_per_position(c) + B * state_bytes(c)
              + FP32 * B * V)
    return ops, nbytes


def decode_step(c: dict, B: int, pos: int) -> tuple[int, int]:
    """(operations, bytes) of one decode step of B sequences writing
    position ``pos``: the new token attends the ``pos + 1`` positions up
    to itself in each application; each layer's state is read and
    written once."""
    d = dims(c)
    D, L, V = d["D"], d["L"], d["V"]
    attn_ops, _ = attention(B, 1, pos + 1, d["Hq"], d["Hkv"], d["hd"], BF16)
    scan_ops, _ = scan(B, 1, d["H"], d["P"], d["G"], d["N"])
    ops = (2 * B * (L * mamba_matmul_params(c)
                    + d["apps"] * shared_matmul_params(c) + D * V)
           + L * scan_ops + d["apps"] * attn_ops)
    nbytes = (weight_bytes(c) + BF16 * B * D + 4 * B
              + B * pos * kv_bytes_per_position(c)
              + B * kv_bytes_per_position(c) + 2 * B * state_bytes(c)
              + FP32 * B * V)
    return ops, nbytes
