"""Counts of a dense GQA decoder (Mistral-NeMo-12B's family) from its
configuration file's keys: a prefill of B prompts of S tokens, and one
decode step of B sequences.

A prefill needs the prompt through every layer, the KV cache written, and
the logits of the last position (the first token); a decode step needs
every weight once, the cached positions attended, the new K and V
written, and the logits. The weights and the cache are bf16 as served,
the logits fp32. Norms, RoPE and the activation function are left out of
the operations (a few per element, against thousands per element in the
products)."""
from __future__ import annotations

from . import attention

BF16, FP32 = 2, 4


def dims(c: dict) -> dict:
    hq = c["num_attention_heads"]
    D = c["hidden_size"]
    return {"D": D, "L": c["num_hidden_layers"], "Hq": hq,
            "Hkv": c["num_key_value_heads"],
            "hd": c.get("head_dim") or D // hq,
            "F": c["intermediate_size"], "V": c["vocab_size"],
            "window": c.get("sliding_window")}


def layer_matmul_params(c: dict) -> int:
    """Weights of one layer's products: q, k, v, o and the SwiGLU MLP."""
    d = dims(c)
    D, Hq, Hkv, hd, F = d["D"], d["Hq"], d["Hkv"], d["hd"], d["F"]
    return D * Hq * hd + 2 * D * Hkv * hd + Hq * hd * D + 3 * D * F


def weight_bytes(c: dict) -> int:
    """Every weight but the token table (of which a step reads only its
    tokens' rows): the layers' products and norms, the final norm and the
    unembedding."""
    d = dims(c)
    D, L, V = d["D"], d["L"], d["V"]
    return BF16 * (L * (layer_matmul_params(c) + 2 * D) + D + D * V)


def kv_bytes_per_position(c: dict) -> int:
    d = dims(c)
    return BF16 * d["L"] * 2 * d["Hkv"] * d["hd"]


def prefill(c: dict, B: int, S: int) -> tuple[int, int]:
    """(operations, bytes) of one prefill of B prompts of S tokens."""
    d = dims(c)
    D, L, V = d["D"], d["L"], d["V"]
    attn_ops, _ = attention(B, S, S, d["Hq"], d["Hkv"], d["hd"], BF16,
                            window=d["window"])
    ops = (2 * B * S * L * layer_matmul_params(c) + L * attn_ops
           + 2 * B * D * V)
    nbytes = (weight_bytes(c) + BF16 * B * S * D + 4 * B * S
              + B * S * kv_bytes_per_position(c) + FP32 * B * V)
    return ops, nbytes


def decode_step(c: dict, B: int, pos: int) -> tuple[int, int]:
    """(operations, bytes) of one decode step of B sequences writing
    position ``pos``: the new token attends the ``pos + 1`` positions up
    to itself (within the window, if any)."""
    d = dims(c)
    D, L, V = d["D"], d["L"], d["V"]
    seen = pos + 1 if d["window"] is None else min(pos + 1, d["window"])
    attn_ops, _ = attention(B, 1, seen, d["Hq"], d["Hkv"], d["hd"], BF16,
                            window=d["window"])
    ops = 2 * B * (L * layer_matmul_params(c) + D * V) + L * attn_ops
    nbytes = (weight_bytes(c) + BF16 * B * D + 4 * B
              + B * (seen - 1) * kv_bytes_per_position(c)
              + B * kv_bytes_per_position(c) + FP32 * B * V)
    return ops, nbytes
