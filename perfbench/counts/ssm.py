"""Counts of FalconMamba (an attention-free stack of Mamba-1 mixers) from
its configuration file's keys: a prefill of B prompts of S tokens, one
decode step of B sequences, and the Mamba-1 scan of one layer.

A prefill needs the prompt through every layer (each mixer's four
products and its scan), the conv and SSM state written, and the logits
of the last position; a decode step needs every weight once, each
layer's conv and SSM state read and written, and the logits. The
weights and the conv cache are bf16 as served, the SSM state, dt_bias,
A_log and D fp32, the logits fp32; the LM head is its own (D, V) matrix,
read once. Norms (the block's and the mixer's three), the conv, the
softplus, the gate and the fp32 residual's adds are left out of the
operations (a few per element, against thousands per element in the
products)."""
from __future__ import annotations

BF16, FP32 = 2, 4


def dims(c: dict) -> dict:
    return {"D": c["hidden_size"], "L": c["num_hidden_layers"],
            "Di": c["intermediate_size"], "N": c["state_size"],
            "K": c["conv_kernel"], "R": c["time_step_rank"],
            "V": c["vocab_size"]}


def mamba_matmul_params(c: dict) -> int:
    """Weights of one mixer's products: in_proj, x_proj, dt_proj,
    out_proj."""
    d = dims(c)
    D, Di, N, R = d["D"], d["Di"], d["N"], d["R"]
    return D * 2 * Di + Di * (R + 2 * N) + R * Di + Di * D


def weight_bytes(c: dict) -> int:
    """Every weight once: each layer's norm, products, conv and its bias
    in bf16, its dt_bias, A_log and D in fp32; the final norm, the token
    table and the LM head in bf16."""
    d = dims(c)
    D, L, Di, N, V = d["D"], d["L"], d["Di"], d["N"], d["V"]
    layer = D + mamba_matmul_params(c) + Di * (d["K"] + 1)
    return (BF16 * (L * layer + D + 2 * V * D)
            + FP32 * L * (2 * Di + Di * N))


def state_bytes(c: dict) -> int:
    """One sequence's conv state (bf16) and SSM state (fp32), every
    layer."""
    d = dims(c)
    return d["L"] * (BF16 * (d["K"] - 1) * d["Di"]
                     + FP32 * d["Di"] * d["N"])


def scan(B: int, L: int, Di: int, N: int) -> tuple[int, int]:
    """(operations, bytes) of one layer's Mamba-1 scan over B sequences of
    L steps, Di channels of N states each. Operations: the recurrence's
    two multiply-adds a state element and step, the input ``(dt x) B``
    into the state and the state into ``y`` through C, at two operations
    each. Mamba-1's decay, one exp a state element and step (Di N a
    step), is not priced: ``peaks.json`` has no rate for it. Bytes once
    at the served dtypes: x, dt and y (a channel each) and B and C bf16,
    the final state written fp32, A and D fp32."""
    ops = 2 * 2 * B * L * Di * N
    nbytes = (BF16 * (3 * B * L * Di + 2 * B * L * N)
              + FP32 * (B * Di * N + Di * N + Di))
    return ops, nbytes


def prefill(c: dict, B: int, S: int) -> tuple[int, int]:
    """(operations, bytes) of one prefill of B prompts of S tokens."""
    d = dims(c)
    D, L, V = d["D"], d["L"], d["V"]
    scan_ops, _ = scan(B, S, d["Di"], d["N"])
    ops = 2 * B * S * L * mamba_matmul_params(c) + L * scan_ops \
        + 2 * B * D * V
    nbytes = (weight_bytes(c) + BF16 * B * S * D + 4 * B * S
              + B * state_bytes(c) + FP32 * B * V)
    return ops, nbytes


def decode_step(c: dict, B: int, pos: int) -> tuple[int, int]:
    """(operations, bytes) of one decode step of B sequences (``pos``
    unused: the state's size is the context's whatever its length); each
    layer's state is read and written once."""
    del pos
    d = dims(c)
    D, L, V = d["D"], d["L"], d["V"]
    scan_ops, _ = scan(B, 1, d["Di"], d["N"])
    ops = 2 * B * (L * mamba_matmul_params(c) + D * V) + L * scan_ops
    nbytes = (weight_bytes(c) + BF16 * B * D + 4 * B
              + 2 * B * state_bytes(c) + FP32 * B * V)
    return ops, nbytes
