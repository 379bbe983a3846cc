"""Kimi-K2-class trillion-parameter MoE: 384 experts top-8 + 1 shared expert,
first layer dense [arXiv:2501.kimi2]. ~1.03T total / ~32B active params.
int8 blockwise optimizer state by default (HBM budget, EXPERIMENTS §Dry-run)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163840,
    n_experts=384, top_k=8, n_shared_experts=1, moe_d_ff=2048,
    first_dense_layers=1, rope_theta=5e4,
    opt_state_dtype="int8",
    fsdp_over_pod=True,
    grad_accum_dtype="bfloat16",
)
