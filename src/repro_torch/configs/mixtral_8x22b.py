"""Mixtral-8x22B: 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088]. SWA makes long_500k sub-quadratic (windowed KV)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=32768,
    n_experts=8, top_k=2, sliding_window=4096, rope_theta=1e6,
)
