"""Zamba2-7B-class hybrid: 81 Mamba2 blocks + shared attention block every 6
[arXiv:2411.15242]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, mamba_version=2,
    hybrid_attn_period=6,
)
