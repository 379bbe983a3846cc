"""InternVL2-76B-class VLM: InternLM2-76B backbone + stub ViT patch
embeddings (256 tokens/image) [arXiv:2404.16821]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab_size=128256, vision_tokens=256, rope_theta=1e6,
)
