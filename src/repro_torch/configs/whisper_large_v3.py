"""Whisper-large-v3-class audio enc-dec backbone; conv frontend stubbed to
precomputed frame embeddings (1500 frames) [arXiv:2212.04356]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab_size=51866,
    n_encoder_layers=32, encoder_seq=1500,
)
