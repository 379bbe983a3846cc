"""The port's dense decoder (``repro_torch.models.transformer``) for a
configuration file of the dense family."""
from __future__ import annotations

MODULE = "repro_torch.models.transformer"


def config(c: dict):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(
        name=c["name"], family="dense", n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], head_dim=c.get("head_dim"),
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        rope_theta=float(c["rope_theta"]), norm_eps=c["rms_norm_eps"],
        tie_embeddings=c["tie_word_embeddings"],
        sliding_window=c.get("sliding_window"),
        param_dtype=c["torch_dtype"], activation_dtype=c["torch_dtype"])
