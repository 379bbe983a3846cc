"""The port's attention-free Mamba-1 LM (``repro_torch.models.ssm_lm``)
for a configuration file of the ssm family (FalconMamba): its weightless
mixer norms (``mixer_rms_eps``) and its fp32 residual stream
(``residual_in_fp32``) as the port's fields."""
from __future__ import annotations

MODULE = "repro_torch.models.ssm_lm"


def config(c: dict):
    from repro_torch.configs.base import PortConfig
    D = c["hidden_size"]
    if c["intermediate_size"] % D:
        raise ValueError("intermediate_size must be a multiple of "
                         "hidden_size (the port's ssm_expand)")
    # the port derives dt's rank from the width (models/ssm.py _dt_rank)
    if c["time_step_rank"] != max(D // 16, 1):
        raise ValueError(f"time_step_rank {c['time_step_rank']} is not the "
                         f"port's hidden_size // 16 = {max(D // 16, 1)}")
    if c["use_bias"] or not c["use_conv_bias"] or c["hidden_act"] != "silu":
        raise ValueError("the port's Mamba-1 mixer is silu-gated, with a "
                         "conv bias and no other bias")
    return PortConfig(
        name=c["name"], family="ssm", n_layers=c["num_hidden_layers"],
        d_model=D, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab_size=c["vocab_size"], norm_eps=c["layer_norm_epsilon"],
        tie_embeddings=c["tie_word_embeddings"], ssm_state=c["state_size"],
        ssm_conv=c["conv_kernel"], ssm_expand=c["intermediate_size"] // D,
        mamba_version=1, mixer_rms_eps=c["mixer_rms_eps"],
        residual_in_fp32=c["residual_in_fp32"],
        param_dtype=c["torch_dtype"], activation_dtype=c["torch_dtype"])
