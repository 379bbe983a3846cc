"""The port's hybrid (``repro_torch.models.hybrid``, its ``"zamba2"``
shared-block form) for a configuration file of the hybrid family."""
from __future__ import annotations

MODULE = "repro_torch.models.hybrid"


def config(c: dict):
    from repro_torch.configs.base import PortConfig
    D = c["hidden_size"]
    if c["mamba_expand"] * D != c["n_mamba_heads"] * c["mamba_headdim"]:
        raise ValueError("n_mamba_heads * mamba_headdim must be the inner "
                         "width mamba_expand * hidden_size")
    return PortConfig(
        name=c["name"], family="hybrid", n_layers=c["num_hidden_layers"],
        d_model=D, n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"],
        head_dim=c["attention_head_dim"], d_ff=c["intermediate_size"],
        vocab_size=c["vocab_size"], rope_theta=float(c["rope_theta"]),
        norm_eps=c["rms_norm_eps"], tie_embeddings=True,
        ssm_state=c["mamba_d_state"], ssm_conv=c["mamba_d_conv"],
        ssm_expand=c["mamba_expand"], mamba_version=2,
        ssm_head_dim=c["mamba_headdim"], mamba_ngroups=c["mamba_ngroups"],
        hidden_act=c["hidden_act"], shared_block="zamba2",
        num_mem_blocks=c["num_mem_blocks"],
        adapter_rank=c["adapter_rank"],
        hybrid_layer_ids=tuple(c["hybrid_layer_ids"]),
        param_dtype=c["torch_dtype"], activation_dtype=c["torch_dtype"])
