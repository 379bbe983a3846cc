"""Analytic model costs: the closed-form half of the reference's roofline
analysis.

:func:`model_flops` counts a model's FLOPs per device from its active
parameters (6·N·D train, 2·N·D prefill, 2·N per decode token), and
:func:`ssm_scan_correction` adds the sequence recurrence of SSM layers,
modelled at the chunked scan kernel's cost. :mod:`repro_torch.core.
model_apps` derives the scheduler's model apps from them. Plain Python over
a :class:`~repro_torch.configs.base.ModelConfig` and a
:class:`~repro_torch.configs.base.ShapeSpec`; no device work.

The reference's compiled-artifact half (HLO collective parsing, cost
extrapolation, the TPU v5e roofline constants) comes with distribution and
the dry run (ROADMAP §1.14).
"""
from __future__ import annotations

__all__ = ["ssm_scan_correction", "model_flops"]


def ssm_scan_correction(cfg, shape, n_chips: int) -> tuple[float, float]:
    """(extra_flops, extra_bytes) per device for the sequence recurrence
    that a compiler's cost model counts once (the scan body): modeled at
    the *chunked scan kernel*'s cost — state resident on chip, inputs
    streamed once.

    mamba1 per token per layer: dA exp + dBu + h-update + y=h·C ≈ 7·Di·N
    FLOPs; stream u,dt (fp32) + B,C + y ≈ (3·Di + 2·N)·4 bytes.
    mamba2: ≈ 6·Di·N FLOPs (scalar-A heads), same streaming shape.
    Sharding: Di over TP(16), tokens over DP — ≈ /n_chips overall.
    """
    if cfg.family not in ("ssm", "hybrid") or shape.mode == "decode":
        return 0.0, 0.0
    tokens = shape.seq_len * shape.global_batch
    Di, N = cfg.d_inner, cfg.ssm_state
    c = 7.0 if cfg.mamba_version == 1 else 6.0
    flops_tok_layer = c * Di * N
    bytes_tok_layer = (3 * Di + 2 * N) * 4.0
    mult = 3.0 if shape.mode == "train" else 1.0  # bwd ≈ 2x fwd re-scan
    total_flops = cfg.n_layers * tokens * flops_tok_layer * mult
    total_bytes = cfg.n_layers * tokens * bytes_tok_layer * mult
    return total_flops / n_chips, total_bytes / n_chips


def model_flops(cfg, shape, n_chips: int) -> float:
    """Analytic MODEL_FLOPS: 6·N·D train (N = active params), 2·N·D forward
    (prefill), 2·N per token (decode) — per device.

    Encoder-decoder (audio): the encoder's params see `encoder_seq` frames
    per sample, not the decoder's token count — counted separately."""
    n_active = cfg.active_param_count()
    mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[shape.mode]
    if cfg.family == "audio":
        D = cfg.d_model
        att = (D * cfg.n_heads * cfg.resolved_head_dim
               + 2 * D * cfg.n_kv_heads * cfg.resolved_head_dim
               + cfg.n_heads * cfg.resolved_head_dim * D)
        enc_params = cfg.n_encoder_layers * (att + 3 * D * cfg.d_ff + 2 * D)
        dec_params = n_active - enc_params
        if shape.mode == "decode":
            dec_tokens = shape.global_batch
            enc_tokens = 0  # encoder output precomputed in the cache
        else:
            dec_tokens = shape.seq_len * shape.global_batch
            enc_tokens = cfg.encoder_seq * shape.global_batch
        total = mult * (dec_params * dec_tokens + enc_params * enc_tokens)
        return total / n_chips
    if shape.mode == "decode":
        tokens = shape.global_batch
    else:
        tokens = shape.seq_len * shape.global_batch
    return mult * n_active * tokens / n_chips
