"""Model configuration schema shared by all assigned architectures.

A copy of the reference's schema, field for field, so that a reference
config carries over to the port as ``ModelConfig(**dataclasses.asdict(c))``.
The training path reads ``remat`` (``"full"`` rematerialises each layer
body, :func:`repro_torch.models.common.layer_call`), ``grad_accum_dtype``
(the microbatch gradient accumulator of
:func:`repro_torch.train.step.make_train_step`) and ``attn_impl`` (a config
asking for ``"flash"`` cannot train). The dry run
(:mod:`repro_torch.launch.dryrun`) reads ``opt_state_dtype`` (the AdamW
state it lays out) and ``fsdp_over_pod`` (FSDP over ``('data', 'pod')``);
``scan_layers`` is carried for parity only: the port runs its layers in a
Python loop, and the dry run's depth plan sets it False, as the
reference's does."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

#: the fields the port adds for Zamba2-7B at its published widths
PORT_FIELDS = ("hidden_act", "mamba_ngroups", "shared_block",
               "num_mem_blocks", "adapter_rank", "hybrid_layer_ids")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None           # default d_model // n_heads
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    qkv_bias: bool = False                   # Qwen2.5
    tie_embeddings: bool = False             # SmolLM
    sliding_window: Optional[int] = None     # Mixtral SWA
    # --- MoE ---------------------------------------------------------- #
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    n_shared_experts: int = 0                # Kimi-K2 shared expert
    moe_d_ff: int = 0                        # per-expert hidden (0 → d_ff)
    first_dense_layers: int = 0              # Kimi: layer 0 dense
    # --- SSM (Mamba) ---------------------------------------------------- #
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    mamba_version: int = 1                   # 1: falcon-mamba, 2: zamba2
    ssm_head_dim: int = 64                   # mamba2
    # --- hybrid (Zamba2): shared attention block every k mamba blocks -- #
    hybrid_attn_period: int = 0
    # --- encoder-decoder (Whisper) -------------------------------------- #
    n_encoder_layers: int = 0
    encoder_seq: int = 0                     # stub frame count (1500)
    # --- VLM (InternVL2): stub patch embeddings -------------------------- #
    vision_tokens: int = 0
    # --- numerics / execution ------------------------------------------- #
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    remat: str = "full"                      # none | full
    # the reference's route switch. The port's serving always takes the
    # kernels (ops.flash_attention, ops.mamba_scan), as the reference's
    # "flash" does; its train step always takes the differentiable "xla"
    # route and refuses a config that asks for "flash"
    attn_impl: str = "xla"
    scan_layers: bool = True
    # optimizer-state dtype: "float32" or "int8" (blockwise, for 1T-scale)
    opt_state_dtype: str = "float32"
    # shard the FSDP dim over ('data','pod') instead of 'data' alone —
    # ZeRO-3 across DCN; needed to fit 1T-param training on 2 pods
    fsdp_over_pod: bool = False
    # microbatch gradient-accumulator dtype (bf16 halves the largest
    # training buffer at 1T scale; error ~2^-8 per add, n_microbatch small)
    grad_accum_dtype: str = "float32"
    # The port's own settings (Zamba2-7B at its published widths): class
    # attributes, not fields, so that a reference config carries over
    # field for field; :class:`PortConfig` makes them fields. At these
    # values every family computes what it computed without them.
    hidden_act = "silu"                      # gated MLP: silu | gelu (erf)
    mamba_ngroups = 1                        # Mamba-2 B/C groups (Zamba2: 2)
    # the shared block's form: "residual" (the reference's: x + attn,
    # x + mlp, over the hidden state, after every period) or "zamba2"
    # (Zamba2's: over concat(h, embedding), no residual, a LoRA and a
    # linear each application, added to the input of the Mamba-2 mixer of
    # layer ``hybrid_layer_ids[a]``; scores scaled by (hd/2)^-1/2). The
    # three after it are for the "zamba2" form alone
    shared_block = "residual"
    num_mem_blocks = 1                       # shared blocks, taken in turn
    adapter_rank = 0                         # LoRA rank on the MLP's gate_up
    hybrid_layer_ids = ()                    # the layers applications feed

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def resolved_moe_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def query_scale(self) -> float:
        """q's factor before attention's ``1/sqrt(hd)``: sqrt(2) in
        Zamba2's shared block, whose scores are scaled by ``(hd/2)^-1/2``;
        else 1 (nothing multiplied)."""
        return math.sqrt(2.0) if self.shared_block == "zamba2" else 1.0

    def port_fields_set(self) -> list:
        """The names of :data:`PORT_FIELDS` set away from their defaults."""
        return [n for n in PORT_FIELDS
                if getattr(self, n) != getattr(ModelConfig, n)]

    # ------------------------------------------------------------------ #
    def param_count(self) -> int:
        """Analytic parameter count (drives MODEL_FLOPS and memory checks)."""
        D, V = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        n = V * D  # embedding
        if not self.tie_embeddings:
            n += V * D
        att = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd \
            + self.n_heads * hd * D
        mlp_dense = 3 * D * self.d_ff
        if self.family in ("dense", "vlm"):
            n += self.n_layers * (att + mlp_dense + 2 * D)
        elif self.family == "moe":
            F = self.resolved_moe_d_ff
            moe = self.n_experts * 3 * D * F + D * self.n_experts \
                + self.n_shared_experts * 3 * D * F
            dense_l = self.first_dense_layers
            n += dense_l * (att + mlp_dense + 2 * D)
            n += (self.n_layers - dense_l) * (att + moe + 2 * D)
        elif self.family == "ssm":
            Di, N = self.d_inner, self.ssm_state
            dt_rank = max(D // 16, 1)
            blk = D * 2 * Di + Di * self.ssm_conv + Di * (dt_rank + 2 * N) \
                + dt_rank * Di + Di * N + Di + Di * D + D
            n += self.n_layers * blk
        elif self.family == "hybrid" and self.port_fields_set():
            n += self._zamba2_params()
        elif self.family == "hybrid":
            Di, N = self.d_inner, self.ssm_state
            H = max(Di // self.ssm_head_dim, 1)
            blk = D * 2 * Di + Di * self.ssm_conv + Di * N * 2 + 2 * H \
                + Di * D + 2 * D
            n += self.n_layers * blk
            if self.hybrid_attn_period:
                n += att + mlp_dense + 2 * D  # one shared block
        elif self.family == "audio":
            enc_blk = att + mlp_dense + 2 * D
            dec_blk = att * 2 + mlp_dense + 3 * D  # self + cross attn
            n += self.n_encoder_layers * enc_blk + self.n_layers * dec_blk
        n += D  # final norm
        return n

    def _zamba2_params(self) -> int:
        """Every parameter of a hybrid with the port's fields set, as
        :mod:`repro_torch.models.hybrid` lays them out: each layer's norm
        and Mamba-2 mixer (in_proj to z, x, B, C of each group and dt;
        the conv over x, B, C with its bias; A_log, dt_bias, D a head;
        the gated norm; out_proj), then with the "zamba2" form each
        shared block (attention over the 2D-wide concat with its norm, the
        MLP's norm, the gated MLP) and each application's LoRA and
        linear, else the one residual block after every period."""
        D, F, hd = self.d_model, self.d_ff, self.resolved_head_dim
        Di, N, K = self.d_inner, self.ssm_state, self.ssm_conv
        H = Di // self.ssm_head_dim
        conv = Di + 2 * self.mamba_ngroups * N
        blk = D * (Di + conv + H) + conv * (K + 1) + 3 * H + Di + Di * D \
            + D
        n = self.n_layers * blk
        if self.shared_block == "zamba2":
            Din = 2 * D
            att = Din * (self.n_heads + 2 * self.n_kv_heads) * hd \
                + self.n_heads * hd * D
            n += self.num_mem_blocks * (att + 3 * D * F + Din + D)
            n += len(self.hybrid_layer_ids) * (
                D * self.adapter_rank + self.adapter_rank * 2 * F + D * D)
        elif self.hybrid_attn_period:
            att = D * (self.n_heads + 2 * self.n_kv_heads) * hd \
                + self.n_heads * hd * D
            n += att + 3 * D * F + 2 * D
        return n

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: top-k + shared experts only)."""
        if self.family != "moe":
            return self.param_count()
        F = self.resolved_moe_d_ff
        full_moe = self.n_experts * 3 * self.d_model * F
        active_moe = (self.top_k + self.n_shared_experts) * 3 * self.d_model * F
        n_moe_layers = self.n_layers - self.first_dense_layers
        return self.param_count() - n_moe_layers * (full_moe - active_moe)


@dataclasses.dataclass(frozen=True)
class PortConfig(ModelConfig):
    """A :class:`ModelConfig` whose port settings (:data:`PORT_FIELDS`,
    Zamba2-7B's form) are fields: set them here, or with
    :func:`with_port_fields` on a config of the registry."""
    hidden_act: str = "silu"
    mamba_ngroups: int = 1
    shared_block: str = "residual"
    num_mem_blocks: int = 1
    adapter_rank: int = 0
    hybrid_layer_ids: tuple = ()


def with_port_fields(cfg: ModelConfig, **fields) -> PortConfig:
    """``cfg`` as a :class:`PortConfig`, with ``fields`` set."""
    keep = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    return PortConfig(**{**keep, **fields})


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    kv = min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0
    heads = 4 if cfg.n_heads else 0
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, 4),
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16 if cfg.n_heads else None,
        d_ff=128,
        vocab_size=256,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        capacity_factor=4.0,  # no capacity drops at smoke scale (tested
                              # separately) so full-seq == prefill+decode
        moe_d_ff=64 if cfg.n_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        first_dense_layers=min(cfg.first_dense_layers, 1),
        ssm_state=min(cfg.ssm_state, 8),
        ssm_expand=2,
        ssm_head_dim=16,
        hybrid_attn_period=2 if cfg.hybrid_attn_period else 0,
        n_encoder_layers=min(cfg.n_encoder_layers, 2),
        encoder_seq=16 if cfg.encoder_seq else 0,
        vision_tokens=8 if cfg.vision_tokens else 0,
        sliding_window=8 if cfg.sliding_window else None,
        param_dtype="float32",
        activation_dtype="float32",
        remat="none",
    )


# ---------------------------------------------------------------------- #
#  Input shapes assigned to every LM-family architecture
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch, shape) is a valid dry-run cell (DESIGN.md §5)."""
    if shape.name == "long_500k":
        sub_quadratic = (
            cfg.family in ("ssm", "hybrid")
            or cfg.sliding_window is not None
        )
        if not sub_quadratic:
            return False, "full quadratic attention — long_500k skipped"
    return True, ""
