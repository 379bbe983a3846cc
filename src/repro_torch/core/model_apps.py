"""Model-derived application profiles — the repo scheduling itself.

Every prior stream scheduled the paper's 12 simulated kernels. This module
derives first-class :class:`~repro_torch.core.simulator.AppProfile`\\ s from the
repo's *own* models and kernels, so the whole pipeline (profile → predict
(P, T) ladders → deadline-aware schedule) runs on the workloads the rest of
the codebase actually implements:

* one app per (architecture, phase): ``<arch>:prefill``, ``<arch>:decode``
  and ``<arch>:train_step`` for every registered config, with
  ``flops``/``hbm_bytes``/``coll_bytes`` taken from the
  :mod:`repro_torch.roofline.analysis` analytic counters (``model_flops``
  — 6·N·D train / 2·N·D forward — plus ``ssm_scan_correction``).
  ``derive_counters(..., compiled=)`` takes a dry-run trace record
  (:mod:`repro_torch.launch.dryrun`) where the reference takes an XLA AOT
  artifact, and behaves as the reference's does: its refinement never
  applies (see :func:`aot_counters`), so the counters are the analytic
  terms either way;
* standalone kernel apps for the repo's kernels themselves
  (``flash_attention`` / ``mamba_scan`` / ``moe_dispatch``);
* kind-specific **latent knobs** so the simulator's nonlinearities stay
  meaningful: decode is memory-bound *and* stall-prone (autoregressive
  dependency chains gain little from core clock), MoE architectures are
  spiky (capacity-overflow resonances), train steps are collective-heavy
  (gradient all-reduce) — see :data:`KIND_KNOBS`.

Per-chip magnitudes are normalized into the paper suite's band by sharding:
:func:`chips_for` picks the smallest power-of-two ``n_chips`` that brings a
phase's total counters under per-chip caps, so simulated times land in the
same seconds-scale regime the predictors and deadline generators were built
around.

Derivation is **pure and deterministic** — no RNG is consumed anywhere, so
two calls to :func:`model_app_suite` return bit-identical profiles, and
:func:`register_model_apps` profiles each app with its own dedicated
generator: registering the suite never perturbs a shared RNG stream, cache
epoch, or fitted predictor (invariant 12: registration is observationally
inert).

The apps are the scheduler's data model: their counters size jobs for the
simulated device classes (v5e, v5p, v5lite), as in the reference, not for
the card the port runs on. Host numpy and plain Python; the device work of
a derived app is its (P, T) table, built by the prediction service.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..configs import _ARCH_IDS, get_config
from ..configs.base import ModelConfig, ShapeSpec
from ..roofline.analysis import costs_of, model_flops, ssm_scan_correction

from .features import profile_features
from .simulator import AppProfile, Testbed

__all__ = [
    "PHASES", "KIND_KNOBS", "DECODE_STEPS",
    "PREFILL_SHAPE", "DECODE_SHAPE", "TRAIN_SHAPE",
    "phase_shape", "chips_for", "derive_counters", "derive_app",
    "model_app_suite", "kernel_apps", "register_model_apps",
]

#: Scheduler-facing phases derived per architecture, in registry order.
PHASES: tuple[str, ...] = ("prefill", "decode", "train_step")

#: One decode *app* is a 64-token autoregressive generation segment (a
#: serving quantum), not a single forward step — single steps are
#: milliseconds, far below the launch overhead the simulator models.
DECODE_STEPS: int = 64

#: Serving/training shapes the derivation evaluates the analytic counters
#: at. Deliberately smaller than the dry-run ``SHAPES`` grid: these are the
#: per-dispatch work quanta a scheduler sees, not offline compilation cells.
PREFILL_SHAPE = ShapeSpec("serve_prefill", 4_096, 8, "prefill")
DECODE_SHAPE = ShapeSpec("serve_decode", 2_048, 32, "decode")
TRAIN_SHAPE = ShapeSpec("serve_train", 4_096, 64, "train")

#: Per-chip magnitude caps (paper-suite band): the smallest power-of-two
#: ``n_chips`` bringing a phase's total counters under these is the app's
#: slice size, so per-chip times stay seconds-scale on every DeviceClass.
_FLOP_CAP = 3.0e14
_BYTE_CAP = 1.2e12

_DTYPE_BYTES = {"float32": 4.0, "bfloat16": 2.0, "float16": 2.0}

#: kind → latent-knob table (the derivation's nonlinearity contract):
#:
#: ========== =========== ============ ============= ====== ========
#: kind       stall_frac  wiggle_time  wiggle_power  spike  overhead
#: ========== =========== ============ ============= ====== ========
#: prefill    0.05        0.04         0.03          0.0    0.05 s
#: decode     0.35        0.05         0.04          0.0    0.08 s
#: train      0.12        0.04         0.05          0.0    0.10 s
#: ========== =========== ============ ============= ====== ========
#:
#: MoE-family architectures additionally carry ``spike`` =
#: :data:`_MOE_SPIKE` in every phase (expert-capacity resonances — the
#: lavaMD-style erratic response of Fig. 1).
KIND_KNOBS: dict[str, dict[str, float]] = {
    "prefill": dict(stall_frac=0.05, wiggle_time=0.04, wiggle_power=0.03,
                    spike=0.0, core_eff=0.90, mem_eff=0.88, overhead_s=0.05),
    "decode": dict(stall_frac=0.35, wiggle_time=0.05, wiggle_power=0.04,
                   spike=0.0, core_eff=0.85, mem_eff=0.90, overhead_s=0.08),
    "train": dict(stall_frac=0.12, wiggle_time=0.04, wiggle_power=0.05,
                  spike=0.0, core_eff=0.88, mem_eff=0.86, overhead_s=0.10),
}
_MOE_SPIKE = 0.18

#: Seed block for derived apps: disjoint from the paper suite (101–112)
#: and from every test's novel-app block (700+). Deterministic function of
#: (arch index, phase index) — no RNG anywhere in derivation.
_SEED_BASE = 200


def phase_shape(phase: str) -> ShapeSpec:
    """The :class:`ShapeSpec` a phase's counters are evaluated at."""
    return {"prefill": PREFILL_SHAPE, "decode": DECODE_SHAPE,
            "train_step": TRAIN_SHAPE}[phase]


def _dtype_bytes(dtype: str) -> float:
    return _DTYPE_BYTES.get(dtype, 2.0)


def _attn_layer_count(cfg: ModelConfig) -> int:
    """How many layers carry a KV cache (attention layers)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        if cfg.hybrid_attn_period:
            return max(cfg.n_layers // cfg.hybrid_attn_period, 1)
        return 0
    return cfg.n_layers


def _kv_bytes_per_token(cfg: ModelConfig) -> float:
    """KV-cache bytes one token contributes across all attention layers."""
    b = _dtype_bytes(cfg.activation_dtype)
    return (2.0 * cfg.n_kv_heads * cfg.resolved_head_dim * b
            * _attn_layer_count(cfg))


def _ssm_state_bytes(cfg: ModelConfig, batch: int) -> float:
    """Recurrent-state traffic of one decode step (read + write)."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0.0
    return 2.0 * batch * cfg.d_inner * cfg.ssm_state * 4.0 * cfg.n_layers


def _total_counters(cfg: ModelConfig, phase: str) -> tuple[float, float,
                                                           float]:
    """Unsharded (flops, hbm_bytes, coll_bytes) for one dispatch of
    ``phase`` — the :mod:`repro_torch.roofline.analysis` analytic terms plus an
    explicit HBM-traffic model (weights, activations, KV cache, recurrent
    state, gradient streams). Divide by ``n_chips`` for per-chip values."""
    shape = phase_shape(phase)
    wb = _dtype_bytes(cfg.param_dtype)
    ab = _dtype_bytes(cfg.activation_dtype)
    active_w = cfg.active_param_count() * wb
    flops = model_flops(cfg, shape, 1)
    extra_f, extra_b = ssm_scan_correction(cfg, shape, 1)
    flops += extra_f
    if phase == "decode":
        # per step: stream the active weights once + read the KV cache of
        # the full context (+ recurrent state for SSM/hybrid); one decode
        # app is a DECODE_STEPS-token generation segment
        kv_read = (shape.global_batch * shape.seq_len
                   * _kv_bytes_per_token(cfg))
        step_bytes = active_w + kv_read + _ssm_state_bytes(
            cfg, shape.global_batch)
        return flops * DECODE_STEPS, step_bytes * DECODE_STEPS, 0.0
    tokens = shape.seq_len * shape.global_batch
    act_traffic = tokens * cfg.d_model * ab * cfg.n_layers
    kv_write = tokens * _kv_bytes_per_token(cfg)
    if phase == "prefill":
        # weights once, activations through every layer (~8 touches:
        # residual reads/writes + projections), KV cache written once
        return flops, active_w + 8.0 * act_traffic + kv_write + extra_b, 0.0
    # train_step: full parameter set streamed 3x (fwd weights, bwd
    # weights, grad write — MoE optimizers touch every expert), remat'd
    # activations (~12 touches: forward store + backward reread)
    full_w = cfg.param_count() * wb
    hbm = 3.0 * full_w + 12.0 * act_traffic + extra_b
    # gradient ring all-reduce over the data-parallel group; per-chip
    # bytes are scaled by (n-1)/n in derive_counters once n_chips is known
    coll = 2.0 * active_w
    return flops, hbm, coll


def chips_for(cfg: ModelConfig, phase: str) -> int:
    """Smallest power-of-two slice bringing per-chip counters under the
    paper-suite band caps (``3e14`` FLOPs / ``1.2e12`` HBM bytes)."""
    flops, hbm, _ = _total_counters(cfg, phase)
    need = max(flops / _FLOP_CAP, hbm / _BYTE_CAP, 1.0)
    return int(2 ** int(np.ceil(np.log2(need))))


def derive_counters(cfg: ModelConfig, phase: str,
                    n_chips: Optional[int] = None,
                    compiled=None) -> dict[str, float]:
    """Per-chip ``{flops, hbm_bytes, coll_bytes, n_chips}`` for one
    (config, phase) app. ``compiled`` optionally refines flops/bytes from
    a dry-run trace record (:func:`aot_counters`); the analytic terms are
    the fallback."""
    n = chips_for(cfg, phase) if n_chips is None else int(n_chips)
    flops, hbm, coll = _total_counters(cfg, phase)
    flops, hbm = flops / n, hbm / n
    if compiled is not None:
        refined = aot_counters(compiled, n_chips=n)
        if refined is not None:
            flops, hbm = refined
    coll_chip = coll * (n - 1) / n if n > 1 else 0.0
    return {"flops": flops, "hbm_bytes": hbm, "coll_bytes": coll_chip,
            "n_chips": n}


def aot_counters(compiled, n_chips: int = 1
                 ) -> Optional[tuple[float, float]]:
    """Optional refinement: per-chip (flops, bytes) from a dry-run trace
    record's costs (:func:`repro_torch.roofline.analysis.costs_of`).
    Returns ``None`` whenever the record carries no usable cost data —
    callers fall back to the analytic terms.

    A reference quirk kept for parity: the reference reads the bytes
    under the key ``"bytes accessed"``, but ``costs_of`` returns them
    under ``"bytes"``, so the bytes read as 0 and the refinement never
    applies. The port reads the same key and returns ``None`` alike."""
    try:
        c = costs_of(compiled)
        flops = float(c.get("flops", 0.0) or 0.0)
        nbytes = float(c.get("bytes accessed", 0.0) or 0.0)
    except Exception:
        return None
    if flops <= 0.0 or nbytes <= 0.0:
        return None
    return flops / n_chips, nbytes / n_chips


def _knobs(cfg: ModelConfig, phase: str) -> dict[str, float]:
    kind = "train" if phase == "train_step" else phase
    knobs = dict(KIND_KNOBS[kind])
    if cfg.family == "moe":
        knobs["spike"] = _MOE_SPIKE
    return knobs


def derive_app(arch: str, phase: str, compiled=None) -> AppProfile:
    """One deterministic ``<arch>:<phase>`` profile. Same inputs →
    bit-identical dataclass (no RNG is consumed). ``compiled``: an
    optional dry-run trace record (see :func:`derive_counters`)."""
    if phase not in PHASES:
        raise KeyError(f"unknown phase {phase!r}; known: {PHASES}")
    key = arch.replace(".", "_").replace("-", "_")
    cfg = get_config(key)
    counters = derive_counters(cfg, phase, compiled=compiled)
    kind = "train" if phase == "train_step" else phase
    seed = (_SEED_BASE + 7 * _ARCH_IDS.index(key)
            + PHASES.index(phase))
    return AppProfile(
        name=f"{key}:{phase}", kind=kind, seed=seed,
        flops=counters["flops"], hbm_bytes=counters["hbm_bytes"],
        coll_bytes=counters["coll_bytes"], n_chips=counters["n_chips"],
        **_knobs(cfg, phase))


def kernel_apps() -> tuple[AppProfile, ...]:
    """Standalone apps for the repo's kernels themselves, with
    analytic counters at fixed microbench shapes (flash attention:
    B=8 H=32 S=16384 D=128; mamba scan: B=32 L=65536 Di=4096 N=16;
    MoE dispatch: 256k tokens, 64 experts, top-2, d=4096)."""
    # flash attention: 4·B·H·S²·D FLOPs, Q/K/V/O streamed once (bf16)
    B, H, S, D = 8, 32, 16_384, 128
    fa_flops = 4.0 * B * H * S * S * D
    fa_bytes = 4.0 * B * H * S * D * 2.0
    fa = AppProfile(
        name="flash_attention", kind="kernel", seed=_SEED_BASE + 81,
        flops=fa_flops, hbm_bytes=fa_bytes,
        stall_frac=0.05, wiggle_time=0.03, wiggle_power=0.03,
        core_eff=0.93, mem_eff=0.88, overhead_s=0.04)
    # mamba scan (mamba1): 7·B·L·Di·N FLOPs, (3·Di+2·N)·4 B per token —
    # the chunked-recurrence kernel is memory-bound and stall-prone
    Bm, L, Di, N = 32, 65_536, 4_096, 16
    ms = AppProfile(
        name="mamba_scan", kind="kernel", seed=_SEED_BASE + 82,
        flops=7.0 * Bm * L * Di * N,
        hbm_bytes=float(Bm * L * (3 * Di + 2 * N) * 4.0),
        stall_frac=0.40, wiggle_time=0.04, wiggle_power=0.03,
        core_eff=0.80, mem_eff=0.90, overhead_s=0.05)
    # MoE dispatch: router matmul + permute/combine streams + an
    # all-to-all leg; capacity-overflow resonances make it spiky
    T, E, dm, topk, n = 262_144, 64, 4_096, 2, 8
    md = AppProfile(
        name="moe_dispatch", kind="kernel", seed=_SEED_BASE + 83,
        flops=2.0 * T * E * dm,
        hbm_bytes=float(T * topk * dm * 2.0 * 4.0),
        coll_bytes=T * topk * dm * 2.0 * (n - 1) / n / n,
        n_chips=n, spike=0.30, stall_frac=0.10,
        wiggle_time=0.05, wiggle_power=0.04,
        core_eff=0.88, mem_eff=0.85, overhead_s=0.05)
    return fa, ms, md


def model_app_suite(archs: Optional[Sequence[str]] = None,
                    phases: Sequence[str] = PHASES,
                    include_kernels: bool = True) -> tuple[AppProfile, ...]:
    """The full derived suite: every (arch, phase) app in registry order,
    plus the standalone kernel apps. Deterministic — repeated calls
    return bit-identical profiles."""
    archs = _ARCH_IDS if archs is None else tuple(
        a.replace(".", "_").replace("-", "_") for a in archs)
    apps = [derive_app(a, p) for a in archs for p in phases]
    if include_kernels:
        apps.extend(kernel_apps())
    return tuple(apps)


def register_model_apps(service, testbed: Testbed,
                        apps: Optional[Sequence[AppProfile]] = None,
                        base_seed: int = 9_000) -> dict[str, np.ndarray]:
    """Profile the derived suite and insert the feature vectors into
    ``service.app_features`` — the same profiling path every paper app
    took, so :class:`~repro_torch.core.prediction_service.PredictionService`,
    the cold-start synthesizer, and all six policies serve derived apps
    unchanged.

    **Observationally inert** (invariant 12): each profiling run draws
    from its *own* ``default_rng(base_seed + app.seed)`` — the testbed's
    shared stream, every cached table, the cache epoch, and the fitted
    predictor are untouched, so a paper-suite-only schedule is
    bit-identical with or without the registration. Returns the inserted
    ``{name: feature-vector}`` mapping."""
    apps = model_app_suite() if apps is None else tuple(apps)
    feats = {
        app.name: profile_features(
            app, testbed, rng=np.random.default_rng(base_seed + app.seed))
        for app in apps
    }
    if service is not None:
        if service.app_features is None:
            raise ValueError("service has no app_features dict to extend")
        for name, vec in feats.items():
            service.app_features.setdefault(name, vec)
    return feats
