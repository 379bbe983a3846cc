"""Cold-start clock-ladder synthesis from static features (beyond paper).

The paper's pipeline assumes every application was profiled offline before
scheduling starts — an unseen app arriving mid-stream is inexpressible (it
has no feature vector, so :class:`~repro_torch.core.prediction_service.
PredictionService` can only raise). DSO (arXiv:2407.13096) shows static and
dynamic program information can be *fused* to predict energy-optimal
frequencies without a full profiling campaign, and the core/memory
frequency-scaling performance model of arXiv:1701.05308 gives the analytic
shape a synthesized ladder should follow. The static half is the counters
an :class:`~repro_torch.core.simulator.AppProfile` carries (``flops``,
``hbm_bytes``, ``coll_bytes``, ``overhead_s``, ``kind``, ``n_chips``),
which a compiled artifact's cost analysis gives before the app ever runs.

:class:`ColdStartSynthesizer` closes the gap in three steps:

1. **Static embedding.** From the app's static counters alone (never the
   latent dynamics — ``core_eff``/``stall_frac``/wiggles stay hidden,
   that is the whole premise) derive a 20-dim vector in the exact
   :data:`~repro_torch.core.features.FEATURE_NAMES` layout, substituting
   analytic roofline estimates for every measured entry: utilization from
   term ratios, default power from the electrical model at estimated
   utilizations, default time from the smooth-max roofline.
2. **Nearest-profiled mapping.** Embed the vector into the profiled
   corpus's cluster structure (reusing :class:`~repro_torch.core.correlate.
   CorrelationIndex` — k-means + in-cluster time proximity, the paper's
   §III-D machinery, its Lloyd sweep on the service's device) and *transfer* the neighbor's realized efficiency:
   the ratio of its measured default-clock execution time to its own
   analytic roofline (``κ_T``), and likewise for power (``κ_P``). The
   κ's absorb what static analysis cannot see (achievable efficiency,
   overlap, average nonlinearity) from the most similar profiled app.
3. **Ladder synthesis.** For any device class's ladder, the table is the
   smooth-max roofline interpolated across (core, mem) clock scales —
   compute-bound entries scale with ``s_core``, memory-bound with
   ``s_mem``, collectives with neither (arXiv:1701.05308's two-domain
   model, with the simulator's overlap exponent) — scaled by the
   transferred κ's:

       M(clock) = ((c/s_core)^8 + (m/s_mem)^8 + l^8)^(1/8)
       T(clock) = κ_T · M(clock) + overhead_s
       P(clock) = κ_P · dvfs.power(clock, û_core, û_mem)

   By construction T is finite, positive, and monotone non-increasing in
   core clock at fixed mem clock on every ladder.

The synthesizer is attached to a :class:`~repro_torch.core.prediction_service.
PredictionService` (``service.attach_synthesizer``) as a **table-source
tier** between the profiled base tables and the online corrector:

    profiled base (predictor)  →  synthesized cold-start (this module)
                               →  online-corrected (RLS or GBDT over either)

Because the corrector layers over :meth:`PredictionService.base_table`
unchanged, live completions refine synthesized tables exactly as they
refine profiled ones, and CUSUM drift handling needs no new code. The
service forwards every observation-driven invalidation here
(:meth:`note_invalidation`), which drives the promotion lifecycle: an app
starts ``"cold"`` and is promoted to ``"warmed"`` once ``warm_after``
observations have accrued — at which point its served table is dominated
by measured corrections, not the static prior.

With zero unseen apps an attached synthesizer performs dictionary lookups
only — the engine's output is bit-identical to the synthesizer-free path.

Everything here is host fp64 numpy, as in the reference, except the
nearest-profiled index's fp32 Lloyd sweep, which runs on the device of the
bound service (or on ``device`` for a standalone synthesizer).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .correlate import CorrelationIndex
from .dvfs import ClockPair, DVFSConfig
from .features import FEATURE_NAMES, _KIND_CLASS
from .simulator import AppProfile

__all__ = [
    "ColdStartConfig",
    "ColdStartStats",
    "ColdStartSynthesizer",
    "static_features",
]

#: The simulator's smooth-max overlap exponent (domains partially overlap
#: on real chips); the synthesized roofline uses the same shape.
SMOOTH_P = 8.0
_TINY = 1e-12
_MISSING = object()

_IDX = {n: i for i, n in enumerate(FEATURE_NAMES)}
_LOG_FLOPS = _IDX["log_flops"]
_LOG_BYTES = _IDX["log_bytes"]
_LOG_COLL = _IDX["log_coll_bytes"]
_POWER_DEFAULT = _IDX["power_default"]
_TIME_LOG = _IDX["time_default_log"]
_OVERHEAD_FRAC = _IDX["overhead_frac"]


def _roofline_terms(flops: float, hbm_bytes: float, coll_bytes: float,
                    d: DVFSConfig, clock: ClockPair
                    ) -> tuple[float, float, float]:
    """Ideal-efficiency roofline terms at one clock (arXiv:1701.05308's
    two-domain scaling: compute ∝ 1/s_core, memory ∝ 1/s_mem,
    collectives clock-independent)."""
    t_compute = flops / (d.peak_flops * clock.s_core)
    t_mem = hbm_bytes / (d.hbm_bw * clock.s_mem)
    t_coll = coll_bytes / d.ici_bw
    return t_compute, t_mem, t_coll


def _smooth_max(*terms: float, p: float = SMOOTH_P) -> float:
    a = np.array(terms + (_TINY,), dtype=np.float64)
    return float((a ** p).sum() ** (1.0 / p))


def static_features(app: AppProfile, d: DVFSConfig) -> np.ndarray:
    """20-dim :data:`FEATURE_NAMES` embedding from static counters only.

    The static half (log counts, intensity, op-mix fractions, chips, kind)
    is exact — identical to what :func:`~repro_torch.core.features.
    profile_features` computes from the compiled artifact. Every *measured*
    entry is replaced by its analytic roofline estimate at the default
    clock with ideal efficiency (the κ=1 prior): utilizations from term
    ratios, power from the electrical model, time from the smooth-max.
    The latent dynamics (``core_eff``, ``stall_frac``, wiggles, spikes)
    are deliberately not consulted — they are what profiling would have
    measured.
    """
    clock = d.default_clock
    t_compute, t_mem, t_coll = _roofline_terms(
        app.flops, app.hbm_bytes, app.coll_bytes, d, clock)
    busy = _smooth_max(t_compute, t_mem, t_coll)
    t = busy + app.overhead_s
    t = max(t, _TINY)
    u_core = min(t_compute / busy, 1.0)
    u_mem = min(t_mem / busy, 1.0)
    power = d.power(clock, u_core, u_mem)

    terms = {0.0: t_compute, 1.0: t_mem, 2.0: t_coll, 3.0: app.overhead_s}
    bottleneck = max(terms, key=terms.get)
    total_work = max(app.flops + app.hbm_bytes + app.coll_bytes, 1.0)

    feats = {
        "log_flops": np.log10(app.flops + 1.0),
        "log_bytes": np.log10(app.hbm_bytes + 1.0),
        "log_coll_bytes": np.log10(app.coll_bytes + 1.0),
        "arith_intensity_log": np.log10(app.arithmetic_intensity + 1e-6),
        "coll_frac": app.coll_bytes / total_work,
        "dot_frac": app.flops / total_work,
        "elem_frac": app.hbm_bytes / total_work,
        "n_chips_log": np.log2(app.n_chips),
        "sm": min(t_compute / t, 1.0),
        "mem_util": min(t_mem / t, 1.0),
        "achieved_tflops": app.flops / t / 1e12,
        "achieved_bw_frac": app.hbm_bytes / t / d.hbm_bw,
        "stall_mem_frac": max(0.0, min((t_mem - t_compute) / t, 1.0)),
        "stall_dep_frac": 0.0,
        "power_default": power,
        "time_default_log": np.log10(t),
        "energy_default_log": np.log10(max(power * t, _TINY)),
        "overhead_frac": app.overhead_s / t,
        "bottleneck_class": bottleneck,
        "kind_class": _KIND_CLASS.get(app.kind, 0.0),
    }
    return np.array([feats[n] for n in FEATURE_NAMES], dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class ColdStartConfig:
    """Knobs for the cold-start tier.

    ``warm_after``: observations before a cold app is promoted to
    ``"warmed"`` (the corrector typically dominates the static prior by
    then — a dozen completions give the 3-dim RLS basis a solid fit).
    ``k``: k-means cluster count for the nearest-profiled index (``None``
    → elbow-choose, as in :class:`CorrelationIndex`). ``max_log_kappa``
    bounds the transferred efficiency ratios to ``e^{±max_log_kappa}`` —
    a safety rail against degenerate neighbors, mirroring the online
    corrector's ``max_log``.
    """

    warm_after: int = 12
    k: Optional[int] = 5
    random_state: int = 0
    max_log_kappa: float = 3.0


@dataclasses.dataclass
class ColdStartStats:
    registered: int = 0           # unseen apps registered at admission
    synthesized_tables: int = 0   # analytic ladder builds served
    observations: int = 0         # completion feedback forwarded here
    promotions: int = 0           # cold → warmed transitions

    def summary(self) -> str:
        return (f"registered={self.registered} "
                f"synthesized={self.synthesized_tables} "
                f"observations={self.observations} "
                f"promotions={self.promotions}")


class ColdStartSynthesizer:
    """Synthesizes per-class (P, T) clock-ladder tables for unprofiled apps.

    Attach to a service via :meth:`PredictionService.attach_synthesizer`
    (which calls :meth:`bind`); the engine registers unknown arrivals via
    :meth:`PredictionService.note_app`. Standalone use (tests, notebooks)
    can pass ``dvfs`` directly and call :meth:`register` /
    :meth:`synthesize` without a service; such a synthesizer also takes the
    ``device`` of its index's Lloyd sweep (default ``"cuda"``, which raises
    without CUDA). Bound to a service, the sweep runs on the service's
    device and ``device`` is not read.
    """

    def __init__(self, config: Optional[ColdStartConfig] = None,
                 dvfs: Optional[DVFSConfig] = None,
                 device: "str | torch.device" = DEFAULT_DEVICE):
        self.config = config or ColdStartConfig()
        self.stats = ColdStartStats()
        self._dvfs = dvfs
        # a standalone synthesizer owns its device; a bound one uses the
        # service's
        self._device = resolve_device(device) if dvfs is not None else None
        self._service = None
        self._apps: dict[str, AppProfile] = {}
        self._static: dict[str, np.ndarray] = {}
        self._counts: dict[str, int] = {}
        self._warmed: set[str] = set()
        self._kappa: dict[str, tuple[float, float]] = {}
        self._neighbors: dict[str, Optional[str]] = {}
        self._index: Optional[CorrelationIndex] = None
        self._index_sig: Optional[tuple] = None

    # ------------------------------------------------------------------ #
    def bind(self, service) -> None:
        """Called by :meth:`PredictionService.attach_synthesizer` — gives
        the synthesizer the profiling-campaign dvfs (the embedding /
        κ-transfer reference frame) and the profiled corpus."""
        self._service = service
        self._index = None
        self._index_sig = None
        self._kappa.clear()
        self._neighbors.clear()

    @property
    def device(self) -> Optional[torch.device]:
        """The device of the nearest-profiled index's Lloyd sweep: the
        bound service's, else the one given at construction."""
        if self._service is not None:
            return self._service.device
        return self._device

    @property
    def base_dvfs(self) -> DVFSConfig:
        if self._service is not None:
            return self._service.dvfs
        if self._dvfs is None:
            raise ValueError("ColdStartSynthesizer needs a dvfs: bind a "
                             "service or pass dvfs= at construction")
        return self._dvfs

    # ------------------------------------------------------------------ #
    #  Registration + lifecycle
    # ------------------------------------------------------------------ #
    def register(self, app: AppProfile) -> bool:
        """Derive and store the app's static embedding (idempotent).
        Returns True when the app was newly registered."""
        if app.name in self._static:
            return False
        self._static[app.name] = static_features(app, self.base_dvfs)
        self._apps[app.name] = app
        self._counts[app.name] = 0
        self.stats.registered += 1
        return True

    def knows(self, name: str) -> bool:
        return name in self._static

    def status(self, name: str) -> str:
        """``"unknown"`` (never registered) | ``"cold"`` | ``"warmed"``."""
        if name not in self._static:
            return "unknown"
        return "warmed" if name in self._warmed else "cold"

    def static_features_of(self, name: str) -> np.ndarray:
        return self._static[name]

    def note_invalidation(self, name: str) -> None:
        """One observation-driven invalidation of ``name`` reached the
        service (the online adapter invalidates per completion, and on
        CUSUM drift) — the promotion clock of the cold-start lifecycle."""
        if name not in self._static:
            return
        self._counts[name] += 1
        self.stats.observations += 1
        if (name not in self._warmed
                and self._counts[name] >= self.config.warm_after):
            self._warmed.add(name)
            self.stats.promotions += 1

    def observations_of(self, name: str) -> int:
        return self._counts.get(name, 0)

    # ------------------------------------------------------------------ #
    #  Nearest-profiled mapping (corr/kmeans cluster structure)
    # ------------------------------------------------------------------ #
    def _corpus(self) -> Optional[tuple[list[str], np.ndarray]]:
        feats = (self._service.app_features
                 if self._service is not None else None)
        if not feats:
            return None
        names = sorted(feats)
        return names, np.stack([feats[n] for n in names])

    def neighbor(self, name: str) -> Optional[str]:
        """The nearest profiled app for ``name`` — its static embedding's
        k-means cluster, then in-cluster default-time proximity (the paper
        §III-D heuristic, via :class:`CorrelationIndex`). ``None`` when no
        profiled corpus exists (pure-analytic fallback, κ = 1)."""
        hit = self._neighbors.get(name, _MISSING)  # None is a cached value
        if hit is not _MISSING:
            return hit
        corpus = self._corpus()
        if corpus is None:
            self._neighbors[name] = None
            return None
        names, X = corpus
        sig = tuple(names)
        if self._index is None or self._index_sig != sig:
            k = self.config.k
            self._index = CorrelationIndex(
                k=min(k, len(names)) if k else None,
                random_state=self.config.random_state,
                device=self.device).fit(names, X)
            self._index_sig = sig
        nbr = self._index.correlated(self._static[name])
        self._neighbors[name] = nbr
        return nbr

    def _transfer(self, name: str) -> tuple[float, float]:
        """(κ_T, κ_P): the neighbor's measured-over-analytic default-clock
        ratios on the profiling dvfs — realized efficiency, transferred."""
        hit = self._kappa.get(name)
        if hit is not None:
            return hit
        nbr = self.neighbor(name)
        if nbr is None:
            kappas = (1.0, 1.0)
            self._kappa[name] = kappas
            return kappas
        f = self._service.app_features[nbr]
        d = self.base_dvfs
        clock = d.default_clock
        flops_n = max(10.0 ** f[_LOG_FLOPS] - 1.0, 0.0)
        bytes_n = max(10.0 ** f[_LOG_BYTES] - 1.0, 0.0)
        coll_n = max(10.0 ** f[_LOG_COLL] - 1.0, 0.0)
        t_n = 10.0 ** f[_TIME_LOG]
        exec_n = max(t_n * (1.0 - f[_OVERHEAD_FRAC]), _TINY)
        tc, tm, tl = _roofline_terms(flops_n, bytes_n, coll_n, d, clock)
        busy_n = _smooth_max(tc, tm, tl)
        u_core = min(tc / busy_n, 1.0)
        u_mem = min(tm / busy_n, 1.0)
        p_model = max(d.power(clock, u_core, u_mem), _TINY)
        lim = float(np.exp(self.config.max_log_kappa))
        k_t = float(np.clip(exec_n / busy_n, 1.0 / lim, lim))
        k_p = float(np.clip(f[_POWER_DEFAULT] / p_model, 1.0 / lim, lim))
        self._kappa[name] = (k_t, k_p)
        return k_t, k_p

    # ------------------------------------------------------------------ #
    #  Ladder synthesis
    # ------------------------------------------------------------------ #
    def synthesize(self, name: str, clocks: Sequence[ClockPair],
                   d: DVFSConfig) -> tuple[np.ndarray, np.ndarray]:
        """The synthesized (P, T) arrays over ``clocks`` of class dvfs
        ``d`` (per-class constants baked in by ``DeviceClass.derive``).
        Deterministic in (app statics, profiled corpus, dvfs)."""
        app = self._apps[name]
        c = app.flops / d.peak_flops
        m = app.hbm_bytes / d.hbm_bw
        l = app.coll_bytes / d.ici_bw
        s_core = np.array([ck.s_core for ck in clocks], dtype=np.float64)
        s_mem = np.array([ck.s_mem for ck in clocks], dtype=np.float64)
        p = SMOOTH_P
        M = ((c / s_core) ** p + (m / s_mem) ** p
             + l ** p + _TINY ** p) ** (1.0 / p)
        k_t, k_p = self._transfer(name)
        T = k_t * M + app.overhead_s
        u_core = np.minimum((c / s_core) / M, 1.0)
        u_mem = np.minimum((m / s_mem) / M, 1.0)
        P = k_p * np.array(
            [d.power(ck, uc, um)
             for ck, uc, um in zip(clocks, u_core, u_mem)])
        self.stats.synthesized_tables += 1
        return P, T
