"""Online measurement-feedback adaptation (beyond paper; their §VI outlook).

The paper's pipeline is strictly offline — profile once, train once, then
schedule forever. A mispredicted application therefore keeps burning energy
or missing deadlines for its whole lifetime. This module closes the loop:
every completed job is a free labelled sample ``(app, clock) → (time, power)``
that the scheduler can learn from *while it runs*.

Three cooperating pieces, all layered **on top of** the frozen offline
predictor (never mutating it):

* :class:`ObservationStore` — per-app *sufficient statistics* of the
  multiplicative residuals between measured and frozen-predicted time/power.
  Updates are commutative sums (Gram matrix ``Σ z zᵀ``, moment vectors
  ``Σ z·r``), so corrections are order-independent for a given multiset of
  observations.
* :class:`RLSCorrector` / :class:`GBDTCorrector` — per-app residual models
  solved on demand from the store. The default RLS corrector is a ridge
  regression (recursive-least-squares in sufficient-statistic form, closed
  form via :class:`~repro_torch.core.linear.Ridge`-style normal equations)
  of the log-residual on a tiny clock basis ``z = [1, s_core, s_mem]``; the
  GBDT variant refits a low-iteration oblivious-tree ensemble
  (:func:`~repro_torch.core.gbdt.fit_gbdt`) on the raw residual rows.
  Corrections are applied multiplicatively: ``T' = T·exp(z·w_t)``,
  ``P' = P·exp(z·w_p)``.
  With zero observations the correction is exactly ``exp(0) = 1.0`` — the
  corrected table is bit-identical to the frozen one.
* :class:`DriftDetector` — a per-app two-sided CUSUM on *innovations* (the
  residual left after the current correction), normalized against a
  reference window (the app's first ``warmup`` observations). When
  the statistic crosses the threshold the app's true behavior has *shifted*
  (not just noise): the detector fires, the adapter drops the app's
  pre-drift statistics (so the corrector refits to post-drift data only) and
  selectively invalidates the app's corrected ``(P, T)`` table in the
  :class:`~repro_torch.core.prediction_service.PredictionService`.

:class:`OnlineAdapter` wires them together and plugs into the
:class:`~repro_torch.core.engine.EventEngine` as its ``feedback`` callback: one
``observe(record)`` call per completed job. Disable it (``enabled=False``)
or simply don't attach it and the whole scheduling stack is bit-identical to
the frozen path.

Host numpy fp64 throughout, as in the reference — except the GBDT
corrector's predictions, which run on the service's device: on a card
every :meth:`GBDTCorrector.correct` (one ladder of rows) and
:meth:`GBDTCorrector.predicted_residual` (one row) is a launch of the
GBDT kernel, bit-identical to the reference's numpy sums.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .dvfs import ClockPair
from .engine import ExecutionRecord
from .gbdt import GBDTParams, fit_gbdt
from .prediction_service import PredictionService

__all__ = [
    "Observation",
    "ObservationStore",
    "RLSCorrector",
    "GBDTCorrector",
    "DriftConfig",
    "DriftDetector",
    "OnlineAdapter",
    "clock_basis",
]

#: Dimension of the residual-regression clock basis ``[1, s_core, s_mem]``.
BASIS_DIM = 3


def clock_basis(clock: ClockPair) -> np.ndarray:
    """The tiny per-observation feature vector the residual models regress
    on. Deliberately low-dimensional: with O(10) observations per app there
    is no data for anything richer, and a bias + two slopes already captures
    "uniformly slower" (bias) and "clock-sensitivity changed" (slopes)."""
    return np.array([1.0, clock.s_core, clock.s_mem], dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class Observation:
    """One completed job's measured outcome vs. the frozen prediction."""

    name: str
    clock: ClockPair
    time_s: float
    power_w: float
    r_time: float          # log(measured / frozen-predicted) time residual
    r_power: float         # log(measured / frozen-predicted) power residual


@dataclasses.dataclass
class _AppStats:
    """Sufficient statistics for one app's residual stream.

    ``G``/``bt``/``bp`` (the correction inputs) are commutative sums over
    the observation multiset. The innovation moments (``sum_in*``) track
    one-step-ahead prediction errors *vs. the corrected model* — they are
    order-dependent by nature (each innovation depends on the weights at
    observe time) and feed only the drift detector and the risk margin."""

    n: int = 0
    G: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((BASIS_DIM, BASIS_DIM)))
    bt: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(BASIS_DIM))
    bp: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(BASIS_DIM))
    sum_rt: float = 0.0
    sum_rt2: float = 0.0
    n_in: int = 0
    sum_in: float = 0.0
    sum_in2: float = 0.0


class ObservationStore:
    """Per-app accumulator of residual sufficient statistics.

    ``update`` only performs commutative ``+=`` on the per-app Gram matrix
    and moment vectors, so any permutation of the same observations yields
    the same statistics (up to float summation error) — the property the
    order-independence test pins down. ``reset(name)`` forgets one app
    (drift recovery); raw observations are optionally retained per app for
    the GBDT corrector (``keep_rows=True``).
    """

    def __init__(self, keep_rows: bool = False, max_rows: int = 4096):
        self.keep_rows = bool(keep_rows)
        self.max_rows = int(max_rows)
        self._stats: dict[str, _AppStats] = {}
        self._rows: dict[str, list[tuple[np.ndarray, float, float]]] = {}
        self._gen: dict[str, int] = {}    # bumped per reset; survives it

    def update(self, obs: Observation,
               innovation: Optional[float] = None) -> _AppStats:
        st = self._stats.get(obs.name)
        if st is None:
            st = self._stats[obs.name] = _AppStats()
        z = clock_basis(obs.clock)
        st.n += 1
        st.G += np.outer(z, z)
        st.bt += z * obs.r_time
        st.bp += z * obs.r_power
        st.sum_rt += obs.r_time
        st.sum_rt2 += obs.r_time * obs.r_time
        if innovation is not None:
            st.n_in += 1
            st.sum_in += innovation
            st.sum_in2 += innovation * innovation
        if self.keep_rows:
            rows = self._rows.setdefault(obs.name, [])
            if len(rows) < self.max_rows:
                rows.append((z, obs.r_time, obs.r_power))
        return st

    def stats(self, name: str) -> Optional[_AppStats]:
        return self._stats.get(name)

    def rows(self, name: str) -> list[tuple[np.ndarray, float, float]]:
        return self._rows.get(name, [])

    def count(self, name: str) -> int:
        st = self._stats.get(name)
        return 0 if st is None else st.n

    def residual_std(self, name: str) -> float:
        """Std of the app's raw log-time residuals (vs. the frozen base)."""
        st = self._stats.get(name)
        if st is None or st.n < 2:
            return 0.0
        mean = st.sum_rt / st.n
        var = max(st.sum_rt2 / st.n - mean * mean, 0.0)
        return math.sqrt(var)

    def innovation_rms(self, name: str) -> float:
        """RMS of one-step-ahead log-time innovations (risk-margin input):
        captures both remaining bias (corrector still catching up) and
        irreducible noise."""
        st = self._stats.get(name)
        if st is None or st.n_in < 2:
            return 0.0
        return math.sqrt(st.sum_in2 / st.n_in)

    def generation(self, name: str) -> int:
        """Incremented on every :meth:`reset` of ``name`` — cache keys that
        must distinguish pre- and post-reset states include this."""
        return self._gen.get(name, 0)

    def reset(self, name: str) -> None:
        self._stats.pop(name, None)
        self._rows.pop(name, None)
        self._gen[name] = self._gen.get(name, 0) + 1

    def reset_all(self) -> None:
        for name in self._stats:
            self._gen[name] = self._gen.get(name, 0) + 1
        self._stats.clear()
        self._rows.clear()


# ---------------------------------------------------------------------- #
#  Residual correctors
# ---------------------------------------------------------------------- #
class RLSCorrector:
    """Ridge residual model in sufficient-statistic (RLS) form.

    Per app solves ``(G + λI) w = b`` for the time and power log-residual
    weight vectors and applies ``scale = exp(clip(Z @ w))`` to the frozen
    ladder arrays. λ acts as a prior pinning the correction at 1.0 until
    enough evidence accumulates; ``max_log`` bounds the correction to
    ``e^{±max_log}`` as a safety rail against wild early fits.

    Satisfies the ``CorrectionProvider`` duck-type consumed by
    :meth:`PredictionService.table`: ``correct(name, clocks, P, T)``.
    """

    def __init__(self, store: ObservationStore, lam: float = 3.0,
                 max_log: float = 1.0, min_obs: int = 1):
        self.store = store
        self.lam = float(lam)
        self.max_log = float(max_log)
        self.min_obs = int(min_obs)
        self._basis_cache: dict[tuple, np.ndarray] = {}

    def weights(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        """(w_time, w_power); zeros when the app has too few observations."""
        st = self.store.stats(name)
        zero = np.zeros(BASIS_DIM)
        if st is None or st.n < self.min_obs:
            return zero, zero
        A = st.G + self.lam * np.eye(BASIS_DIM)
        return np.linalg.solve(A, st.bt), np.linalg.solve(A, st.bp)

    def predicted_residual(self, name: str, clock: ClockPair) -> float:
        """The log-time residual the current correction predicts at
        ``clock`` — subtracted from an observed residual to form the
        one-step-ahead innovation."""
        wt, _ = self.weights(name)
        return float(clock_basis(clock) @ wt)

    def _basis_matrix(self, clocks: Sequence[ClockPair]) -> np.ndarray:
        key = tuple(clocks)
        Z = self._basis_cache.get(key)
        if Z is None:
            Z = np.stack([clock_basis(c) for c in clocks])
            self._basis_cache[key] = Z
        return Z

    def correct(self, name: str, clocks: Sequence[ClockPair],
                P: np.ndarray, T: np.ndarray
                ) -> tuple[np.ndarray, np.ndarray]:
        wt, wp = self.weights(name)
        Z = self._basis_matrix(clocks)
        st = np.exp(np.clip(Z @ wt, -self.max_log, self.max_log))
        sp = np.exp(np.clip(Z @ wp, -self.max_log, self.max_log))
        return P * sp, T * st


class GBDTCorrector:
    """Low-iteration oblivious-tree residual model (CatBoost-style, reusing
    :func:`repro_torch.core.gbdt.fit_gbdt`). Needs the store constructed with
    ``keep_rows=True``; refits lazily per app when its row count changes.
    Heavier than RLS but captures clock-nonlinear drift; intended for
    long-lived apps with hundreds of completions.

    Fits run on the host (numpy, as every GBDT fit here); the fitted
    ensembles live on ``device`` and predict there — on a card each
    :meth:`correct` and :meth:`predicted_residual` is one launch of the
    GBDT kernel per model."""

    def __init__(self, store: ObservationStore, min_obs: int = 16,
                 max_log: float = 1.0,
                 params: Optional[GBDTParams] = None,
                 device: "str | torch.device" = DEFAULT_DEVICE):
        if not store.keep_rows:
            raise ValueError("GBDTCorrector needs ObservationStore("
                             "keep_rows=True)")
        self.device = resolve_device(device)
        self.store = store
        self.min_obs = int(min_obs)
        self.max_log = float(max_log)
        self.params = params or GBDTParams(iterations=30, depth=2,
                                           learning_rate=0.2, n_bins=16)
        self._fits: dict[str, tuple[tuple, object, object]] = {}

    def _models(self, name: str):
        rows = self.store.rows(name)
        if len(rows) < self.min_obs:
            return None
        # keyed by (reset generation, row count): generation distinguishes
        # a post-reset store regrown to the same count, while a
        # max_rows-saturated store (rows frozen) keeps its fit cached
        key = (self.store.generation(name), len(rows))
        hit = self._fits.get(name)
        if hit is not None and hit[0] == key:
            return hit[1], hit[2]
        Z = np.stack([r[0] for r in rows])
        rt = np.array([r[1] for r in rows])
        rp = np.array([r[2] for r in rows])
        mt = fit_gbdt(Z, rt, self.params, device=self.device)
        mp = fit_gbdt(Z, rp, self.params, device=self.device)
        self._fits[name] = (key, mt, mp)
        return mt, mp

    def predicted_residual(self, name, clock) -> float:
        models = self._models(name)
        if models is None:
            return 0.0
        return float(models[0].predict(clock_basis(clock)[None])[0])

    def correct(self, name, clocks, P, T):
        models = self._models(name)
        if models is None:
            return P, T
        mt, mp = models
        Z = np.stack([clock_basis(c) for c in clocks])
        st = np.exp(np.clip(mt.predict(Z), -self.max_log, self.max_log))
        sp = np.exp(np.clip(mp.predict(Z), -self.max_log, self.max_log))
        return P * sp, T * st


# ---------------------------------------------------------------------- #
#  Drift detection
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class DriftConfig:
    """Two-sided CUSUM on reference-normalized time *innovations* (the
    residual left after the current correction — near zero for an adapted
    model, persistently offset under drift).

    ``warmup`` observations establish the app's reference innovation
    mean/std; each later innovation is standardized against that reference
    and fed to the CUSUM recursions

        S⁺ ← max(0, S⁺ + z − k)        S⁻ ← max(0, S⁻ − z − k)

    firing when either exceeds ``threshold``. ``k`` (the allowance) absorbs
    persistent half-σ wander; see docs/online_adaptation.md for tuning.
    """

    warmup: int = 8
    k: float = 0.5
    threshold: float = 8.0
    min_ref_std: float = 0.02    # floor: residuals are log-scale (2% ≈ noise)
    cooldown: int = 4            # post-drift obs ignored while the corrector
                                 # re-converges (keeps the transient out of
                                 # the new reference window)


@dataclasses.dataclass
class _CusumState:
    n_ref: int = 0
    ref_sum: float = 0.0
    ref_sum2: float = 0.0
    mu: float = 0.0
    sigma: float = 1.0
    ready: bool = False
    s_pos: float = 0.0
    s_neg: float = 0.0
    cooldown_left: int = 0


class DriftDetector:
    """Per-app CUSUM bank. ``observe(name, r)`` returns True when app
    ``name``'s residual stream has drifted; the caller is expected to reset
    the app (store + detector) and invalidate its cached table."""

    def __init__(self, cfg: DriftConfig = DriftConfig()):
        self.cfg = cfg
        self._state: dict[str, _CusumState] = {}
        self.drift_events: list[tuple[str, int]] = []   # (app, obs index)
        self._seen: dict[str, int] = {}

    def observe(self, name: str, residual: float) -> bool:
        cfg = self.cfg
        st = self._state.get(name)
        if st is None:
            st = self._state[name] = _CusumState()
        self._seen[name] = self._seen.get(name, 0) + 1
        if st.cooldown_left > 0:
            st.cooldown_left -= 1
            return False
        if not st.ready:
            st.n_ref += 1
            st.ref_sum += residual
            st.ref_sum2 += residual * residual
            if st.n_ref >= cfg.warmup:
                st.mu = st.ref_sum / st.n_ref
                var = max(st.ref_sum2 / st.n_ref - st.mu * st.mu, 0.0)
                st.sigma = max(math.sqrt(var), cfg.min_ref_std)
                st.ready = True
            return False
        z = (residual - st.mu) / st.sigma
        st.s_pos = max(0.0, st.s_pos + z - cfg.k)
        st.s_neg = max(0.0, st.s_neg - z - cfg.k)
        if max(st.s_pos, st.s_neg) > cfg.threshold:
            self.drift_events.append((name, self._seen[name]))
            return True
        return False

    def reset(self, name: str, cooldown: Optional[int] = None) -> None:
        """Forget the app — it re-warms on its next observation, after
        skipping ``cooldown`` observations (default: ``cfg.cooldown``)."""
        st = _CusumState()
        st.cooldown_left = self.cfg.cooldown if cooldown is None else cooldown
        self._state[name] = st

    def statistic(self, name: str) -> float:
        st = self._state.get(name)
        return 0.0 if st is None else max(st.s_pos, st.s_neg)


# ---------------------------------------------------------------------- #
#  The feedback loop
# ---------------------------------------------------------------------- #
class OnlineAdapter:
    """Measurement-feedback loop: EngineHooks-compatible ``observe`` that
    turns each :class:`ExecutionRecord` into a residual sample, updates the
    corrector, runs drift detection, and keeps the service's corrected-table
    cache coherent.

    Residuals are always measured against the **frozen base table** (not the
    corrected one), so the corrector is a stateless function of the observed
    multiset and the detector sees the raw shift, decoupled from how much of
    it the corrector has already absorbed.

    Invalidation discipline: after every ``update_every``-th observation of
    an app (default: every one) the adapter calls
    ``service.invalidate(name)`` so the next decision re-solves corrections;
    between invalidations the cached corrected table is served unchanged.
    On drift it additionally drops the app's store statistics and resets the
    detector, so the corrector refits from post-drift evidence only.

    ``enabled=False`` (or never attaching the adapter) short-circuits
    ``observe`` — the engine output is then bit-identical to the frozen
    path.
    """

    def __init__(
        self,
        service: PredictionService,
        corrector: str | object = "rls",
        drift: Optional[DriftConfig] = DriftConfig(),
        update_every: int = 1,
        risk_scale: float = 1.0,
        max_margin: float = 0.5,
        enabled: bool = True,
    ):
        if not service.has_predictor:
            raise ValueError("OnlineAdapter needs a service with a fitted "
                             "predictor (frozen baseline to correct)")
        self.service = service
        if corrector == "rls":
            self.store = ObservationStore()
            self.corrector = RLSCorrector(self.store)
        elif corrector == "gbdt":
            self.store = ObservationStore(keep_rows=True)
            self.corrector = GBDTCorrector(self.store,
                                           device=service.device)
        else:                       # duck-typed custom corrector
            self.corrector = corrector
            self.store = getattr(corrector, "store", ObservationStore())
        self.detector = DriftDetector(drift) if drift is not None else None
        self.update_every = max(1, int(update_every))
        self.risk_scale = float(risk_scale)
        self.max_margin = float(max_margin)
        self.enabled = bool(enabled)
        self.n_observed = 0
        self.n_drifts = 0
        # per-device-class ladder index maps (a record's clock indexes a
        # different ladder on each class), built lazily; key None = the
        # service's own ladder
        self._clock_index: dict[Optional[str], dict[ClockPair, int]] = {
            None: {c: i for i, c in enumerate(service.clocks)}}
        # app name -> correction keys seen for it (one per device class)
        self._app_keys: dict[str, set[str]] = {}
        service.attach_corrector(self.corrector)

    # -- feedback entry point (EventEngine.feedback) -------------------- #
    def observe(self, rec: ExecutionRecord) -> Optional[Observation]:
        if not self.enabled:
            return None
        # resolve the record's device class: classes normalized onto the
        # service's own dvfs (and the classless path) share key None, so a
        # uniform baseline pool corrects exactly like the classless engine
        dc = self.service.device_class(rec.device_class)
        ck = None if dc is None else dc.name
        idx_map = self._clock_index.get(ck)
        if idx_map is None:
            idx_map = {c: i
                       for i, c in enumerate(self.service.clocks_for(ck))}
            self._clock_index[ck] = idx_map
        i = idx_map.get(rec.clock)
        if i is None:       # clock outside the class's ladder: can't label
            return None
        # per-segment normalization: a preempted/resumed segment
        # covers only ``work_frac`` of the job and its measured time may
        # include checkpoint/restore seconds — the residual compares the
        # pure execution seconds against the base prediction *for that
        # fraction of work*, so every segment is a full-weight rate
        # sample and a whole job (work_frac=1, overhead 0) reduces to the
        # pre-preemption residual bit-for-bit
        exec_s = rec.time_s - rec.overhead_s
        if rec.work_frac <= 1e-9 or exec_s <= 0:
            return None        # checkpoint-only sliver: no rate signal
        base = self.service.base_table(rec.name, dc)
        # corrections, statistics, and drift detection are all filed per
        # (app, device class) — a drift on one class never resets another
        key = PredictionService._correction_key(rec.name, ck)
        self._app_keys.setdefault(rec.name, set()).add(key)
        obs = Observation(
            name=key, clock=rec.clock, time_s=rec.time_s,
            power_w=rec.power_w,
            r_time=math.log(max(exec_s, 1e-12)
                            / max(rec.work_frac * base.T[i], 1e-12)),
            r_power=math.log(max(rec.power_w, 1e-12) / max(base.P[i], 1e-12)),
        )
        self.n_observed += 1
        # innovation: residual left over after the *current* correction —
        # computed before this observation updates the statistics, so it is
        # a true one-step-ahead prediction error. Near zero once the
        # corrector has adapted; a sustained offset means drift. Custom
        # correctors without predicted_residual degrade to raw residuals
        # (detector still works, margins stay conservative).
        predict = getattr(self.corrector, "predicted_residual", None)
        innovation = obs.r_time - (
            predict(key, rec.clock) if predict is not None else 0.0)
        st = self.store.update(obs, innovation=innovation)
        drifted = (self.detector is not None
                   and self.detector.observe(key, innovation))
        if drifted:
            self.n_drifts += 1
            self.store.reset(key)
            self.detector.reset(key)
            self.service.invalidate(rec.name)
        elif st.n % self.update_every == 0:
            self.service.invalidate(rec.name)
        return obs

    # -- risk-aware policy input ---------------------------------------- #
    def margin(self, name: str) -> float:
        """Residual-variance-driven deadline margin for
        :class:`~repro_torch.core.policies.RiskAware`
        (``margin_fn=adapter.margin``):
        apps whose corrections are still noisy get a larger safety
        inflation on predicted time. Per-app across classes: the margin is
        the worst (largest) innovation RMS over the app's device classes —
        conservative, since the policy cannot know placement in advance."""
        keys = self._app_keys.get(name) or (name,)
        return min(
            self.risk_scale * max(self.store.innovation_rms(k)
                                  for k in keys),
            self.max_margin)

    def summary(self) -> str:
        return (f"observed={self.n_observed} drifts={self.n_drifts} "
                f"apps={len(self.store._stats)}")
