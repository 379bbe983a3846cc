"""Batched, memoized power/time prediction service.

Algorithm 1 (paper §IV) re-predicts power & time for every queued job over
the full clock ladder at every scheduling decision — O(jobs × clocks) model
calls per tick. But the inputs are pure functions of the *application* (its
profiled feature vector) and the *clock pair*: for a fixed trained predictor
the whole per-app ladder table is immutable. This service precomputes it
once per distinct app in one vectorized call and serves every subsequent
decision from cache:

* :meth:`table` — the full ``(P, T)`` ladder table for an app (predicted,
  correlation-index indirection applied, memoized per resolved profile).
* :meth:`prefetch_tables` — every missing table of an admission wave in one
  stacked batch per (class, regressor).
* :meth:`t_min` / :meth:`t_dc` — cached point predictions at the max /
  default clock (the queue-aware budget and virtual-pacing inputs).
* :meth:`truth_table` / :meth:`true_t_min` / :meth:`true_t_dc` — the
  ground-truth analogues for the oracle policy (memoized testbed sweeps).

**Online correction layer.** An attached corrector (see
:mod:`repro_torch.core.online`) multiplies measurement-feedback scale
factors onto the frozen base table. The base cache is never touched by
feedback; the corrected view lives in a separate per-app cache with an
explicit :meth:`invalidate` API the feedback loop calls when corrections
change.

**The device.** The service runs on its ``device`` (default ``"cuda"``),
which must be the predictor's. On a card, *every* GBDT batch — a stacked
prefetch, a single ladder, a single-row point prediction — goes through the
hand-written CUDA kernel (:mod:`repro_torch.kernels.gbdt_predict`) and is
counted in :attr:`ServiceStats.kernel_batches`. The reference's row
threshold for kernel routing is gone: it was sized from a host numpy
cache-spill measurement and the kernel was never timed against it. A
threshold comes back only once the card's per-row crossover is measured
(``PERF.md``). On the CPU the same batches take the kernel's plain version.

Invariants:

* **Cache-key contract.** Base tables are keyed by the *resolved profile*
  (``("own", name)`` or ``("corr", correlated_name)`` — see
  :meth:`resolve`) **plus the device-class key**, so correlated apps share
  one build per class. Every cached base quantity (tables, ``t_min``/
  ``t_dc`` points, truth sweeps) is a pure function of ``(predictor, app
  profile, DVFS config)`` and never invalidates: a service may be reused
  across runs indefinitely.
* **Device-class keying.** Every query takes an optional
  :class:`~repro_torch.core.dvfs.DeviceClass`; ``None`` — or any class
  whose dvfs equals the service's own with no per-class features —
  normalizes to the same key (:meth:`register_class`), so uniform pools of
  the baseline class hit the very same cache entries as the classless path.
* **Corrected tables are keyed by (app name, class key)** (corrections are
  per-(app, class) even when base tables are shared via correlation) and
  invalidate only through :meth:`invalidate` — which drops the app across
  every class; the next :meth:`table` call re-applies the corrector's
  *current* correction to the cached base (no predictor re-run).
* **Frozen-path identity.** With no corrector attached — or an attached
  corrector holding zero observations (its scale is exactly ``exp(0)``) —
  :meth:`table` output is bit-identical to the uncorrected service.
* **Rowwise identity.** The GBDT kernel and its plain version sum each row
  independently in a fixed tree order, so a table sliced out of a stacked
  prefetch is bit-identical to the same table built alone.
* **Cold-start tier.** An attached
  :class:`~repro_torch.core.coldstart.ColdStartSynthesizer` makes
  unprofiled apps resolvable: :meth:`resolve` returns a ``("cold", name)``
  key with the app's static embedding, :meth:`base_table` builds the
  analytic roofline ladder (``source="synthesized"``, host numpy) instead of
  calling the predictor, and the correction layer refines it exactly like a
  profiled table. Profiled apps never touch the synthesizer — attaching one
  changes no profiled-app decision. Unknown apps with no synthesizer
  coverage raise a typed :class:`UnknownAppError` carrying the nearest
  profiled name.
"""
from __future__ import annotations

import collections
import dataclasses
import difflib
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .correlate import CorrelationIndex
from .dvfs import ClockPair, DVFSConfig, DeviceClass
from .features import clock_features
from .predictor import EnergyTimePredictor
from .simulator import AppProfile, Testbed

__all__ = ["ClockTable", "StackedTable", "ServiceStats", "PredictionService",
           "UnknownAppError"]


class UnknownAppError(KeyError):
    """An app has no profiled feature vector and no attached cold-start
    synthesizer covers it. Subclasses :class:`KeyError`; the message names
    the nearest profiled app (closest-spelled name) so a mis-keyed job is
    diagnosable from the traceback alone."""

    def __init__(self, name: str, known=()):
        self.name = name
        matches = difflib.get_close_matches(name, list(known), n=1,
                                            cutoff=0.0)
        self.suggestion = matches[0] if matches else None
        msg = (f"unknown app {name!r}: no profiled feature vector and no "
               "cold-start synthesizer registration for it")
        if self.suggestion is not None:
            msg += f" (nearest profiled app: {self.suggestion!r})"
        else:
            msg += " (no profiled apps at all)"
        super().__init__(msg)

    def __str__(self) -> str:   # KeyError wraps its arg in quotes — undo
        return self.args[0]


@dataclasses.dataclass(frozen=True)
class ClockTable:
    """Immutable per-app ladder table: ``P[i]``/``T[i]`` at ``clocks[i]``."""

    clocks: tuple[ClockPair, ...]
    P: np.ndarray                 # predicted/true power (W) per clock
    T: np.ndarray                 # predicted/true time (s) per clock
    source: str = "predicted"     # "predicted"|"truth"|"corrected"
                                  # |"synthesized" (cold-start tier)

    def __len__(self) -> int:
        return len(self.clocks)

    def remnant(self, work_frac: float,
                overhead_s: float = 0.0) -> "ClockTable":
        """The table re-expressed for a resumable remnant covering
        ``work_frac`` of the job's work: ``T' = work_frac * T +
        overhead_s``, power per clock unchanged (a remnant draws what
        the app draws). The single definition of the remnant lens —
        :meth:`~repro_torch.core.preemption.PreemptionManager.remnant_view`
        and :meth:`~repro_torch.core.policies.Policy.select_resume` both
        delegate here, so remnant pricing can never drift between the
        engine's resume path and the policy API."""
        return ClockTable(clocks=self.clocks, P=self.P,
                          T=self.T * work_frac + overhead_s,
                          source=self.source)

    @property
    def E(self) -> np.ndarray:
        return self.P * self.T


@dataclasses.dataclass(frozen=True)
class StackedTable:
    """Padded/masked (candidate × clock) view over per-(app, class)
    :class:`ClockTable` rows — the batched joint decision's input.

    Component ladders of different lengths (v5e: 64 clocks, v5lite: 24)
    are padded to a common width with ``+inf`` in both ``P`` and ``T``
    (``mask`` False there), so a feasibility test ``T' <= budget`` can
    never admit a padded slot and a masked row minimum ignores it. The
    component tables are retained for identity checks (a stacked view is
    valid only while every row *is* the table a decision would fetch) and
    for recovering exact per-row clock objects after an argmin."""

    tables: tuple[ClockTable, ...]
    P: np.ndarray                 # (C, Lmax) padded power, pad = +inf
    T: np.ndarray                 # (C, Lmax) padded time, pad = +inf
    mask: np.ndarray              # (C, Lmax) bool, True on real entries
    lengths: tuple[int, ...]

    def __len__(self) -> int:
        return len(self.tables)

    @classmethod
    def from_tables(cls, tables: Sequence[ClockTable]) -> "StackedTable":
        tables = tuple(tables)
        lengths = tuple(len(t) for t in tables)
        C, L = len(tables), max(lengths)
        P = np.full((C, L), np.inf)
        T = np.full((C, L), np.inf)
        mask = np.zeros((C, L), dtype=bool)
        for i, t in enumerate(tables):
            n = lengths[i]
            P[i, :n] = t.P
            T[i, :n] = t.T
            mask[i, :n] = True
        return cls(tables=tables, P=P, T=T, mask=mask, lengths=lengths)


@dataclasses.dataclass
class ServiceStats:
    table_builds: int = 0         # vectorized ladder-table constructions
    table_hits: int = 0           # decisions served from cache
    truth_builds: int = 0
    truth_hits: int = 0
    point_predictions: int = 0    # cached single-row t_min / t_dc predicts
    rows_predicted: int = 0       # total predictor rows evaluated
    kernel_batches: int = 0       # GBDT batches run by the CUDA kernel
    corrected_builds: int = 0     # corrected-view (re)applications
    corrected_hits: int = 0       # decisions served from the corrected cache
    invalidations: int = 0        # targeted corrected-cache invalidations
    stacked_builds: int = 0       # stacked (candidate x clock) view builds
    stacked_hits: int = 0         # joint decisions served from stacked cache
    prefetched_tables: int = 0    # tables built via batched prefetch
    synthesized_builds: int = 0   # cold-start analytic ladder builds

    def summary(self) -> str:
        return (f"table_builds={self.table_builds} hits={self.table_hits} "
                f"truth_builds={self.truth_builds} "
                f"rows={self.rows_predicted} kernel={self.kernel_batches} "
                f"corrected={self.corrected_builds}"
                f"/{self.corrected_hits}hit "
                f"invalidations={self.invalidations}")


class PredictionService:
    """Shared prediction layer for schedulers; safe to reuse across runs —
    every cached quantity is a deterministic function of (predictor, app
    profile, DVFS config)."""

    def __init__(
        self,
        dvfs: DVFSConfig,
        predictor: Optional[EnergyTimePredictor] = None,
        app_features: Optional[dict[str, np.ndarray]] = None,
        corr_index: Optional[CorrelationIndex] = None,
        corr_features: Optional[dict[str, np.ndarray]] = None,
        testbed: Optional[Testbed] = None,
        class_features: Optional[dict[str, dict[str, np.ndarray]]] = None,
        stacked_cache_size: int = 128,
        device: "str | torch.device" = DEFAULT_DEVICE,
    ):
        self.device = resolve_device(device)
        if predictor is not None and predictor.device != self.device:
            raise ValueError(
                f"predictor lives on {predictor.device}, the service on "
                f"{self.device}: build both on one device")
        self.dvfs = dvfs
        self.predictor = predictor
        self.app_features = app_features
        self.corr_index = corr_index
        self.corr_features = corr_features
        self.testbed = testbed
        self.stacked_cache_size = int(stacked_cache_size)
        #: per-class app profile vectors (``{class_name: {app: feats}}``) —
        #: the "profile once per device class" campaign. Apps/classes not
        #: listed fall back to the shared ``app_features`` (+ correlation).
        self.class_features = class_features or {}
        self.stats = ServiceStats()

        self.clocks: tuple[ClockPair, ...] = tuple(dvfs.clock_list())
        self._clock_X = [clock_features(c, dvfs) for c in self.clocks]
        self._corrector = None
        self._synthesizer = None
        # corrected views keyed (app name, class key); base tables keyed
        # (resolved profile key, class key)
        self._corrected: dict[tuple[str, Optional[str]], ClockTable] = {}
        # stacked (candidate x clock) views, LRU-bounded; entries carry the
        # correction epoch they were built at — any corrector attach/detach/
        # invalidate bumps the epoch and lazily voids every stacked view
        # without scanning the cache (base/truth tables never invalidate,
        # so epoch-stale entries simply rebuild from the same components)
        self._stacked: "collections.OrderedDict[tuple, tuple[int, StackedTable]]" = (
            collections.OrderedDict())
        self._epoch = 0
        self._tables: dict[tuple, ClockTable] = {}
        self._truth: dict[tuple, ClockTable] = {}
        self._resolved: dict[str, tuple[tuple, np.ndarray]] = {}
        self._tmin: dict[tuple, float] = {}
        self._tdc: dict[tuple, float] = {}
        self._true_tmin: dict[tuple, float] = {}
        self._true_tdc: dict[tuple, float] = {}
        self._classes: dict[str, DeviceClass] = {}
        self._ladder_index: dict[
            Optional[str], dict[ClockPair, int]] = {}
        self._class_keys: dict[str, Optional[str]] = {}
        self._seen_class_dvfs: dict[str, DVFSConfig] = {}
        self._class_clocks: dict[
            str, tuple[tuple[ClockPair, ...], list[np.ndarray]]] = {}

    # ------------------------------------------------------------------ #
    @property
    def has_predictor(self) -> bool:
        return self.predictor is not None and self.app_features is not None

    def resolve(self, name: str) -> tuple[tuple, np.ndarray]:
        """Profile vector used to predict for ``name``: the app's own
        default-clock profile, or — when a correlation index is configured —
        the correlated exhaustively-profiled app's vector (paper §III-D).

        Unprofiled apps resolve to ``("cold", name)`` with their static
        embedding when the attached synthesizer has them registered
        (correlation indirection deliberately skipped — the cold tier does
        its own nearest-profiled mapping); otherwise a typed
        :class:`UnknownAppError` is raised."""
        hit = self._resolved.get(name)
        if hit is not None:
            return hit
        feats = (self.app_features or {}).get(name)
        if feats is None:
            synth = self._synthesizer
            if synth is not None and synth.knows(name):
                resolved = (("cold", name), synth.static_features_of(name))
                self._resolved[name] = resolved
                return resolved
            raise UnknownAppError(name, known=self.app_features or ())
        key = ("own", name)
        if self.corr_index is not None and self.corr_features is not None:
            corr_name = self.corr_index.correlated(feats, exclude=name)
            if corr_name in self.corr_features:
                feats = self.corr_features[corr_name]
                key = ("corr", corr_name)
        self._resolved[name] = (key, feats)
        return key, feats

    # ------------------------------------------------------------------ #
    #  Device classes
    # ------------------------------------------------------------------ #
    def register_class(self, device_class: Optional[DeviceClass]
                       ) -> Optional[str]:
        """Normalize a device class to its cache key.

        Returns ``None`` when the class is indistinguishable from the
        service's own dvfs (same ladder, same electrical model, no per-class
        feature overrides) — those classes share the base caches, which is
        what makes a uniform pool of the baseline class bit-identical to the
        classless path. Distinct classes get their own ladder feature matrix
        built once here."""
        if device_class is None:
            return None
        name = device_class.name
        if name in self._class_keys:
            seen = self._seen_class_dvfs[name]
            if seen is not device_class.dvfs and seen != device_class.dvfs:
                raise ValueError(
                    f"conflicting DeviceClass {name!r}: two classes with "
                    "the same name but different DVFS configs")
            return self._class_keys[name]
        self._seen_class_dvfs[name] = device_class.dvfs
        if (device_class.dvfs == self.dvfs
                and name not in self.class_features):
            self._class_keys[name] = None
            return None
        self._class_keys[name] = name
        self._classes[name] = device_class
        clocks = tuple(device_class.dvfs.clock_list())
        self._class_clocks[name] = (
            clocks, [clock_features(c, device_class.dvfs) for c in clocks])
        return name

    def device_class(self, name: Optional[str]) -> Optional[DeviceClass]:
        """The registered class for ``name`` (None for unknown names and
        for classes normalized onto the service's own dvfs)."""
        return self._classes.get(name) if name is not None else None

    def clocks_for(self, class_key: Optional[str]) -> tuple[ClockPair, ...]:
        """The ladder a class's tables are indexed by."""
        if class_key is None:
            return self.clocks
        return self._class_clocks[class_key][0]

    def _class_dvfs(self, class_key: Optional[str]) -> DVFSConfig:
        return (self.dvfs if class_key is None
                else self._classes[class_key].dvfs)

    def _feats_for(self, name: str, class_key: Optional[str]
                   ) -> tuple[tuple, np.ndarray]:
        """Profile vector for ``(app, class)``: the per-class profiling
        campaign when one was supplied, else the shared default-class
        profile (with correlation indirection)."""
        if class_key is not None:
            over = self.class_features.get(class_key)
            if over is not None and name in over:
                return ("cls", class_key, name), over[name]
        return self.resolve(name)

    # ------------------------------------------------------------------ #
    #  Predicted tables
    # ------------------------------------------------------------------ #
    @staticmethod
    def _correction_key(name: str, class_key: Optional[str]) -> str:
        """The key the online layer files corrections under — per app on
        the default class, per (app, class) on explicit classes."""
        return name if class_key is None else f"{name}::{class_key}"

    def base_table(self, name: str,
                   device_class: Optional[DeviceClass] = None) -> ClockTable:
        """Frozen-predictor ladder ``(P, T)`` for ``(app, device class)`` —
        one build per distinct (resolved profile, class), every later call
        a cache hit. Never affected by the online correction layer."""
        ck = self.register_class(device_class)
        feat_key, feats = self._feats_for(name, ck)
        key = (feat_key, ck)
        tab = self._tables.get(key)
        if tab is not None:
            self.stats.table_hits += 1
            return tab
        if feat_key[0] == "cold":
            # cold-start tier: analytic roofline ladder from the attached
            # synthesizer — no predictor rows, same cache-key contract
            clocks = self.clocks_for(ck)
            P, T = self._synthesizer.synthesize(
                name, clocks, self._class_dvfs(ck))
            tab = ClockTable(clocks=clocks, P=P, T=T, source="synthesized")
            self.stats.synthesized_builds += 1
        else:
            tab = self.table_for_features(feats, class_key=ck)
        self._tables[key] = tab
        self.stats.table_builds += 1
        return tab

    def table(self, name: str,
              device_class: Optional[DeviceClass] = None) -> ClockTable:
        """The table scheduling decisions consume: the frozen base table,
        with the attached corrector's current per-(app, class) corrections
        applied (cached until :meth:`invalidate`). Without a corrector this
        *is* :meth:`base_table`."""
        base = self.base_table(name, device_class)
        if self._corrector is None:
            return base
        ck = self.register_class(device_class)
        tab = self._corrected.get((name, ck))
        if tab is not None:
            self.stats.corrected_hits += 1
            return tab
        P, T = self._corrector.correct(self._correction_key(name, ck),
                                       base.clocks, base.P, base.T)
        tab = ClockTable(clocks=base.clocks, P=P, T=T, source="corrected")
        self._corrected[(name, ck)] = tab
        self.stats.corrected_builds += 1
        return tab

    def power_at(self, name: str,
                 device_class: Optional[DeviceClass] = None,
                 clocks: Optional[Sequence[ClockPair]] = None) -> np.ndarray:
        """Predicted power for ``(app, class)`` at ``clocks`` (default: the
        class's full ladder), read from the table the engine's cap filter
        reads: the first call per (app, class) builds it, every later call
        (any clock subset, any order) indexes into it, with no predictor
        call."""
        tab = self.table(name, device_class)
        if clocks is None:
            return tab.P
        ck = self.register_class(device_class)
        index = self._ladder_index.get(ck)
        if index is None:
            index = {c: i for i, c in enumerate(self.clocks_for(ck))}
            self._ladder_index[ck] = index
        rows = np.fromiter((index[c] for c in clocks), dtype=np.intp,
                           count=len(clocks))
        return tab.P[rows]

    # ------------------------------------------------------------------ #
    #  Online correction layer
    # ------------------------------------------------------------------ #
    def attach_corrector(self, corrector) -> None:
        """Attach a correction provider (``correct(name, clocks, P, T) →
        (P', T')``, see :mod:`repro_torch.core.online`). Any previously
        cached corrected views are dropped; base caches are untouched."""
        self._corrector = corrector
        self._corrected.clear()
        self._epoch += 1

    def detach_corrector(self) -> None:
        """Remove the correction layer — the service reverts bit-identically
        to the frozen path."""
        self._corrector = None
        self._corrected.clear()
        self._epoch += 1

    @property
    def corrector(self):
        return self._corrector

    def invalidate(self, name: Optional[str] = None) -> int:
        """Targeted corrected-cache invalidation: drop app ``name``'s
        corrected tables — across every device class — (all apps when
        ``name`` is None) so the next :meth:`table` call re-applies the
        corrector's current correction to the cached base. Returns the
        number of entries dropped. Base tables are pure functions of frozen
        inputs and are deliberately *not* invalidatable."""
        self.stats.invalidations += 1
        self._epoch += 1
        if name is not None and self._synthesizer is not None:
            # observation-driven invalidations are the cold-start
            # promotion clock (cold → warmed); profiled names are a no-op
            self._synthesizer.note_invalidation(name)
        if name is None:
            n = len(self._corrected)
            self._corrected.clear()
            return n
        stale = [k for k in self._corrected if k[0] == name]
        for k in stale:
            del self._corrected[k]
        return len(stale)

    # ------------------------------------------------------------------ #
    #  Cold-start tier
    # ------------------------------------------------------------------ #
    def attach_synthesizer(self, synthesizer) -> None:
        """Attach a cold-start table source (see
        :class:`~repro_torch.core.coldstart.ColdStartSynthesizer`):
        unprofiled apps it registers become resolvable, served analytic
        ``source="synthesized"`` base tables that the correction layer
        refines like any profiled table. Profiled apps are unaffected —
        their resolve path never consults the synthesizer. The
        synthesizer's nearest-profiled index runs on this service's
        device."""
        self._synthesizer = synthesizer
        if synthesizer is not None:
            synthesizer.bind(self)
        self._epoch += 1

    def detach_synthesizer(self) -> None:
        """Remove the cold-start tier. Previously synthesized base tables
        stay cached (they are pure functions of frozen inputs); apps that
        only resolved through the synthesizer become unknown again for
        *new* resolutions."""
        self._synthesizer = None
        self._resolved = {n: v for n, v in self._resolved.items()
                          if v[0][0] != "cold"}
        self._epoch += 1

    @property
    def synthesizer(self):
        return self._synthesizer

    def note_app(self, app: AppProfile) -> bool:
        """Admission-time registration hook (the engine calls this on
        every arrival when a synthesizer is attached): profiled apps are
        a dictionary-membership no-op — the zero-unseen-apps identity —
        while unprofiled ones register their static embedding with the
        synthesizer. Returns True when the app was newly registered."""
        if self._synthesizer is None:
            return False
        if self.app_features is not None and app.name in self.app_features:
            return False
        return self._synthesizer.register(app)

    def table_for_features(self, feats: np.ndarray,
                           class_key: Optional[str] = None) -> ClockTable:
        """Uncached vectorized table build from a raw profile vector, over
        the given class's ladder (default: the service's own)."""
        if class_key is None:
            clocks, clock_X = self.clocks, self._clock_X
        else:
            clocks, clock_X = self._class_clocks[class_key]
        X = np.stack([np.concatenate([feats, cx]) for cx in clock_X])
        P = self._predict(self.predictor.power, X)
        T = self._predict(self.predictor.time, X)
        return ClockTable(clocks=clocks, P=P, T=T, source="predicted")

    # ------------------------------------------------------------------ #
    #  Stacked candidate views + batched prefetch
    # ------------------------------------------------------------------ #
    def stacked_tables(self, name_or_app, device_classes: Sequence,
                       kind: str = "predicted") -> StackedTable:
        """The padded/masked per-(app, class-tuple) view the batched joint
        decision scores in one pass (see :class:`StackedTable`).

        Cache-keyed like the per-app tables — ``(kind, app identity, class
        names)``, where identity is the app *name* for predicted tables and
        the frozen profile for truth tables (the same keying rule as
        :meth:`table` vs :meth:`truth_table`) — LRU-bounded by
        ``stacked_cache_size``, and epoch-validated: any corrector attach/
        detach/:meth:`invalidate` voids cached views lazily. Component rows
        are the *same objects* :meth:`table`/:meth:`truth_table` serve, so
        a consumer can verify row identity in O(classes)."""
        classes = tuple(device_classes)
        key = (kind, name_or_app,
               tuple(c.name if c is not None else None for c in classes))
        entry = self._stacked.get(key)
        if entry is not None and entry[0] == self._epoch:
            self._stacked.move_to_end(key)
            self.stats.stacked_hits += 1
            return entry[1]
        if kind == "truth":
            comps = [self.truth_table(name_or_app, c) for c in classes]
        elif kind == "predicted":
            comps = [self.table(name_or_app, c) for c in classes]
        else:
            raise ValueError(f"unknown stacked-table kind {kind!r}")
        stk = StackedTable.from_tables(comps)
        self._stacked[key] = (self._epoch, stk)
        self._stacked.move_to_end(key)
        while len(self._stacked) > self.stacked_cache_size:
            self._stacked.popitem(last=False)
        self.stats.stacked_builds += 1
        return stk

    def prefetch_tables(self, names: Sequence[str],
                        device_classes: Sequence = (None,)) -> int:
        """Build every missing (app, class) base table in **one** stacked
        predictor call per (class, regressor) — on a card, one kernel
        launch per regressor over n_missing_apps × ladder rows, vs one
        ladder at a time on the lazy path. Row-identical to building tables
        one app at a time (see the rowwise-identity invariant).

        Returns the number of tables built (correlated apps sharing a
        resolved profile count once, exactly like :meth:`base_table`)."""
        built = 0
        for cls in device_classes:
            ck = self.register_class(cls)
            if ck is None:
                clocks, clock_X = self.clocks, self._clock_X
            else:
                clocks, clock_X = self._class_clocks[ck]
            todo: list[tuple[tuple, np.ndarray]] = []
            seen: set = set()
            for name in names:
                feat_key, feats = self._feats_for(name, ck)
                key = (feat_key, ck)
                if key in self._tables or key in seen:
                    continue
                if feat_key[0] == "cold":
                    # synthesized ladders are analytic, not predictor
                    # rows — build individually, keep them out of the
                    # stacked predictor batch
                    self.base_table(name, cls)
                    built += 1
                    continue
                seen.add(key)
                todo.append((key, feats))
            if not todo:
                continue
            L = len(clocks)
            X = np.stack([np.concatenate([feats, cx])
                          for _, feats in todo for cx in clock_X])
            P = self._predict(self.predictor.power, X)
            T = self._predict(self.predictor.time, X)
            for i, (key, _) in enumerate(todo):
                tab = ClockTable(clocks=clocks,
                                 P=P[i * L:(i + 1) * L].copy(),
                                 T=T[i * L:(i + 1) * L].copy(),
                                 source="predicted")
                self._tables[key] = tab
                self.stats.table_builds += 1
                self.stats.prefetched_tables += 1
                built += 1
        return built

    def _predict(self, target, X: np.ndarray) -> np.ndarray:
        """One regressor over a batch, on the service's device."""
        self.stats.rows_predicted += X.shape[0]
        if target.gbdt is not None and self.device.type == "cuda":
            self.stats.kernel_batches += 1
        return target.predict(X)

    # ------------------------------------------------------------------ #
    #  Point predictions (budget-manager inputs)
    # ------------------------------------------------------------------ #
    def _point_time(self, cache: dict, name: str,
                    device_class: Optional[DeviceClass],
                    which: str) -> float:
        ck = self.register_class(device_class)
        val = cache.get((name, ck))
        if val is None:
            d = self._class_dvfs(ck)
            clock = d.max_clock if which == "min" else d.default_clock
            feats = (self.app_features or {}).get(name)
            if feats is None:
                synth = self._synthesizer
                if synth is None or not synth.knows(name):
                    raise UnknownAppError(name,
                                          known=self.app_features or ())
                # cold apps: evaluate the synthesized roofline at the
                # exact max/default clock (which need not be a ladder
                # element) — same formula every table-driven decision sees
                _, T1 = synth.synthesize(name, (clock,), d)
                val = float(T1[0])
                cache[(name, ck)] = val
                return val
            if ck is not None:
                feats = self.class_features.get(ck, {}).get(name, feats)
            x = np.concatenate([feats, clock_features(clock, d)])
            val = float(self._predict(self.predictor.time, x[None])[0])
            cache[(name, ck)] = val
            self.stats.point_predictions += 1
        return val

    def t_min(self, name: str,
              device_class: Optional[DeviceClass] = None) -> float:
        """Predicted max-clock ("sprint") time from the app's own profile."""
        return self._point_time(self._tmin, name, device_class, "min")

    def t_dc(self, name: str,
             device_class: Optional[DeviceClass] = None) -> float:
        """Predicted default-clock time from the app's own profile."""
        return self._point_time(self._tdc, name, device_class, "dc")

    # ------------------------------------------------------------------ #
    #  Ground truth (oracle policy)
    # ------------------------------------------------------------------ #
    def _require_testbed(self) -> Testbed:
        if self.testbed is None:
            raise ValueError(
                "PredictionService needs a testbed for ground-truth queries "
                "(oracle policy / truth-based pacing)")
        return self.testbed

    def truth_table(self, app: AppProfile,
                    device_class: Optional[DeviceClass] = None) -> ClockTable:
        # keyed by the (frozen, hashable) profile itself, NOT app.name: a
        # drifted workload reuses the name with shifted coefficients, and
        # the oracle must see the *current* truth (it is an upper bound).
        ck = self.register_class(device_class)
        tab = self._truth.get((app, ck))
        if tab is not None:
            self.stats.truth_hits += 1
            return tab
        tb = self._require_testbed()
        d = None if ck is None else self._classes[ck].dvfs
        clocks = self.clocks_for(ck)
        T = np.array([tb.true_time(app, c, dvfs=d) for c in clocks])
        P = np.array([tb.true_power(app, c, dvfs=d) for c in clocks])
        tab = ClockTable(clocks=clocks, P=P, T=T, source="truth")
        self._truth[(app, ck)] = tab
        self.stats.truth_builds += 1
        return tab

    def true_t_min(self, app: AppProfile,
                   device_class: Optional[DeviceClass] = None) -> float:
        ck = self.register_class(device_class)
        val = self._true_tmin.get((app, ck))
        if val is None:
            d = self._class_dvfs(ck)
            val = self._require_testbed().true_time(
                app, d.max_clock, dvfs=None if ck is None else d)
            self._true_tmin[(app, ck)] = val
        return val

    def true_t_dc(self, app: AppProfile,
                  device_class: Optional[DeviceClass] = None) -> float:
        ck = self.register_class(device_class)
        val = self._true_tdc.get((app, ck))
        if val is None:
            d = self._class_dvfs(ck)
            val = self._require_testbed().true_time(
                app, d.default_clock, dvfs=None if ck is None else d)
            self._true_tdc[(app, ck)] = val
        return val
