"""Vectorized decision core: compiled selection ladders + cached
measurement substrate for the event engine's hot loop.

Algorithm 1 re-scores the full clock ladder per dispatch decision —
O(clocks) numpy traffic per job even with the prediction tables memoized,
plus two `true_time`/`true_power` evaluations inside ``Testbed.run`` (the
dominant per-job cost at stream scale: each rebuilds a seeded RNG inside
``_wiggle``). Both are pure functions of frozen inputs, so the engine's
batched mode (``EventEngine(batch_decide=True)``, the default) compiles
them once and serves every subsequent decision in O(log clocks):

* **Decision ladders.** For the argmin-energy family (min-energy,
  risk-aware, oracle) the selected clock as a function of the time budget
  is a step function: sort the guarded times once, take the running
  energy-argmin (original-ladder-index tie-break — exactly ``np.argmin``'s
  first-occurrence rule), and each decision is one ``searchsorted``. For
  the paper's d-dvfs scan the whole outcome is determined by the *first
  accepted index* (``maxTime`` tightens to accepted times after that, the
  budget never re-enters), so the ladder precomputes the scan outcome per
  possible first-accept and binary-searches the nonincreasing prefix-min
  of T. Both reproduce the scalar selection bit-for-bit — same floats,
  same tie-breaks.

* **Measurement cache.** ``Testbed.run`` = pure truth × (1 + noise·draw).
  :meth:`DecisionCore.measure` caches the truth pair per (app, dvfs,
  clock) and applies the same two sequential normal draws, preserving the
  engine's determinism invariant (one time + one power draw per dispatch,
  in dispatch order) and therefore the exact RNG stream. Cache keys are
  object identities with the keyed objects pinned, so id reuse after GC
  can never alias a stale entry.

Ladder caches are LRU-bounded and identity-validated (a corrected table
swap gives a new object → new ladder); everything here is bypassed by
``EventEngine(batch_decide=False)``, the retained scalar path that serves
as the bit-identity oracle.

Host numpy on purpose: each decision is a ``searchsorted`` over at most a
few dozen clocks, far below what a device round trip costs.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np

from .policies import (ClockSelection, MinEnergy, Oracle, PaperDDVFS,
                       Policy, RiskAware)
from .prediction_service import ClockTable
from .simulator import Measurement, Testbed

__all__ = ["DecisionCore", "DecisionStats", "LADDER_CACHE_SIZE"]

#: Compiled-ladder LRU bound (per engine). Ladders are keyed by table
#: identity + margin; steady state needs one per (app, class) — 256 covers
#: every workload in the repo with room for corrected-table churn.
LADDER_CACHE_SIZE = 256

#: The "no feasible clock" verdict (frozen dataclass — shareable).
_NONE_SEL = ClockSelection(None)


@dataclasses.dataclass
class DecisionStats:
    ladder_builds: int = 0
    ladder_hits: int = 0
    measure_builds: int = 0       # distinct (app, dvfs, clock) truth evals
    measure_hits: int = 0         # dispatches served from the truth cache
    batched_joint: int = 0        # multi-class decisions scored as a batch
    ladder_joint: int = 0         # multi-class decisions via per-row ladders

    def summary(self) -> str:
        return (f"ladders={self.ladder_builds}"
                f"/{self.ladder_hits}hit "
                f"measure={self.measure_builds}/{self.measure_hits}hit "
                f"joint batched={self.batched_joint} "
                f"ladder={self.ladder_joint}")


class _EnergyLadder:
    """Budget → selection step function for the argmin-energy family.

    Feasible set at budget b is ``{i : T_guard[i] <= b}`` — a prefix of
    the stably-sorted guarded times — and the winner is the feasible entry
    minimizing E with lowest-original-index tie-break (``np.argmin``'s
    first-occurrence rule). One ``searchsorted(side='right')`` per
    decision: count of entries ``<= b``, matching the inclusive scalar
    comparison exactly."""

    __slots__ = ("thresholds", "best", "sels")

    def __init__(self, table: ClockTable, margin: float, oracle: bool):
        T, P = table.T, table.P
        if oracle:
            Tg = T                     # Oracle: no guard, E = T·P
            E = T * P
        else:
            Tg = T * (1.0 + margin)    # MinEnergy/RiskAware: E = P·T
            E = P * T
        order = np.argsort(Tg, kind="stable")
        self.thresholds = Tg[order]
        best = np.empty(len(order), dtype=np.intp)
        bi, be = -1, np.inf
        for k, i in enumerate(order):
            e = E[i]
            if bi < 0 or e < be or (e == be and i < bi):
                bi, be = int(i), e
            best[k] = bi
        self.best = best
        self.sels = [ClockSelection(table.clocks[i], float(P[i]), float(T[i]))
                     for i in range(len(T))]

    def select(self, budget: float) -> ClockSelection:
        k = int(np.searchsorted(self.thresholds, budget, side="right"))
        if k == 0:
            return _NONE_SEL
        return self.sels[self.best[k - 1]]


class _DDVFSLadder:
    """Budget → selection for the paper's sequential d-dvfs scan.

    The scan accepts clock i iff ``P[i] < min_power and T[i] < max_time``
    with ``max_time`` starting at the budget; after the first accept,
    ``max_time`` equals an accepted time and the budget is out of the
    recurrence — so the outcome is a pure function of the first accepted
    index, which is the first i with ``T[i] < budget``. Precompute the
    scan outcome at every possible first-accept (the strict-decrease
    points of T's prefix-min) and binary-search the prefix-min (reversed:
    nondecreasing, ``side='left'`` = count strictly below the budget)."""

    __slots__ = ("rev", "L", "outcomes")

    def __init__(self, table: ClockTable):
        T, P = table.T, table.P
        clocks = table.clocks
        self.L = len(T)
        prefmin = np.minimum.accumulate(T)
        self.rev = prefmin[::-1].copy()
        drop = np.ones(self.L, dtype=bool)
        drop[1:] = prefmin[1:] < prefmin[:-1]
        self.outcomes: dict[int, ClockSelection] = {}
        for i0 in np.nonzero(drop)[0]:
            i0 = int(i0)
            min_p, max_t = P[i0], T[i0]
            best = ClockSelection(clocks[i0], float(P[i0]), float(T[i0]))
            for i in range(i0 + 1, self.L):
                p, t = P[i], T[i]
                if p < min_p and t < max_t:
                    min_p, max_t = p, t
                    best = ClockSelection(clocks[i], float(p), float(t))
            self.outcomes[i0] = best

    def select(self, budget: float) -> ClockSelection:
        c = int(np.searchsorted(self.rev, budget, side="left"))
        if c == 0:
            return _NONE_SEL
        return self.outcomes[self.L - c]


class DecisionCore:
    """Per-engine compiled-decision state: ladder LRU + truth cache."""

    #: Policy types whose scalar selection the ladders reproduce exactly.
    #: Exact-type membership, deliberately: a subclass overriding
    #: ``select_clock`` silently diverges from the compiled form, so it
    #: falls back to the scalar path instead.
    _LADDER_TYPES = (MinEnergy, RiskAware, Oracle, PaperDDVFS)

    def __init__(self, cache_size: int = LADDER_CACHE_SIZE):
        self.stats = DecisionStats()
        self.cache_size = int(cache_size)
        # key (id(table), margin-key) -> (table ref, ladder); the stored
        # strong ref both validates identity and prevents id reuse
        self._ladders: "collections.OrderedDict[tuple, tuple]" = (
            collections.OrderedDict())
        # (id(app), id(dvfs), clock) -> (true_time, true_power), with the
        # keyed objects pinned so ids stay valid for the cache's lifetime
        self._truth: dict[tuple, tuple[float, float]] = {}
        self._pins: list = []

    # ------------------------------------------------------------------ #
    @classmethod
    def compilable(cls, policy: Policy) -> bool:
        """Can this policy's per-class selection be compiled to a ladder?"""
        return type(policy) in cls._LADDER_TYPES

    def select(self, policy: Policy, job, budget: float,
               table: ClockTable) -> ClockSelection:
        """Compiled-ladder equivalent of ``policy.select_for_class(job,
        budget, table)`` for :meth:`compilable` policies. O(log clocks)
        after the first decision per (table, margin)."""
        tp = type(policy)
        if tp is PaperDDVFS:
            mkey: object = "scan"
        elif tp is Oracle:
            mkey = None
        else:
            mkey = policy._margin_for(job)
        key = (id(table), mkey)
        ent = self._ladders.get(key)
        if ent is not None and ent[0] is table:
            self._ladders.move_to_end(key)
            self.stats.ladder_hits += 1
            return ent[1].select(budget)
        if tp is PaperDDVFS:
            ladder = _DDVFSLadder(table)
        else:
            ladder = _EnergyLadder(table, mkey if mkey is not None else 0.0,
                                   oracle=(tp is Oracle))
        self._ladders[key] = (table, ladder)
        self._ladders.move_to_end(key)
        while len(self._ladders) > self.cache_size:
            self._ladders.popitem(last=False)
        self.stats.ladder_builds += 1
        return ladder.select(budget)

    # ------------------------------------------------------------------ #
    def measure(self, testbed: Testbed, app, clock, rng,
                dvfs=None) -> Measurement:
        """Bit-identical ``testbed.run``: cached noiseless truth × the same
        two sequential noise draws (time first, then power — the engine's
        determinism invariant is the draw order, which this preserves)."""
        d = dvfs if dvfs is not None else testbed.dvfs
        key = (id(app), id(d), clock)
        tp = self._truth.get(key)
        if tp is None:
            tp = (testbed.true_time(app, clock, dvfs=dvfs),
                  testbed.true_power(app, clock, dvfs=dvfs))
            self._truth[key] = tp
            self._pins.append((app, d))
            self.stats.measure_builds += 1
        else:
            self.stats.measure_hits += 1
        noise = testbed.noise
        t = tp[0] * (1 + noise * rng.normal())
        p = tp[1] * (1 + noise * rng.normal())
        return Measurement(time_s=max(t, 1e-6), power_w=max(p, 1.0))

    @staticmethod
    def fast_measure_safe(testbed: Testbed) -> bool:
        """True when :meth:`measure` is guaranteed bit-identical to this
        testbed's ``run``: no subclass has re-defined the measurement
        pipeline (a custom ``run``/truth model must go through the real
        thing — the cache would freeze the wrong physics)."""
        t = type(testbed)
        return (t.run is Testbed.run
                and t.true_time is Testbed.true_time
                and t.true_power is Testbed.true_power
                and t._utilizations is Testbed._utilizations)
