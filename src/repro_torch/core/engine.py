"""Event-driven scheduling core: streaming arrivals, multi-device dispatch.

The reusable heart of the scheduler. The engine owns only *mechanism*:

* an **arrival stream** — jobs come from any iterable, consumed lazily in
  nondecreasing arrival order (a generator works: the engine never asks for
  ``len()`` and never materializes the future);
* a **device pool** — min-heap of ``(free_time, device_index)`` (tie-break
  explicitly on the integer index — deterministic in pool construction
  order, and device/class objects never enter the heap), EDF job queue,
  per-device clock state (``device_clocks``) updated at each dispatch.
  Pools may be **heterogeneous**: pass ``device_classes`` (one
  :class:`~repro_torch.core.dvfs.DeviceClass` per device) and each decision
  becomes a joint *(device class, clock)* choice over every class with a
  device free at the job's start time
  (:meth:`~repro_torch.core.policies.Policy.select_device_clock`); a pool
  with a single distinct class reduces exactly to the classless
  earliest-device path;
* **delegation**: budgets come from the composable
  :class:`~repro_torch.core.policies.BudgetManager` chain, clock choice from
  the :class:`~repro_torch.core.policies.Policy`, predictions from the
  shared :class:`~repro_torch.core.prediction_service.PredictionService`;
* **hooks** (:class:`EngineHooks`) for tracing every admit / dispatch /
  completion without touching scheduler code.

The loop is host Python over numpy, like the reference's: the device work
of a run is the prediction tables, built in batched kernel launches when
an admission wave brings apps whose tables are missing.

Invariants:

* **Determinism.** All stochasticity comes from the single ``seed``-ed RNG
  threaded into the testbed's measurement; one (time, power) draw pair per
  dispatched job, in dispatch order. Anything that preserves the dispatch
  sequence (hooks) preserves results bit for bit.
* **Batched-mode identity.** ``batch_decide=True`` (the default) swaps the
  scalar per-decision scans for the vectorized decision core — compiled
  selection ladders, the stacked joint scorer
  (:meth:`~repro_torch.core.policies.Policy.batch_scores`), batched ladder
  prefetch, and the cached measurement substrate
  (:mod:`repro_torch.core.batch_decide`). Every fast path is gated to the
  exact stock implementation it reproduces (subclassed policies/testbeds
  fall back to the scalar code) and is bit-identical to it.

This is the reference's non-preemptive loop. Its preemptive loop and its
admission, power-cap and measurement-feedback paths are ported with
ROADMAP §1.7–§1.8; :func:`~repro_torch.core.scheduler.run_schedule`
refuses those options until then.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

from .batch_decide import DecisionCore
from .dvfs import ClockPair, DeviceClass
from .policies import (BudgetManager, DeviceCandidate, Policy,
                       resolve_policy)
from .prediction_service import PredictionService, StackedTable
from .simulator import Testbed
from .workload import Job, edf_key

__all__ = ["ExecutionRecord", "ScheduleResult", "EngineHooks", "EventEngine"]


@dataclasses.dataclass
class ExecutionRecord:
    job_id: int
    name: str
    arrival: float
    deadline: float
    start: float
    end: float
    device: int
    clock: ClockPair
    time_s: float
    power_w: float
    energy_j: float
    predicted_time: float | None
    predicted_power: float | None
    met_deadline: bool
    had_feasible_clock: bool
    #: Device-class name for explicit pools, None on the classless path.
    #: compare=False: the label is provenance, not behavior — a uniform
    #: explicit pool stays ``==``-identical to the classless engine.
    device_class: str | None = dataclasses.field(default=None, compare=False)
    #: SLA-tier provenance: the dispatched job's tier name ("default" for
    #: untagged jobs, None on the legacy monolith). compare=False like
    #: every provenance field.
    tier: str | None = dataclasses.field(default=None, compare=False)


@dataclasses.dataclass
class ScheduleResult:
    policy: str
    records: list[ExecutionRecord]

    @property
    def total_energy(self) -> float:
        return sum(r.energy_j for r in self.records)

    @property
    def misses(self) -> int:
        """Deadline misses, counted per job."""
        return sum(not r.met_deadline for r in self.records)

    @property
    def makespan(self) -> float:
        return max((r.end for r in self.records), default=0.0)

    def energy_by_app(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for r in self.records:
            out[r.name] = out.get(r.name, 0.0) + r.energy_j
        return out


@dataclasses.dataclass
class EngineHooks:
    """Optional per-event callbacks (tracing / live dashboards)."""

    on_admit: Optional[Callable[[Job, float], None]] = None
    on_dispatch: Optional[Callable[[Job, int, ClockPair, float], None]] = None
    on_complete: Optional[Callable[[ExecutionRecord], None]] = None


class _ArrivalStream:
    """One-item-lookahead wrapper over a job iterable.

    Lists/tuples are sorted by arrival (legacy behavior); any other iterable
    is consumed lazily and must already be in nondecreasing arrival order
    (checked as it streams)."""

    def __init__(self, jobs: Iterable[Job]):
        if isinstance(jobs, (list, tuple)):
            self._it: Iterator[Job] = iter(
                sorted(jobs, key=lambda j: j.arrival))
        else:
            self._it = iter(jobs)
        self._last_arrival = -np.inf
        self._head: Optional[Job] = next(self._it, None)

    @property
    def exhausted(self) -> bool:
        return self._head is None

    def peek_arrival(self) -> float:
        return self._head.arrival

    def pop(self) -> Job:
        job = self._head
        if job.arrival < self._last_arrival:
            raise ValueError(
                f"job stream out of order: arrival {job.arrival} after "
                f"{self._last_arrival}")
        self._last_arrival = job.arrival
        self._head = next(self._it, None)
        return job


class EventEngine:
    """Composable event-driven scheduler.

    Example::

        service = PredictionService(testbed.dvfs, predictor, app_features,
                                    testbed=testbed)
        engine = EventEngine(testbed, MinEnergy(testbed.dvfs),
                             service=service, n_devices=8)
        result = engine.run(stream_workload(apps, testbed, n_jobs=1000))
    """

    def __init__(
        self,
        testbed: Testbed,
        policy: str | Policy,
        service: Optional[PredictionService] = None,
        n_devices: int = 1,
        budget_managers: Sequence[BudgetManager] = (),
        hooks: Optional[EngineHooks] = None,
        seed: int = 0,
        device_classes: Optional[Sequence[DeviceClass]] = None,
        batch_decide: bool = True,
    ):
        self.testbed = testbed
        self.policy = resolve_policy(policy, testbed.dvfs)
        self.service = service
        #: Explicit pool: one DeviceClass per device, positional — the
        #: device index IS the list position, and the free-heap tie-break
        #: is on that index (never on class objects), so dispatch order is
        #: deterministic in pool construction order. None = classless
        #: uniform pool of ``n_devices`` testbed-dvfs devices (legacy).
        self.device_classes = (None if device_classes is None
                               else list(device_classes))
        if self.device_classes is not None:
            if not self.device_classes:
                raise ValueError("device_classes must not be empty")
            self.n_devices = len(self.device_classes)
        else:
            self.n_devices = int(n_devices)
        self._multi_class = (
            self.device_classes is not None
            and len({c.name for c in self.device_classes}) > 1)
        self.budget_managers = list(budget_managers)
        self.hooks = hooks or EngineHooks()
        self.seed = seed
        self.device_clocks: dict[int, Optional[ClockPair]] = {}
        if self.policy.table_kind != "none" and service is None:
            raise ValueError(
                f"policy {self.policy.name!r} needs a PredictionService")
        if (self.policy.table_kind == "predicted"
                and not service.has_predictor):
            raise ValueError(
                f"policy {self.policy.name!r} needs a fitted predictor")
        if self.device_classes is not None and service is not None:
            # register the pool's classes up front (surfaces name
            # conflicts before the first decision)
            for cls in self.device_classes:
                service.register_class(cls)

        #: Vectorized decision core: compiled selection ladders, the
        #: stacked joint scorer, batched ladder prefetch, and the cached
        #: measurement substrate. On by default — each fast path is gated
        #: (below) to the exact stock implementation it reproduces, so any
        #: subclassed policy/testbed falls back to the scalar code;
        #: ``batch_decide=False`` disables everything, and that scalar path
        #: is the bit-identity oracle.
        self.batch_decide = bool(batch_decide)
        self._core = DecisionCore()
        pol_t = type(self.policy)
        defaults_ok = (
            pol_t.select_device_clock is Policy.select_device_clock
            and pol_t.class_score is Policy.class_score
            and pol_t.select_for_class is Policy.select_for_class)
        self._ladder_ok = (self.batch_decide
                           and DecisionCore.compilable(self.policy))
        self._joint_ladder = self._ladder_ok and defaults_ok
        self._batch_joint = (self.batch_decide and defaults_ok
                             and service is not None
                             and getattr(self.policy, "batchable", False))
        self._fast_measure = (self.batch_decide
                              and DecisionCore.fast_measure_safe(testbed))
        self._prefetch = (self.batch_decide and service is not None
                          and self.policy.table_kind == "predicted"
                          and service.has_predictor)
        if self._prefetch and self.device_classes is not None:
            self._prefetch_classes: tuple = tuple(
                {c.name: c for c in self.device_classes}.values())
        else:
            self._prefetch_classes = (None,)
        # scratch lists reused across decisions by the multi-class
        # candidate gather and the admit-time prefetch (see _decide)
        self._co_free: list[tuple[float, int]] = []
        self._admitted: list[str] = []

    @property
    def decision_stats(self):
        """Vectorized-core counters (ladder/measure cache hits, batched
        joint decisions) — see :class:`~repro_torch.core.batch_decide.
        DecisionStats`."""
        return self._core.stats

    # ------------------------------------------------------------------ #
    def _table_for(self, job: Job,
                   device_class: Optional[DeviceClass] = None):
        kind = self.policy.table_kind
        if kind == "predicted":
            return self.service.table(job.name, device_class)
        if kind == "truth":
            return self.service.truth_table(job.app, device_class)
        return None

    def _select_class(self, job: Job, budget: float, tab, cdvfs):
        """Per-class clock choice — through the compiled ladder when the
        policy's scalar scan has a compiled form (bit-identical; see
        :mod:`repro_torch.core.batch_decide`), the policy itself
        otherwise."""
        if self._ladder_ok and tab is not None:
            return self._core.select(self.policy, job, budget, tab)
        return self.policy.select_for_class(job, budget, tab, dvfs=cdvfs)

    def _stacked_for(self, job: Job, cands) -> StackedTable:
        """The stacked (candidate × clock) view backing a batched joint
        decision — served from the service's LRU cache and validated
        row-by-row against the candidates' actual tables (identity, not
        equality), with an ad-hoc stack as the fallback when any row
        diverges."""
        kind = self.policy.table_kind
        ident = job.name if kind == "predicted" else job.app
        stk = self.service.stacked_tables(
            ident, tuple(c.device_class for c in cands), kind=kind)
        for t, c in zip(stk.tables, cands):
            if t is not c.table:
                return StackedTable.from_tables([c.table for c in cands])
        return stk

    def _joint_select(self, job: Job, cands):
        """Joint (class, clock) decision, fastest eligible tier first: one
        batched feasible-mask → argmin pass when the policy vouches for the
        vectorized form (:meth:`~repro_torch.core.policies.Policy.
        batch_scores`), per-candidate compiled ladders under the default
        ranking otherwise, the scalar ``select_device_clock`` loop as the
        final fallback. All three produce the same (index, selection) on
        the same candidates — same floats, same earliest-free/lowest-index
        tie-breaks."""
        if self._batch_joint and len(cands) > 1:
            out = self.policy.batch_scores(
                job, cands[0].budget, self._stacked_for(job, cands))
            if out is not None:
                self._core.stats.batched_joint += 1
                return out
        if self._joint_ladder:
            best_i, best_sel, best_score = 0, None, None
            for i, cand in enumerate(cands):
                sel = self._select_class(job, cand.budget, cand.table,
                                         cand.dvfs)
                score = self.policy.class_score(job, cand, sel)
                if best_sel is None or score < best_score:
                    best_i, best_sel, best_score = i, sel, score
            self._core.stats.ladder_joint += 1
            return best_i, best_sel
        return self.policy.select_device_clock(job, cands)

    def _measure(self, app, clock, rng, run_dvfs):
        """One dispatch measurement: the cached-truth fast path when the
        testbed is the stock simulator (bit-identical — the same two
        sequential noise draws on the same RNG stream), the testbed's own
        ``run`` for any subclass that redefines the physics."""
        if self._fast_measure:
            return self._core.measure(self.testbed, app, clock, rng,
                                      dvfs=run_dvfs)
        return self.testbed.run(app, clock, rng=rng, dvfs=run_dvfs)

    def _decide(self, job: Job, budget: float, start: float, dev: int,
                orig_free_t: float, free):
        """The joint (device class, clock) decision. May reshuffle ``free``
        (losing co-free candidates are pushed back untouched).

        Returns ``(dev, chosen_class, run_dvfs, sel)``."""
        if not self._multi_class:
            chosen_class = (self.device_classes[dev]
                            if self.device_classes is not None else None)
            tab = self._table_for(job, chosen_class)
            cdvfs = None if chosen_class is None else chosen_class.dvfs
            return dev, chosen_class, cdvfs, self._select_class(
                job, budget, tab, cdvfs)
        # every device free by `start` could start this job at `start`
        # with the same budget; pop them (ascending (free_time, index))
        # and offer the policy one candidate per distinct class,
        # earliest-free first, pushing the losers back untouched
        entries = self._co_free    # scratch, reused across decisions
        entries.clear()
        entries.append((orig_free_t, dev))
        while free and free[0][0] <= start:
            entries.append(heapq.heappop(free))
        reps: list[tuple[float, int]] = []
        cands: list[DeviceCandidate] = []
        seen: set[str] = set()
        for ent in entries:
            cls = self.device_classes[ent[1]]
            if cls.name in seen:
                continue
            seen.add(cls.name)
            reps.append(ent)
            cands.append(DeviceCandidate(cls, budget,
                                         self._table_for(job, cls)))
        ci, sel = self._joint_select(job, cands)
        chosen = reps[ci]
        for ent in entries:
            if ent != chosen:
                heapq.heappush(free, ent)
        chosen_class = self.device_classes[chosen[1]]
        return chosen[1], chosen_class, chosen_class.dvfs, sel

    def run(self, jobs: Iterable[Job]) -> ScheduleResult:
        """Execute the stream to completion; returns per-job records in
        dispatch order."""
        stream = _ArrivalStream(jobs)
        rng = np.random.default_rng(self.seed)
        for bm in self.budget_managers:
            bm.reset()
        self.device_clocks = {dev: None for dev in range(self.n_devices)}

        # free-heap entries are always (free_time, device_index) — the
        # tie-break on equal free times is explicitly the integer device
        # index (list position for explicit pools), never a device or
        # class object: total order, deterministic in construction order
        free = [(0.0, dev) for dev in range(self.n_devices)]
        heapq.heapify(free)
        # (edf_key, tiebreak, job): tier-priority-then-deadline order —
        # reduces to plain EDF whenever every job shares one tier
        queue: list[tuple[tuple, int, Job]] = []
        counter = 0
        records: list[ExecutionRecord] = []

        while not stream.exhausted or queue:
            free_t, dev = heapq.heappop(free)
            # the device's true free time — free_t may be bumped to the
            # next arrival below, and a device that loses the joint
            # decision must rejoin the heap with its *real* availability
            orig_free_t = free_t
            # admit everything that has arrived by the time this device
            # frees up; if the queue is empty, jump to the next arrival
            if not queue:
                if stream.exhausted:
                    break
                free_t = max(free_t, stream.peek_arrival())
            while not stream.exhausted and stream.peek_arrival() <= free_t:
                job = stream.pop()
                heapq.heappush(queue, (edf_key(job), counter, job))
                counter += 1
                if self._prefetch:
                    self._admitted.append(job.name)
                for bm in self.budget_managers:
                    bm.on_admit(job)
                if self.hooks.on_admit:
                    self.hooks.on_admit(job, free_t)
            if self._admitted:
                # batched ladder prefetch: every missing (app, class) table
                # for this admission wave in one stacked predictor call
                # per regressor — one kernel launch each on a card
                self.service.prefetch_tables(self._admitted,
                                             self._prefetch_classes)
                self._admitted.clear()
            if not queue:
                heapq.heappush(free, (free_t, dev))
                continue

            _, _, job = heapq.heappop(queue)  # EDF (paper line 5)
            for bm in self.budget_managers:
                bm.on_pop(job)
            start = max(free_t, job.arrival)
            budget = job.deadline - start
            for bm in self.budget_managers:
                budget = bm.apply(job, start, budget)

            dev, chosen_class, run_dvfs, sel = self._decide(
                job, budget, start, dev, orig_free_t, free)
            clock = sel.clock
            if clock is None:
                # no deadline-feasible clock: sprint at the chosen class's
                # max clock (see scheduler docstring — the engine never
                # drops work)
                clock = (self.testbed.dvfs if run_dvfs is None
                         else run_dvfs).max_clock
            if self.hooks.on_dispatch:
                self.hooks.on_dispatch(job, dev, clock, start)
            self.device_clocks[dev] = clock

            meas = self._measure(job.app, clock, rng, run_dvfs)
            end = start + meas.time_s
            rec = ExecutionRecord(
                job_id=job.job_id, name=job.name, arrival=job.arrival,
                deadline=job.deadline, start=start, end=end, device=dev,
                clock=clock, time_s=meas.time_s, power_w=meas.power_w,
                energy_j=meas.energy_j, predicted_time=sel.time,
                predicted_power=sel.power,
                met_deadline=end <= job.deadline + 1e-9,
                had_feasible_clock=sel.feasible,
                device_class=(None if chosen_class is None
                              else chosen_class.name),
                tier=job.tier.name,
            )
            records.append(rec)
            if self.hooks.on_complete:
                self.hooks.on_complete(rec)
            heapq.heappush(free, (end, dev))

        return ScheduleResult(policy=self.policy.name, records=records)
