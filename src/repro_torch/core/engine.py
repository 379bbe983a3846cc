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
  completion without touching scheduler code;
* a **feedback sink** — an optional object with ``observe(record)`` (e.g.
  :class:`~repro_torch.core.online.OnlineAdapter`) called after every
  completion, closing the measurement loop: observed (energy, time) flows
  back into the prediction layer while the stream is still running.

The loop is host Python over numpy, like the reference's, and reproduces
it decision for decision and RNG draw for RNG draw: the device work of a
run is the prediction tables, built in batched kernel launches when an
admission wave brings apps whose tables are missing, and the online GBDT
corrector's predictions.

Invariants:

* **Determinism.** All stochasticity comes from the single ``seed``-ed RNG
  threaded into the testbed's measurement; one (time, power) draw pair per
  dispatched job, in dispatch order. Anything that preserves the dispatch
  sequence (hooks, feedback sinks that don't change predictions) preserves
  results bit for bit.
* **Frozen-path identity.** With ``feedback=None`` (the default) no
  feedback code runs; an attached
  :class:`~repro_torch.core.online.OnlineAdapter` with ``enabled=False`` —
  or one holding zero observations — is likewise a no-op.
* **Feedback causality.** ``feedback.observe`` is delivered in *simulated*
  completion order, immediately before the first dispatch decision whose
  start time is at or past the record's end (leftovers flush when the
  stream drains). A measurement is therefore never visible to a decision
  that happens earlier in simulated time — even with many devices, where a
  job is *simulated* long before its end time.
* **Power-cap identity.** With ``power_coordinator=None`` (the default)
  no cap code runs; with a coordinator whose cap is infinite, every offer
  is infinite, ladder filtering keeps every clock, and escalation/deferral
  never fire — decisions and the RNG stream are bit-identical to the
  capless engine. A finite cap turns each dispatch into offer → filtered
  selection → (escalate →) dispatch-or-defer → commit; see
  :mod:`repro_torch.core.powercap`.
* **Batched-mode identity.** ``batch_decide=True`` (the default) swaps the
  scalar per-decision scans for the vectorized decision core — compiled
  selection ladders, the stacked joint scorer
  (:meth:`~repro_torch.core.policies.Policy.batch_scores`), batched ladder
  prefetch, and the cached measurement substrate
  (:mod:`repro_torch.core.batch_decide`). Every fast path is gated to the
  exact stock implementation it reproduces (subclassed policies/testbeds
  fall back to the scalar code) and is bit-identical to it.
* **Preemption identity & conservation.** With ``preemption=None`` (the
  default) the plain loop runs untouched; with a
  :class:`~repro_torch.core.preemption.PreemptionManager` whose triggers
  never fire, the segmented loop takes every decision at the same
  simulated time over the same queue with the same RNG stream — records
  are bit-identical (the ``preempt-decline`` golden trace). When rescues
  do fire, one record per *segment* is emitted in dispatch order,
  Σ ``work_frac`` per job is exactly 1, and each record's energy
  decomposes into duration × draw + explicit checkpoint/restore joules;
  see :mod:`repro_torch.core.preemption`.
* **Tier & admission identity.** The EDF queue orders by
  :func:`~repro_torch.core.workload.edf_key` — ``(-tier.priority,
  deadline)`` — so higher tiers dispatch strictly first; with every job in
  a single tier (any tier) the leading component is constant and ordering
  reduces to plain deadline EDF, bit-identically. ``admission=None`` (the
  default) runs zero admission code; an attached
  :class:`~repro_torch.core.admission.AdmissionController` over a stream
  with no sheddable jobs admits everything and is likewise bit-identical.
  When it does fire, every arrival is conserved — executed or listed in
  ``ScheduleResult.shed``, never silently dropped.
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
    #: explicit pool stays ``==``-identical to the classless engine (the
    #: equivalence tests' contract).
    device_class: str | None = dataclasses.field(default=None, compare=False)
    #: Power-cap provenance, None on uncoordinated runs: the watts
    #: the coordinator held for this dispatch (reclaims only shrink a
    #: running grant, so this is the minimum held over the job's life —
    #: which is why a granted-view telemetry ledger never sums above the
    #: cap) and the device's realized peak draw while it ran (constant
    #: per job in the current simulator, so it equals ``power_w`` —
    #: carried separately because *grant vs realized peak* is the
    #: reconciliation the ledger audits). compare=False, like
    #: ``device_class``: with cap=∞ the records stay ``==``-identical to
    #: the capless engine's.
    power_grant_w: float | None = dataclasses.field(default=None,
                                                    compare=False)
    power_peak_w: float | None = dataclasses.field(default=None,
                                                   compare=False)
    #: Preemption provenance — on the non-preemptive path these
    #: keep their defaults, and compare=False keeps a preemptive-but-
    #: never-preempted run ``==``-identical to the plain engine (the
    #: differential harness's contract). One record is one *segment*:
    #: ``work_frac`` is the fraction of the job's work this segment
    #: actually covered (Σ over a job's records is exactly 1),
    #: ``segment`` counts resumes (0 = first dispatch), ``preempted``
    #: marks a truncated segment (its ``preempt_reason`` says which
    #: rescue fired), and ``overhead_s``/``overhead_j`` are the
    #: checkpoint/restore seconds (inside ``time_s``, billed at the
    #: measured draw) and extra joules (inside ``energy_j``) this
    #: segment paid.
    work_frac: float = dataclasses.field(default=1.0, compare=False)
    segment: int = dataclasses.field(default=0, compare=False)
    preempted: bool = dataclasses.field(default=False, compare=False)
    preempt_reason: str | None = dataclasses.field(default=None,
                                                   compare=False)
    overhead_s: float = dataclasses.field(default=0.0, compare=False)
    overhead_j: float = dataclasses.field(default=0.0, compare=False)
    #: SLA-tier provenance: the dispatched job's tier name
    #: ("default" for untagged jobs, None on the legacy monolith).
    #: compare=False like every provenance field — a single-tier run
    #: stays ``==``-identical to the tierless engine regardless of which
    #: tier label the jobs carry.
    tier: str | None = dataclasses.field(default=None, compare=False)
    #: Federation provenance, defaults on non-federated runs:
    #: ``rack`` is the rack index of the dispatching device when the
    #: coordinator or preemption manager knows the rack topology (None
    #: otherwise), and ``migrated`` marks a remnant segment that resumed
    #: on a *different rack* than the one its checkpoint was taken on —
    #: its ``overhead_s``/``overhead_j`` include the checkpoint-transfer
    #: seconds and joules the migration-cost model billed. compare=False,
    #: like every provenance field.
    rack: int | None = dataclasses.field(default=None, compare=False)
    migrated: bool = dataclasses.field(default=False, compare=False)


@dataclasses.dataclass
class ScheduleResult:
    policy: str
    records: list[ExecutionRecord]
    #: Jobs an :class:`~repro_torch.core.admission.AdmissionController` shed
    #: before dispatch. Shed work consumed no energy, produced no
    #: record, and is *not* counted in :attr:`misses` — it is accounted
    #: here explicitly instead. Empty on every admission-free run.
    shed: list[Job] = dataclasses.field(default_factory=list)

    @property
    def total_energy(self) -> float:
        return sum(r.energy_j for r in self.records)

    @property
    def misses(self) -> int:
        """Deadline misses, counted per *job*: a preempted (truncated)
        segment carries no verdict — only the job's final segment does.
        Non-preemptive runs have no truncated records, so this is the
        pre-PR count unchanged."""
        return sum(not r.met_deadline for r in self.records
                   if not r.preempted)

    @property
    def preemptions(self) -> int:
        return sum(r.preempted for r in self.records)

    @property
    def migrations(self) -> int:
        """Cross-rack remnant resumes: segments whose checkpoint
        was taken on one rack and restored on another. Zero on every
        non-federated run — same conservation discipline as
        :attr:`preemptions` (Σ ``work_frac`` per job stays exactly 1 even
        when its segments span racks)."""
        return sum(r.migrated for r in self.records)

    def migrations_by_rack(self) -> dict[int, int]:
        """Cross-rack resumes keyed by *destination* rack index."""
        out: dict[int, int] = {}
        for r in self.records:
            if r.migrated and r.rack is not None:
                out[r.rack] = out.get(r.rack, 0) + 1
        return out

    @property
    def shed_count(self) -> int:
        return len(self.shed)

    def misses_by_tier(self) -> dict[str, int]:
        """Per-tier deadline misses over final (non-preempted) records —
        the SLO-isolation metric. Shed jobs are excluded by construction
        (they have no record); report them via :attr:`shed`."""
        out: dict[str, int] = {}
        for r in self.records:
            if not r.preempted and not r.met_deadline:
                key = r.tier or "default"
                out[key] = out.get(key, 0) + 1
        return out

    def final_records(self) -> list[ExecutionRecord]:
        """One record per job: the segment that ran to completion."""
        return [r for r in self.records if not r.preempted]

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


@dataclasses.dataclass
class _RunningSeg:
    """Preemptive-loop bookkeeping for one in-flight segment: everything
    a boundary decision needs to price the remaining work, plus the
    in-progress record the engine truncates if a rescue fires."""

    job: Job
    record: ExecutionRecord
    dev: int
    device_class: Optional[DeviceClass]
    class_key: Optional[str]
    clock: ClockPair
    exec_start: float          # start + restore overhead: work begins here
    end: float                 # planned completion (truncated on preempt)
    full_time_s: float         # drawn whole-job time at this clock/class
    quantum: Optional[float]
    grant: Optional[float]
    fb_seq: int = -1
    done: bool = False         # finalized (hooks fired, feedback queued)

    def remaining_at(self, t: float) -> float:
        """Unfinished fraction of the *whole job* at time ``t``."""
        prog = max(t - self.exec_start, 0.0) / self.full_time_s
        return max(self.job.work_frac - prog, 0.0)


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
        feedback: Optional[object] = None,
        device_classes: Optional[Sequence[DeviceClass]] = None,
        power_coordinator: Optional[object] = None,
        preemption: Optional[object] = None,
        batch_decide: bool = True,
        admission: Optional[object] = None,
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
        self.feedback = feedback
        #: Optional cluster power-budget coordinator (duck-typed — see
        #: :class:`~repro_torch.core.powercap.PowerCapCoordinator`): consulted
        #: before every dispatch for a per-device power grant that filters
        #: the clock ladder. None (default) is the capless path, untouched.
        self.power_coordinator = power_coordinator
        #: Optional :class:`~repro_torch.core.preemption.PreemptionManager`
        #:: jobs with a ``checkpoint_quantum`` run as segments, the
        #: manager is consulted at every boundary, and a preempted job's
        #: remaining work re-enters the EDF queue as a resumable remnant.
        #: None (default) runs the untouched non-preemptive loop.
        self.preemption = preemption
        #: Optional :class:`~repro_torch.core.admission.AdmissionController`
        #:: consulted for every arrival before it enters the EDF
        #: queue; sheddable-tier work may be deferred or shed under
        #: predicted overload. None (default) runs zero admission code —
        #: bit-identical to the plain engine.
        self.admission = admission
        self.device_clocks: dict[int, Optional[ClockPair]] = {}
        if self.policy.table_kind != "none" and service is None:
            raise ValueError(
                f"policy {self.policy.name!r} needs a PredictionService")
        if (self.policy.table_kind == "predicted"
                and not service.has_predictor):
            raise ValueError(
                f"policy {self.policy.name!r} needs a fitted predictor")
        if self.device_classes is not None and service is not None:
            # register the pool's classes up front: table-free policies
            # (dc/mc) never fetch tables, but a feedback sink still needs
            # the service to resolve each record's class to the right
            # ladder and base table (also surfaces name conflicts early)
            for cls in self.device_classes:
                service.register_class(cls)

        #: Vectorized decision core: compiled selection ladders,
        #: the stacked joint scorer, batched ladder prefetch, and the
        #: cached measurement substrate. On by default — each fast path
        #: is gated (below) to the exact stock implementation it
        #: reproduces, so any subclassed policy/testbed hook silently
        #: falls back to the scalar code; ``batch_decide=False`` disables
        #: everything, and that scalar path is the bit-identity oracle.
        self.batch_decide = bool(batch_decide)
        self._core = DecisionCore()
        pol_t = type(self.policy)
        defaults_ok = (
            pol_t.select_device_clock is Policy.select_device_clock
            and pol_t.class_score is Policy.class_score
            and pol_t.select_for_class is Policy.select_for_class)
        # preemption gates every table-shaped fast path: remnant views are
        # fresh objects per decision, so ladders/stacked views never hit
        base_ok = self.batch_decide and self.preemption is None
        self._ladder_ok = base_ok and DecisionCore.compilable(self.policy)
        self._joint_ladder = self._ladder_ok and defaults_ok
        self._batch_joint = (base_ok and defaults_ok and service is not None
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
        self._held: list[tuple[float, int]] = []
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

    # -- power-cap plumbing ------------------------------------- #
    def _idle_powers(self) -> list[float]:
        """Per-device idle floor, positional — class accessor on explicit
        pools, the testbed's truth-path floor on classless ones."""
        if self.device_classes is not None:
            return [c.idle_power() for c in self.device_classes]
        return [self.testbed.idle_power()] * self.n_devices

    def _t_min_est(self, job: Job,
                   device_class: Optional[DeviceClass] = None
                   ) -> Optional[float]:
        """Whole-job sprint-time estimate, same source hierarchy the
        budget managers use: ground truth for truth-table policies, the
        predictor when fitted, else None. The preemption manager scales
        it to remnant work itself (:meth:`PreemptionManager.scale_t`)."""
        svc = self.service
        if svc is None:
            return None
        if self.policy.table_kind == "truth" and svc.testbed is not None:
            return svc.true_t_min(job.app, device_class)
        if svc.has_predictor:
            return svc.t_min(job.name, device_class)
        return None

    def _coord_t_min_fn(self):
        """``(job, device_class) -> s`` sprint-time estimate for the
        coordinator's slack weights — the same source hierarchy the
        budget managers use: ground truth for truth-table policies, the
        predictor when fitted, else None (the coordinator then weights by
        raw deadline slack). ``device_class`` is the dispatching device's
        class (None for unplaced queue jobs), so on a mixed pool urgency
        is judged against the right ladder. On the preemptive engine the
        estimate is remnant-scaled, so a half-done job's urgency reflects
        its remaining work. The source hierarchy itself lives in
        :meth:`_t_min_est` — one definition for the coordinator's slack
        weights and the preemption manager's queue-rescue trigger."""
        svc = self.service
        if svc is None or not (
                (self.policy.table_kind == "truth"
                 and svc.testbed is not None) or svc.has_predictor):
            return None
        base = lambda j, cls=None: self._t_min_est(j, cls)  # noqa: E731
        if self.preemption is None:
            return base
        pre = self.preemption
        return lambda j, cls=None: pre.scale_t(j, base(j, cls))

    def _planned_power(self, sel, clock: ClockPair, table,
                       dvfs) -> float:
        """Watts the chosen clock is expected to draw — the commit size
        (before guard inflation): the selection's own prediction when it
        backs this clock, else the table row, else the model envelope."""
        if sel.power is not None and sel.clock == clock:
            return float(sel.power)
        if table is not None:
            try:
                return float(table.P[table.clocks.index(clock)])
            except ValueError:
                pass
        return self.policy.model_power(clock, dvfs)

    # -- decision core (shared by the plain and preemptive loops) ------- #
    def _view(self, tab, job: Job):
        """The table a decision looks through: raw for whole jobs, the
        preemption manager's remnant lens (remaining-work scaling +
        restore overhead) for resumable remnants. Identity on the
        non-preemptive path — the object passes through untouched."""
        if self.preemption is None:
            return tab
        return self.preemption.remnant_view(tab, job)

    def _select_class(self, job: Job, budget: float, tab, cdvfs):
        """Per-class clock choice — through the compiled ladder when the
        policy's scalar scan has a compiled form (bit-identical; see
        :mod:`repro_torch.core.batch_decide`), the policy itself otherwise."""
        if self._ladder_ok and tab is not None:
            return self._core.select(self.policy, job, budget, tab)
        return self.policy.select_for_class(job, budget, tab, dvfs=cdvfs)

    def _stacked_for(self, job: Job, cands) -> StackedTable:
        """The stacked (candidate × clock) view backing a batched joint
        decision — served from the service's LRU cache and validated
        row-by-row against the candidates' actual tables (identity, not
        equality: a corrected-table swap must void the batch), with an
        ad-hoc stack as the fallback when any row diverges."""
        kind = self.policy.table_kind
        ident = job.name if kind == "predicted" else job.app
        stk = self.service.stacked_tables(
            ident, tuple(c.device_class for c in cands), kind=kind)
        for t, c in zip(stk.tables, cands):
            if t is not c.table:
                return StackedTable.from_tables([c.table for c in cands])
        return stk

    def _joint_select(self, job: Job, cands):
        """Joint (class, clock) decision on the capless path, fastest
        eligible tier first: one batched feasible-mask → argmin pass when
        the policy vouches for the vectorized form
        (:meth:`~repro_torch.core.policies.Policy.batch_scores`), per-candidate
        compiled ladders under the default ranking otherwise, the scalar
        ``select_device_clock`` loop as the final fallback. All three
        produce the same (index, selection) on the same candidates —
        same floats, same earliest-free/lowest-index tie-breaks."""
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
                orig_free_t: float, free, queue, coord,
                running=None, finalize=None):
        """The joint (device class, clock) decision + cap escalation —
        extracted verbatim from the event loop so the preemptive loop
        reuses it decision-for-decision. May reshuffle ``free`` (losing
        co-free candidates are pushed back untouched). On the preemptive
        loop ``running``/``finalize`` let the candidate gather treat a
        device whose in-flight segment *ends by* ``start`` as co-free
        (finalizing it), exactly as the plain loop's end-timed heap
        entries do, while genuinely busy devices are held back.

        Returns ``(dev, chosen_class, tab, run_dvfs, sel, grant)``."""
        grant = None
        if not self._multi_class:
            chosen_class = (self.device_classes[dev]
                            if self.device_classes is not None else None)
            tab = self._view(self._table_for(job, chosen_class), job)
            cdvfs = None if chosen_class is None else chosen_class.dvfs
            if coord is None:
                sel = self._select_class(job, budget, tab, cdvfs)
                needed = None
            else:
                grant = coord.offer(dev, job, start, queue)
                sel, needed = self.policy.select_capped(
                    job, budget, tab, dvfs=cdvfs, grant=grant,
                    guard=coord.guard)
        else:
            # every device free by `start` could start this job at
            # `start` with the same budget; pop them (ascending
            # (free_time, index) — on the preemptive loop a busy device's
            # entry may be a segment *boundary*, so candidates are
            # re-keyed by their true end and sorted to reproduce the
            # plain heap order) and offer the policy one candidate per
            # distinct class, earliest-free first, pushing the losers
            # back untouched
            others = self._co_free     # scratch, reused across decisions:
            held = self._held          # the gather never outlives the call
            others.clear()
            held.clear()
            while free and free[0][0] <= start:
                t2, dv = heapq.heappop(free)
                seg2 = running.get(dv) if running is not None else None
                if seg2 is not None:
                    if not seg2.done and seg2.end > start + 1e-12:
                        held.append((t2, dv))     # genuinely busy
                        continue
                    finalize(seg2)                # complete by `start`
                    del running[dv]
                    t2 = seg2.end
                others.append((t2, dv))
            for ent in held:
                heapq.heappush(free, ent)
            others.sort()
            others.insert(0, (orig_free_t, dev))
            entries = others
            reps: list[tuple[float, int]] = []
            cands: list[DeviceCandidate] = []
            seen: set[str] = set()
            for ent in entries:
                cls = self.device_classes[ent[1]]
                if cls.name in seen:
                    continue
                seen.add(cls.name)
                reps.append(ent)
                tab_c = self._view(self._table_for(job, cls), job)
                if coord is None:
                    cands.append(DeviceCandidate(cls, budget, tab_c))
                else:
                    cands.append(DeviceCandidate(
                        cls, budget, tab_c,
                        power_cap=coord.offer(ent[1], job, start, queue),
                        guard=coord.guard))
            if coord is None:
                ci, sel = self._joint_select(job, cands)
            else:
                ci, sel = self.policy.select_device_clock(job, cands)
            chosen = reps[ci]
            for ent in entries:
                if ent != chosen:
                    heapq.heappush(free, ent)
            dev = chosen[1]
            chosen_class = self.device_classes[dev]
            tab = cands[ci].table
            cdvfs = chosen_class.dvfs
            needed = None
            if coord is not None:
                # recover the escalation target for the chosen class
                # (select_device_clock discards it) — unconditionally:
                # table-free policies report a rescue need alongside a
                # *feasible* least-overdraw fallback, exactly like the
                # single-class path
                grant = cands[ci].power_cap
                sel, needed = self.policy.select_capped(
                    job, budget, tab, dvfs=cdvfs, grant=grant,
                    guard=coord.guard)

        if (coord is not None and needed is not None
                and needed > grant):
            # deadline rescue: reclaim granted-but-unused headroom
            # and retry with whatever the coordinator can free up
            raised = coord.escalate(dev, needed, start)
            if raised > grant:
                grant = raised
                sel, _ = self.policy.select_capped(
                    job, budget, tab, dvfs=cdvfs, grant=grant,
                    guard=coord.guard)
        return dev, chosen_class, tab, cdvfs, sel, grant

    def _choose_clock(self, sel, tab, run_dvfs, coord, grant):
        """Resolve the final clock (sprint fallback when no clock is
        deadline-feasible — cap-aware under a coordinator) and the
        planned commit watts (None without a coordinator)."""
        d = self.testbed.dvfs
        clock = sel.clock
        if clock is None:
            # sprint at the chosen class's max clock (see scheduler
            # docstring — the engine never drops work); under a cap,
            # sprint as fast as the grant allows instead
            if coord is None:
                clock = (d if run_dvfs is None else run_dvfs).max_clock
            else:
                clock = self.policy.sprint_clock(
                    tab, dvfs=run_dvfs, grant=grant, guard=coord.guard)
        plan_w = None
        if coord is not None:
            plan_w = self._planned_power(
                sel, clock, tab, d if run_dvfs is None else run_dvfs)
        return clock, plan_w

    def run(self, jobs: Iterable[Job]) -> ScheduleResult:
        """Execute the stream to completion; returns per-job records (one
        per *segment* on the preemptive path)."""
        if self.preemption is not None:
            return self._run_preemptive(jobs)
        stream = _ArrivalStream(jobs)
        rng = np.random.default_rng(self.seed)
        for bm in self.budget_managers:
            bm.reset()
        coord = self.power_coordinator
        if coord is not None:
            coord.reset(self._idle_powers(), t_min_fn=self._coord_t_min_fn(),
                        device_classes=self.device_classes)
        # rack provenance: a federation-aware coordinator maps
        # device -> rack; plain coordinators leave records rack-less
        rack_fn = None if coord is None else getattr(coord, "rack_of", None)
        adm = self.admission
        if adm is not None:
            adm.reset(self)
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
        # completions whose simulated end time has not been reached yet —
        # feedback must not see a measurement before it exists in simulated
        # time (on one device that is always the case; with many devices a
        # job can *finish being simulated* long before its end time)
        fb_pending: list[tuple[float, int, ExecutionRecord]] = []
        fb_seq = 0

        def enqueue(j: Job, upto: float) -> None:
            nonlocal counter
            heapq.heappush(queue, (edf_key(j), counter, j))
            counter += 1
            if self._prefetch:
                self._admitted.append(j.name)
            for bm in self.budget_managers:
                bm.on_admit(j)
            if self.hooks.on_admit:
                self.hooks.on_admit(j, upto)

        while not stream.exhausted or queue or (
                adm is not None and adm.n_deferred):
            free_t, dev = heapq.heappop(free)
            # the device's true free time — free_t may be bumped to the
            # next arrival below, and a device that loses the joint
            # decision must rejoin the heap with its *real* availability
            orig_free_t = free_t
            # admit everything that has arrived by the time this device
            # frees up; if the queue is empty, jump to the next arrival
            if not queue:
                if adm is not None and adm.n_deferred:
                    # queue drained: parked work gets a release check at
                    # the device's true free time (forced once the
                    # stream is also done — deferral never strands work)
                    for j in adm.release(free_t, queue,
                                         force=stream.exhausted):
                        enqueue(j, free_t)
                if not queue:
                    if stream.exhausted:
                        break
                    free_t = max(free_t, stream.peek_arrival())
            while not stream.exhausted and stream.peek_arrival() <= free_t:
                job = stream.pop()
                if adm is not None and not adm.check(job, free_t, queue):
                    continue              # shed or parked — never queued
                enqueue(job, free_t)
            if adm is not None and adm.n_deferred:
                for j in adm.release(free_t, queue):
                    enqueue(j, free_t)
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

            bm_snaps = None
            if self.power_coordinator is not None and self.budget_managers:
                # a capped decision may be rolled back (power deferral) —
                # capture manager state before on_pop/apply mutate it
                bm_snaps = [bm.snapshot() for bm in self.budget_managers]
            dl_key, cnt_key, job = heapq.heappop(queue)  # EDF (paper line 5)
            for bm in self.budget_managers:
                bm.on_pop(job)
            start = max(free_t, job.arrival)
            # deliver every measurement completed by this decision's time
            while fb_pending and fb_pending[0][0] <= start + 1e-12:
                self.feedback.observe(heapq.heappop(fb_pending)[2])
            budget = job.deadline - start
            for bm in self.budget_managers:
                budget = bm.apply(job, start, budget)
            if coord is not None:
                # release grants of jobs that ended by this decision —
                # their devices revert to the idle floor
                coord.advance(start)

            dev, chosen_class, tab, run_dvfs, sel, grant = self._decide(
                job, budget, start, dev, orig_free_t, free, queue, coord)
            clock, plan_w = self._choose_clock(sel, tab, run_dvfs, coord,
                                               grant)
            if coord is not None:
                if plan_w * (1 + coord.guard) > grant + 1e-9:
                    # power deferral: not even this clock fits the
                    # cluster's remaining headroom (post-escalation). If a
                    # running grant will release later, wait for it: the
                    # job returns to the EDF queue (original key — order
                    # preserved), the device re-offers at the release, and
                    # the budget managers forget this decision. With no
                    # grant outstanding the cluster is as empty as it gets
                    # — dispatch anyway rather than livelock (commit
                    # clamps; the overage lands in stats.violations).
                    wait_t = coord.next_release(start)
                    if wait_t is not None:
                        if bm_snaps is not None:
                            for bm, snap in zip(self.budget_managers,
                                                bm_snaps):
                                bm.restore(snap)
                        heapq.heappush(queue, (dl_key, cnt_key, job))
                        heapq.heappush(free, (wait_t, dev))
                        continue
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
                power_peak_w=None if coord is None else meas.power_w,
                tier=job.tier.name,
                rack=None if rack_fn is None else rack_fn(dev),
            )
            if coord is not None:
                # the coordinator fills rec.power_grant_w and keeps it in
                # sync when later rescues reclaim part of the grant
                coord.commit(
                    dev, max(plan_w * (1 + coord.guard),
                             coord.idle_of(dev)),
                    end, meas.power_w, record=rec)
            records.append(rec)
            if self.hooks.on_complete:
                self.hooks.on_complete(rec)
            if self.feedback is not None:
                heapq.heappush(fb_pending, (end, fb_seq, rec))
                fb_seq += 1
            heapq.heappush(free, (end, dev))

        while fb_pending:                  # stream drained: flush the rest
            self.feedback.observe(heapq.heappop(fb_pending)[2])
        return ScheduleResult(
            policy=self.policy.name, records=records,
            shed=[] if adm is None else list(adm.shed_jobs))

    # ------------------------------------------------------------------ #
    #  Preemptive (segmented) event loop
    # ------------------------------------------------------------------ #
    def _run_preemptive(self, jobs: Iterable[Job]) -> ScheduleResult:
        """The segmented dispatch loop: a mirror of :meth:`run` in which a
        dispatched job with a ``checkpoint_quantum`` stays *in flight* —
        its device re-enters the event heap at every quantum boundary,
        where the :class:`~repro_torch.core.preemption.PreemptionManager` may
        truncate the segment and re-enqueue the remaining work as a
        resumable remnant. Every decision a boundary never interrupts is
        taken at the same simulated time, over the same queue, with the
        same RNG stream as the plain loop — a run in which every boundary
        declines is bit-identical to :meth:`run` (the differential
        harness's contract).

        Known approximation, inherited from the plain loop's empty-queue
        bump: a free device may jump its decision time to the next
        arrival and dispatch *before* an earlier-timed boundary event of
        a busy device is popped. That boundary is then evaluated late —
        its verdict can see corrected tables already updated with
        measurements that end after ``t_b``. This never affects identity
        (declines are stateless) or conservation; the queue-rescue
        trigger additionally filters to jobs arrived by ``t_b``, so a
        late boundary can never preempt for work from the future."""
        pre = self.preemption
        cfg = pre.config
        stream = _ArrivalStream(jobs)
        rng = np.random.default_rng(self.seed)
        for bm in self.budget_managers:
            bm.reset()
        coord = self.power_coordinator
        if coord is not None:
            coord.reset(self._idle_powers(), t_min_fn=self._coord_t_min_fn(),
                        device_classes=self.device_classes)
        pre.reset()
        # rack provenance: the coordinator's topology wins, the
        # manager's is the fallback (federated manager without a facility
        # coordinator); both absent leaves records rack-less
        rack_fn = ((None if coord is None
                    else getattr(coord, "rack_of", None))
                   or getattr(pre, "rack_of", None))
        adm = self.admission
        if adm is not None:
            adm.reset(self)
        self.device_clocks = {dev: None for dev in range(self.n_devices)}

        free = [(0.0, dev) for dev in range(self.n_devices)]
        heapq.heapify(free)
        queue: list[tuple[tuple, int, Job]] = []
        counter = 0
        records: list[ExecutionRecord] = []
        fb_pending: list[tuple[float, int, ExecutionRecord]] = []
        fb_seq = 0
        running: dict[int, _RunningSeg] = {}
        # devices idled after the stream drained: they re-enter the heap
        # the moment a preemption re-fills the queue with a remnant
        parked: list[int] = []

        def enqueue(j: Job, upto: float) -> None:
            nonlocal counter
            heapq.heappush(queue, (edf_key(j), counter, j))
            counter += 1
            if self._prefetch:
                self._admitted.append(j.name)
            for bm in self.budget_managers:
                bm.on_admit(j)
            if self.hooks.on_admit:
                self.hooks.on_admit(j, upto)

        def admit(upto: float, force_release: bool = False) -> None:
            while not stream.exhausted and stream.peek_arrival() <= upto:
                j = stream.pop()
                if adm is not None and not adm.check(j, upto, queue):
                    continue              # shed or parked — never queued
                enqueue(j, upto)
            if adm is not None and adm.n_deferred:
                for j in adm.release(upto, queue, force=force_release):
                    enqueue(j, upto)
                if queue and parked:      # released work exists again
                    while parked:
                        heapq.heappush(free, (upto, parked.pop()))
            if self._admitted:
                self.service.prefetch_tables(self._admitted,
                                             self._prefetch_classes)
                self._admitted.clear()

        def finalize(seg: _RunningSeg) -> None:
            if seg.done:
                return
            seg.done = True
            if self.hooks.on_complete:
                self.hooks.on_complete(seg.record)
            if self.feedback is not None:
                heapq.heappush(fb_pending,
                               (seg.end, seg.fb_seq, seg.record))

        def drain_fb(t: float) -> None:
            # a segment whose planned end has passed is complete even if
            # its heap event has not popped yet (a bumped decision can
            # jump past it) — finalize so its measurement is deliverable
            # exactly when the plain loop would deliver it
            if self.feedback is None:
                return
            for seg in running.values():
                if not seg.done and seg.end <= t + 1e-12:
                    finalize(seg)
            while fb_pending and fb_pending[0][0] <= t + 1e-12:
                self.feedback.observe(heapq.heappop(fb_pending)[2])

        while not stream.exhausted or queue or running or (
                adm is not None and adm.n_deferred):
            free_t, dev = heapq.heappop(free)
            seg = running.get(dev)
            if seg is not None:
                if free_t < seg.end - 1e-12 and not seg.done:
                    # ---- segment boundary: preempt or continue -------- #
                    t_b = free_t
                    admit(t_b)
                    drain_fb(t_b)
                    if coord is not None:
                        coord.advance(t_b)
                    reason = pre.decide(self, seg, t_b, queue, running)
                    if reason is None:
                        heapq.heappush(
                            free, (min(t_b + seg.quantum, seg.end), dev))
                        continue
                    # truncate the in-flight segment at the boundary and
                    # bill the checkpoint; the remnant re-enters the EDF
                    # queue and the device frees after the checkpoint
                    rec = seg.record
                    rem = seg.remaining_at(t_b)
                    rec.end = t_b + cfg.checkpoint_s
                    rec.time_s = rec.end - rec.start
                    rec.overhead_s += cfg.checkpoint_s
                    rec.overhead_j += cfg.checkpoint_j
                    rec.energy_j = (rec.time_s * rec.power_w
                                    + rec.overhead_j)
                    rec.work_frac = seg.job.work_frac - rem
                    rec.preempted = True
                    rec.preempt_reason = reason
                    rec.met_deadline = rec.end <= rec.deadline + 1e-9
                    seg.end = rec.end
                    pre.stats.preemptions += 1
                    pre.stats.overhead_s += cfg.checkpoint_s
                    pre.stats.overhead_j += cfg.checkpoint_j
                    if coord is not None:
                        # the grant's lease shrinks to the checkpoint —
                        # the watts release at the boundary, not at the
                        # originally committed end
                        coord.truncate(dev, rec.end)
                    remnant = dataclasses.replace(
                        seg.job, work_frac=rem,
                        segment=seg.job.segment + 1)
                    pre.note_preempt(remnant, seg)
                    heapq.heappush(queue,
                                   (edf_key(remnant), counter, remnant))
                    counter += 1
                    for bm in self.budget_managers:
                        bm.on_admit(remnant)
                    while parked:             # remnant work exists again
                        heapq.heappush(free, (t_b, parked.pop()))
                    finalize(seg)
                    del running[dev]
                    # rejoin the event heap at the checkpoint's end
                    # instead of dispatching in place: another device's
                    # event inside the checkpoint window must be
                    # processed first, or a tighter-deadline job could
                    # start late on the wrong device. A federation-aware
                    # manager may instead quarantine a degraded device
                    # (rescue-migration): it never rejoins the heap, so
                    # the remnant must land elsewhere. The base manager
                    # always answers False — identical control flow.
                    if not pre.retire(reason, dev):
                        heapq.heappush(free, (rec.end, dev))
                    continue
                else:
                    # ---- completion (or a stale boundary of a segment
                    # already finalized by an early drain) -------------- #
                    if free_t < seg.end - 1e-12:
                        heapq.heappush(free, (seg.end, dev))
                        continue
                    finalize(seg)
                    del running[dev]
                    free_t = seg.end

            # ---- dispatch path (mirrors the plain loop) --------------- #
            orig_free_t = free_t
            if not queue:
                if stream.exhausted:
                    if adm is not None and adm.n_deferred and not running:
                        # pool drained: force-drain parked work (shed the
                        # doomed, admit the rest — never strand a job)
                        admit(free_t, force_release=True)
                    if not queue:
                        if running:
                            parked.append(dev)
                            continue
                        break
                else:
                    free_t = max(free_t, stream.peek_arrival())
            admit(free_t)
            if not queue:
                heapq.heappush(free, (free_t, dev))
                continue

            bm_snaps = None
            if coord is not None and self.budget_managers:
                bm_snaps = [bm.snapshot() for bm in self.budget_managers]
            dl_key, cnt_key, job = heapq.heappop(queue)   # EDF
            for bm in self.budget_managers:
                bm.on_pop(job)
            start = max(free_t, job.arrival)
            drain_fb(start)
            budget = job.deadline - start
            for bm in self.budget_managers:
                budget = bm.apply(job, start, budget)
            if coord is not None:
                coord.advance(start)

            dev, chosen_class, tab, run_dvfs, sel, grant = self._decide(
                job, budget, start, dev, orig_free_t, free, queue, coord,
                running=running, finalize=finalize)
            clock, plan_w = self._choose_clock(sel, tab, run_dvfs, coord,
                                               grant)
            # straggler mitigation: a federation-aware manager may
            # boost a flagged device's committed clock one ladder rung.
            # The base manager returns `clock` itself — the identity check
            # is on the object, so the untouched path recomputes nothing.
            boosted = pre.mitigate_clock(dev, clock, run_dvfs)
            if boosted is not clock:
                clock = boosted
                if coord is not None:
                    plan_w = self._planned_power(
                        sel, clock, tab,
                        self.testbed.dvfs if run_dvfs is None else run_dvfs)
            if coord is not None:
                if plan_w * (1 + coord.guard) > grant + 1e-9:
                    # power deferral, exactly as in the plain loop
                    wait_t = coord.next_release(start)
                    if wait_t is not None:
                        if bm_snaps is not None:
                            for bm, snap in zip(self.budget_managers,
                                                bm_snaps):
                                bm.restore(snap)
                        heapq.heappush(queue, (dl_key, cnt_key, job))
                        heapq.heappush(free, (wait_t, dev))
                        continue
            if self.hooks.on_dispatch:
                self.hooks.on_dispatch(job, dev, clock, start)
            self.device_clocks[dev] = clock

            meas = self._measure(job.app, clock, rng, run_dvfs)
            restore_s = cfg.restore_s if job.segment > 0 else 0.0
            restore_j = cfg.restore_j if job.segment > 0 else 0.0
            # degradation truth: a degraded device stretches the
            # realized compute time (same draw, more seconds). slow == 1.0
            # (the base manager, and every healthy device) skips the
            # multiply entirely — bit-identical floats.
            full_time = meas.time_s
            slow = pre.slowdown_of(dev)
            if slow != 1.0:
                full_time = meas.time_s * slow
            # cross-rack migration billing: a remnant resuming on
            # a different rack than its checkpoint pays the transfer in
            # seconds (at the device's draw) and explicit joules, folded
            # into the restore overhead. The base manager reports no
            # source rack, so nothing is ever added.
            migrated = False
            if job.segment > 0:
                mig_s, mig_j, src_rack = pre.migration_cost(job, dev)
                if src_rack is not None:
                    migrated = True
                    restore_s += mig_s
                    restore_j += mig_j
            seg_time = job.work_frac * full_time + restore_s
            end = start + seg_time
            # telemetry feed: observed compute seconds (transfer
            # excluded — the monitor must not flag a healthy destination
            # device for its predecessor's migration) vs the prediction.
            pre.note_step(dev, job.work_frac * full_time
                          + (cfg.restore_s if job.segment > 0 else 0.0),
                          sel.time)
            rec = ExecutionRecord(
                job_id=job.job_id, name=job.name, arrival=job.arrival,
                deadline=job.deadline, start=start, end=end, device=dev,
                clock=clock, time_s=seg_time, power_w=meas.power_w,
                energy_j=seg_time * meas.power_w + restore_j,
                predicted_time=sel.time, predicted_power=sel.power,
                met_deadline=end <= job.deadline + 1e-9,
                had_feasible_clock=sel.feasible,
                device_class=(None if chosen_class is None
                              else chosen_class.name),
                power_peak_w=None if coord is None else meas.power_w,
                work_frac=job.work_frac, segment=job.segment,
                overhead_s=restore_s, overhead_j=restore_j,
                tier=job.tier.name,
                rack=None if rack_fn is None else rack_fn(dev),
                migrated=migrated,
            )
            if coord is not None:
                coord.commit(
                    dev, max(plan_w * (1 + coord.guard),
                             coord.idle_of(dev)),
                    end, meas.power_w, record=rec)
            records.append(rec)            # dispatch order, like run()
            if job.segment > 0:
                pre.note_resume(job, rec)
            seg = _RunningSeg(
                job=job, record=rec, dev=dev, device_class=chosen_class,
                class_key=(None if chosen_class is None
                           else chosen_class.name),
                clock=clock, exec_start=start + restore_s, end=end,
                full_time_s=full_time, quantum=pre.quantum_of(job),
                grant=grant)
            if self.feedback is not None:
                seg.fb_seq = fb_seq
                fb_seq += 1
            running[dev] = seg
            first_evt = end
            if (seg.quantum is not None
                    and seg.exec_start + seg.quantum < end - 1e-9):
                first_evt = seg.exec_start + seg.quantum
            heapq.heappush(free, (first_evt, dev))

        for seg in running.values():       # drain in-flight completions
            finalize(seg)
        while fb_pending:
            self.feedback.observe(heapq.heappop(fb_pending)[2])
        return ScheduleResult(
            policy=self.policy.name, records=records,
            shed=[] if adm is None else list(adm.shed_jobs))
