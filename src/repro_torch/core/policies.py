"""Pluggable clock-selection policies + composable budget managers.

The monolithic if/elif dispatch in the original ``run_schedule`` becomes a
registry of :class:`Policy` objects, each implementing one method::

    select_clock(job, budget, table) -> ClockSelection

``table`` is the :class:`~repro_torch.core.prediction_service.ClockTable`
the policy declared it needs (``table_kind``: predicted ladder table, ground
truth, or none) — policies never call the predictor themselves, so every
policy automatically benefits from the service's memoization, and new
policies are one small class, not another elif arm.

Budget shaping (how much of the wall clock a job may consume) is factored
out of the policies into :class:`BudgetManager` components that observe
queue admissions/removals and cap the budget at decision time:

* :class:`QueueAwareBudget` — the beyond-paper backlog guard: job *i*'s
  budget is capped by every queued job *j*'s deadline minus the sprint
  (max-clock) time of jobs ahead of it. The original implementation
  re-sorted the whole queue and re-predicted ``t_min`` per decision; this
  one maintains an EDF-ordered list incrementally (bisect insert/remove)
  with ``t_min`` attached once at admission.
* :class:`VirtualPacingBudget` — the virtual default-clock pacing guard
  protecting future arrivals (see scheduler module docstring for the math).

Both produce budgets identical to the legacy path (the executable spec
:func:`~repro_torch.core.scheduler.legacy_run_schedule`).

**Extending the registry** — the recipe the registry contract guarantees:

1. subclass :class:`Policy`, set a unique ``name`` and the ``table_kind``
   you need (``"predicted"`` / ``"truth"`` / ``"none"``);
2. implement ``select_clock(job, budget, table)`` returning a
   :class:`ClockSelection` (``clock=None`` means "no feasible clock" — the
   engine sprints at max clock and flags the job, it never drops work);
3. add the class to :data:`POLICIES` (statically below, or by mutating the
   dict at runtime for experiments). ``resolve_policy`` and the engine pick
   it up by name; nothing else needs changing.

**Heterogeneous pools.** On a mixed pool the decision is *joint*:
which device class AND which clock. ``select_device_clock(job, candidates)``
receives one :class:`DeviceCandidate` per distinct class with a device free
at the job's start (earliest-free first), runs the per-class choice
``select_for_class`` (default: ``select_clock`` on that class's table;
dc/mc override to read the class's fixed clock), and ranks candidates with
``class_score`` — feasible-first, then predicted energy, ties to the
earliest-free candidate. A uniform pool therefore produces exactly the
classless decision, which is the refactor's safety rail; new policies get
class-awareness for free and override ``class_score``/``select_device_clock``
only for custom placement logic.

**Power-capped pools.** When the engine runs under a
:class:`~repro_torch.core.powercap.PowerCapCoordinator`, each decision
carries a per-device power grant: ``select_capped`` filters the clock
ladder to clocks whose predicted draw (inflated by the coordinator's
``guard``) fits the grant and runs the normal selection on the filtered
ladder — feasible-first among fitting clocks — reporting the watts a
deadline-rescue escalation would need when the grant alone blocks a
feasible clock. ``sprint_clock`` is the cap-aware stand-in for the sprint
fallback. A ``None``/infinite grant short-circuits to the capless path
bit-identically.

Invariants: policies are stateless between jobs (all cross-job state lives
in budget managers or the prediction service); they never call the
predictor directly — the ``table`` argument is their only view of
predictions, which is what lets the online correction layer transparently
upgrade every predictive policy at once. :class:`RiskAware` additionally
accepts a per-app ``margin_fn`` (e.g. ``OnlineAdapter.margin``) so its
deadline insurance scales with *observed* residual variance instead of a
fixed guess.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from .dvfs import ClockPair, DeviceClass, DVFSConfig
from .prediction_service import ClockTable
from .workload import Job

__all__ = [
    "ClockSelection",
    "DeviceCandidate",
    "Policy",
    "DefaultClock",
    "MaxClock",
    "PaperDDVFS",
    "MinEnergy",
    "RiskAware",
    "Oracle",
    "POLICIES",
    "POLICY_NAMES",
    "resolve_policy",
    "BudgetManager",
    "QueueAwareBudget",
    "VirtualPacingBudget",
]


@dataclasses.dataclass(frozen=True)
class ClockSelection:
    """A policy's verdict for one job: the clock to run at (None = no
    feasible clock; the engine sprints at max clock and flags the job),
    plus the predictions backing the choice (None for non-predictive
    policies)."""

    clock: Optional[ClockPair]
    power: Optional[float] = None
    time: Optional[float] = None

    @property
    def feasible(self) -> bool:
        return self.clock is not None


@dataclasses.dataclass(frozen=True)
class DeviceCandidate:
    """One placement option in a joint (device, clock) decision: a device
    class with at least one device free at the job's start time, its time
    budget there (identical across candidates — all are free by the start),
    and the class's prediction table (None for table-free policies).

    On a power-capped pool the engine additionally attaches the
    coordinator's offered grant (``power_cap``, total device watts) and
    the ``guard`` inflation factor; the joint decision then filters each
    candidate's ladder to clocks fitting its grant
    (:meth:`Policy.select_capped`). ``power_cap=None`` (or ``inf``) is the
    capless path, bit-identical to pre-cap behavior."""

    device_class: DeviceClass
    budget: float
    table: Optional[ClockTable]
    power_cap: Optional[float] = None
    guard: float = 0.0

    @property
    def dvfs(self) -> DVFSConfig:
        return self.device_class.dvfs


class Policy:
    """Base class: stateless clock-selection strategy.

    ``table_kind`` declares the input the engine must fetch from the
    prediction service: ``"predicted"`` (learned-model ladder table, with
    correlation indirection), ``"truth"`` (ground-truth sweep — oracle
    only), or ``"none"``.
    """

    name: str = ""
    table_kind: str = "none"
    #: Whether :meth:`batch_scores`'s vectorized feasible-mask →
    #: energy-argmin reformulation reproduces this policy's
    #: ``select_for_class``/``class_score`` semantics exactly. Deliberately
    #: opt-in (False here, True on the argmin-energy family): a subclass
    #: with a custom ``select_clock`` scan is not batchable unless it says
    #: so, and the engine falls back to the scalar path — never a silent
    #: behavior change.
    batchable: bool = False

    def __init__(self, dvfs: DVFSConfig):
        self.dvfs = dvfs

    def select_clock(self, job: Job, budget: float,
                     table: Optional[ClockTable]) -> ClockSelection:
        raise NotImplementedError

    def _margin_for(self, job: Job) -> float:
        """Deadline-guard inflation on predicted times (0 by default;
        :class:`MinEnergy`/:class:`RiskAware` override). The one hook the
        batched scorer needs to reproduce ``T_guard = T * (1 + margin)``."""
        return 0.0

    # -- heterogeneous pools ------------------------------------------- #
    def select_for_class(self, job: Job, budget: float,
                         table: Optional[ClockTable],
                         dvfs: Optional[DVFSConfig] = None) -> ClockSelection:
        """Per-device-class clock choice. Table-driven policies are
        class-agnostic (the class is baked into the table they are handed),
        so the default delegates to :meth:`select_clock`; fixed-clock
        policies override to read the *class's* default/max clock."""
        return self.select_clock(job, budget, table)

    # -- power-capped pools --------------------------------------------- #
    def model_power(self, clock: ClockPair,
                    dvfs: Optional[DVFSConfig] = None) -> float:
        """Upper-envelope draw for a clock with no prediction available
        (table-free policies): the class power model at full utilization.
        True power is gated by utilization ≤ 1, so this bounds the
        utilization terms; the cap filter's ``guard`` absorbs the
        simulator's wiggle/noise on top."""
        d = dvfs or self.dvfs
        return d.power(clock, 1.0, 1.0)

    def _fastest_fitting(self, d: DVFSConfig, grant: float,
                         guard: float) -> Optional[ClockPair]:
        """Fastest ladder clock whose model-envelope draw (inflated by
        ``guard``) fits ``grant``; None when nothing fits. The single
        fitting rule shared by the table-free branches of
        :meth:`select_capped` and :meth:`sprint_clock`."""
        fitting = [c for c in d.clock_list()
                   if self.model_power(c, d) * (1 + guard) <= grant + 1e-12]
        if not fitting:
            return None
        return max(fitting, key=lambda c: (c.s_core, c.s_mem))

    def _cheapest_clock(self, d: DVFSConfig) -> ClockPair:
        """Least-overdraw ladder clock by model envelope."""
        return min(d.clock_list(), key=lambda c: self.model_power(c, d))

    def select_capped(
        self, job: Job, budget: float, table: Optional[ClockTable],
        dvfs: Optional[DVFSConfig] = None,
        grant: Optional[float] = None, guard: float = 0.0,
    ) -> tuple[ClockSelection, Optional[float]]:
        """Cap-aware per-class choice: filter the ladder to clocks whose
        predicted power (inflated by ``guard``) fits the ``grant``, then
        run the normal :meth:`select_for_class` on the filtered ladder —
        feasible-first among fitting clocks, exactly the capless ranking
        restricted to the grant.

        Returns ``(selection, needed_w)``. ``needed_w`` is non-None when
        the grant is the *only* thing blocking a deadline-feasible clock:
        the total watts a deadline-rescue escalation would need to
        deliver. With ``grant`` None/∞ this is exactly
        ``(select_for_class(...), None)`` — the cap=∞ identity lever."""
        if grant is None or not np.isfinite(grant):
            return self.select_for_class(job, budget, table, dvfs=dvfs), None
        d = dvfs or self.dvfs
        lim = grant + 1e-12
        if table is None:
            sel = self.select_for_class(job, budget, table, dvfs=dvfs)
            if sel.clock is None:
                return sel, None
            if self.model_power(sel.clock, d) * (1 + guard) <= lim:
                return sel, None
            # the fixed clock overdraws the grant: fall back to the
            # fastest ladder clock that fits
            best = self._fastest_fitting(d, grant, guard)
            if best is not None:
                return ClockSelection(best), None
            # nothing fits at all: run least-overdraw, ask for a rescue
            # sized to the policy's own fixed clock
            return (ClockSelection(self._cheapest_clock(d)),
                    self.model_power(sel.clock, d) * (1 + guard))
        fit = np.asarray(table.P) * (1 + guard) <= lim
        if fit.all():
            return self.select_for_class(job, budget, table, dvfs=dvfs), None
        if not fit.any():
            # grant below even the cheapest clock: escalation target is
            # the uncapped choice when feasible, else the cheapest clock
            sel_unc = self.select_for_class(job, budget, table, dvfs=dvfs)
            needed = (sel_unc.power if sel_unc.feasible
                      and sel_unc.power is not None
                      else float(np.min(table.P)))
            return ClockSelection(None), float(needed) * (1 + guard)
        sub = ClockTable(
            clocks=tuple(c for c, m in zip(table.clocks, fit) if m),
            P=table.P[fit], T=table.T[fit], source=table.source)
        sel = self.select_for_class(job, budget, sub, dvfs=dvfs)
        if sel.feasible:
            return sel, None
        sel_unc = self.select_for_class(job, budget, table, dvfs=dvfs)
        if sel_unc.feasible:
            needed = (sel_unc.power if sel_unc.power is not None
                      else float(np.min(table.P)))
            return sel, float(needed) * (1 + guard)
        return sel, None

    def sprint_clock(
        self, table: Optional[ClockTable],
        dvfs: Optional[DVFSConfig] = None,
        grant: Optional[float] = None, guard: float = 0.0,
    ) -> ClockPair:
        """Cap-aware stand-in for the engine's sprint-at-max fallback when
        no clock is deadline-feasible: the fastest clock *fitting the
        grant* (min predicted time; highest ladder step for table-free
        policies), degrading to the least-overdraw clock when nothing
        fits — the miss burns as fast as the grant allows, and the engine
        still never drops work."""
        d = dvfs or self.dvfs
        if grant is None or not np.isfinite(grant):
            return d.max_clock
        lim = grant + 1e-12
        if table is not None and len(table):
            fit = np.asarray(table.P) * (1 + guard) <= lim
            if fit.any():
                T = np.where(fit, table.T, np.inf)
                return table.clocks[int(np.argmin(T))]
            return table.clocks[int(np.argmin(table.P))]
        best = self._fastest_fitting(d, grant, guard)
        return best if best is not None else self._cheapest_clock(d)

    # -- preemptive rescue ---------------------------------------------- #
    def rescue_trigger(self, now: float, deadline: float,
                       remaining_pred_s: float,
                       margin: float = 0.0) -> bool:
        """The rescue predicate: is the committed plan predicted to miss?

        True when ``now + remaining x (1 + margin)`` overshoots the
        deadline — the signal the :class:`~repro_torch.core.preemption.
        PreemptionManager` evaluates at every segment boundary, fed with
        the *corrected* (or truth) table's remaining-time estimate, and
        the same test that decides whether a queued job is stranded
        behind the running ones. ``margin`` absorbs prediction noise so a
        healthy schedule declines instead of thrashing."""
        return now + remaining_pred_s * (1.0 + margin) > deadline + 1e-9

    def select_resume(self, job: Job, budget: float,
                      table: Optional[ClockTable], work_frac: float,
                      overhead_s: float = 0.0,
                      dvfs: Optional[DVFSConfig] = None) -> ClockSelection:
        """Clock choice for a resumable remnant: the normal per-class
        selection, run on :meth:`ClockTable.remnant` — the same lens the
        engine threads through the joint placement decision and the cap
        filter (:meth:`~repro_torch.core.preemption.PreemptionManager.
        remnant_view` delegates to the very same method), so a resume
        re-scores (class, clock) on what is actually left — mid-job
        re-scaling and cross-class migration fall out for free.
        Table-free policies resume at their fixed clock."""
        if table is not None:
            table = table.remnant(work_frac, overhead_s)
        return self.select_for_class(job, budget, table, dvfs=dvfs)

    def class_score(self, job: Job, cand: DeviceCandidate,
                    sel: ClockSelection) -> tuple:
        """Totally-ordered score for one candidate (lower is better).
        Default: any feasible placement beats any infeasible one; feasible
        placements rank by predicted energy at the selected clock;
        infeasible ones by the best predicted time on their ladder (the
        engine sprints infeasible jobs, so the miss should burn on the
        fastest class, not the earliest-free one); policies without
        predictions (dc/mc) score every class equally — ties keep the
        earliest-free candidate, which is what makes a uniform pool
        collapse to today's earliest-device dispatch."""
        if not sel.feasible:
            if cand.table is not None and len(cand.table):
                return (1, float(np.min(cand.table.T)))
            return (1, 0.0)
        if sel.power is None or sel.time is None:
            return (0, 0.0)
        return (0, sel.power * sel.time)

    def select_device_clock(
        self, job: Job, candidates: Sequence[DeviceCandidate],
    ) -> tuple[int, ClockSelection]:
        """Joint (device class, clock) decision over the co-free candidate
        classes, ordered earliest-free first. Returns the chosen candidate
        index and its clock selection. Strict ``<`` comparison keeps the
        first (earliest-free, lowest-device-index) candidate on score ties,
        so a single-candidate pool reduces exactly to
        :meth:`select_for_class`.

        On power-capped pools the engine re-derives the chosen candidate's
        selection through :meth:`select_capped` to recover the
        deadline-rescue escalation target this method discards — custom
        overrides should therefore keep their per-class choice consistent
        with :meth:`select_for_class` (as the random-placement ablation
        does), or the re-derivation may replace it under a finite cap."""
        best_i, best_sel, best_score = 0, None, None
        for i, cand in enumerate(candidates):
            if cand.power_cap is None:
                sel = self.select_for_class(job, cand.budget, cand.table,
                                            dvfs=cand.dvfs)
            else:
                sel, _ = self.select_capped(
                    job, cand.budget, cand.table, dvfs=cand.dvfs,
                    grant=cand.power_cap, guard=cand.guard)
            if best_sel is None:
                best_i, best_sel, best_score = i, sel, self.class_score(
                    job, cand, sel)
                continue
            score = self.class_score(job, cand, sel)
            if score < best_score:
                best_i, best_sel, best_score = i, sel, score
        return best_i, best_sel

    # -- batched joint scoring ------------------------------------------ #
    def batch_scores(self, job: Job, budget: float,
                     stacked) -> Optional[tuple[int, ClockSelection]]:
        """Vectorized reformulation of the :meth:`select_for_class` →
        :meth:`class_score` → strict-``<`` joint decision over a
        :class:`~repro_torch.core.prediction_service.StackedTable` of candidate
        rows (earliest-free first, all sharing one ``budget``): one fused
        feasible-mask → predicted-energy argmin over the (candidates ×
        padded clocks) block instead of a per-candidate Python loop.

        Tie-breaks are the scalar path's, exactly: row-wise ``np.argmin``
        keeps the lowest ladder index among equal-energy feasible clocks
        (voltage-floor plateau ties), and the final cross-candidate
        comparison uses the same strict-``<`` score tuples, so equal
        scores keep the earliest-free, lowest-device-index candidate.

        Returns ``(candidate_index, selection)`` — bit-identical to
        :meth:`select_device_clock` on the same candidates — or ``None``
        when the policy is not :attr:`batchable` (scan-order policies like
        d-dvfs; the engine then takes the scalar/compiled-ladder path)."""
        if not self.batchable:
            return None
        margin = self._margin_for(job)
        T, P = stacked.T, stacked.P
        Tg = T * (1.0 + margin)
        feas = Tg <= budget           # padded slots are +inf: never admitted
        E = np.where(feas, P * T, np.inf)
        row_best = np.argmin(E, axis=1)        # first occurrence per row
        rows = np.arange(len(stacked.tables))
        best_E = E[rows, row_best]
        row_feas = feas.any(axis=1)
        min_T = np.where(stacked.mask, T, np.inf).min(axis=1)
        best_i, best_score = 0, None
        for i in range(len(stacked.tables)):
            score = ((0, float(best_E[i])) if row_feas[i]
                     else (1, float(min_T[i])))
            if best_score is None or score < best_score:
                best_i, best_score = i, score
        if not row_feas[best_i]:
            return best_i, ClockSelection(None)
        tab = stacked.tables[best_i]
        j = int(row_best[best_i])
        return best_i, ClockSelection(tab.clocks[j], float(tab.P[j]),
                                      float(tab.T[j]))

    def __repr__(self) -> str:  # pragma: no cover - debugging nicety
        return f"{type(self).__name__}({self.name!r})"


class DefaultClock(Policy):
    """Paper's DC baseline: every job at the default application clock.
    On a heterogeneous pool: the *earliest-free device's* default clock —
    DC does no placement intelligence, by design."""

    name = "dc"

    def select_clock(self, job, budget, table):
        return ClockSelection(self.dvfs.default_clock)

    def select_for_class(self, job, budget, table, dvfs=None):
        return ClockSelection((dvfs or self.dvfs).default_clock)


class MaxClock(Policy):
    """Paper's MC baseline ("computational sprinting"): always max clock.
    On a heterogeneous pool: the earliest-free device's max clock."""

    name = "mc"

    def select_clock(self, job, budget, table):
        return ClockSelection(self.dvfs.max_clock)

    def select_for_class(self, job, budget, table, dvfs=None):
        return ClockSelection((dvfs or self.dvfs).max_clock)


class PaperDDVFS(Policy):
    """Algorithm 1 lines 9-20, literally: scan the ladder in documented
    order, accept a clock iff it improves BOTH the best predicted power and
    the best predicted time seen so far (``maxTime`` starts at the budget
    and tightens on every accept)."""

    name = "d-dvfs"
    table_kind = "predicted"

    def select_clock(self, job, budget, table):
        min_power, max_time = np.inf, budget
        best, bp, bt = None, None, None
        for c, p, t in zip(table.clocks, table.P, table.T):
            if p < min_power and t < max_time:
                min_power, max_time = p, t
                best, bp, bt = c, float(p), float(t)
        return ClockSelection(best, bp, bt)


class MinEnergy(Policy):
    """Beyond-paper: argmin predicted energy (P·T) s.t. predicted time
    within budget."""

    name = "min-energy"
    table_kind = "predicted"
    batchable = True      # select_clock IS the feasible-mask/argmin pattern
    margin: float = 0.0

    def _margin_for(self, job: Job) -> float:
        return self.margin

    def select_clock(self, job, budget, table):
        T_guard = table.T * (1.0 + self._margin_for(job))
        feasible = T_guard <= budget
        if not feasible.any():
            return ClockSelection(None)
        E = np.where(feasible, table.P * table.T, np.inf)
        i = int(np.argmin(E))
        return ClockSelection(table.clocks[i], float(table.P[i]),
                              float(table.T[i]))


class RiskAware(MinEnergy):
    """Min-energy with the time estimate inflated by ``margin`` — insurance
    against predictor underestimates (deadline risk).

    ``margin_fn`` (optional) adds a *per-app* margin on top of the static
    one; wire it to :meth:`repro_torch.core.online.OnlineAdapter.margin`
    and the insurance tracks each app's observed residual variance: tight
    for apps the corrector predicts well, generous for noisy or
    recently-drifted ones."""

    name = "risk-aware"

    def __init__(self, dvfs: DVFSConfig, margin: float = 0.05,
                 margin_fn: Optional[Callable[[str], float]] = None):
        super().__init__(dvfs)
        self.margin = float(margin)
        self.margin_fn = margin_fn

    def _margin_for(self, job: Job) -> float:
        if self.margin_fn is None:
            return self.margin
        return self.margin + float(self.margin_fn(job.name))


class Oracle(Policy):
    """Ground-truth exhaustive minimum-energy feasible clock — the
    unreachable lower bound quantifying the prediction gap."""

    name = "oracle"
    table_kind = "truth"
    batchable = True      # T <= budget mask + argmin T·P: the same pattern

    def select_clock(self, job, budget, table):
        E = np.where(table.T <= budget, table.T * table.P, np.inf)
        i = int(np.argmin(E))
        if not np.isfinite(E[i]):
            return ClockSelection(None)
        return ClockSelection(table.clocks[i], float(table.P[i]),
                              float(table.T[i]))


#: Registry — plug new policies in by adding a class here (or by mutating at
#: runtime for experiments); the engine and ``run_schedule`` resolve names
#: through this dict.
POLICIES: dict[str, type[Policy]] = {
    cls.name: cls
    for cls in (DefaultClock, MaxClock, PaperDDVFS, MinEnergy, RiskAware,
                Oracle)
}
POLICY_NAMES: tuple[str, ...] = tuple(POLICIES)


def resolve_policy(policy: str | Policy, dvfs: DVFSConfig,
                   risk_margin: float = 0.05) -> Policy:
    """Name → Policy instance (instances pass through unchanged)."""
    if isinstance(policy, Policy):
        return policy
    cls = POLICIES.get(policy)
    if cls is None:
        raise ValueError(
            f"unknown policy {policy!r}; choose from {POLICY_NAMES}")
    if cls is RiskAware:
        return cls(dvfs, margin=risk_margin)
    return cls(dvfs)


# ---------------------------------------------------------------------- #
#  Budget managers
# ---------------------------------------------------------------------- #
class BudgetManager:
    """Observes the queue and caps per-job time budgets at decision time."""

    def reset(self) -> None:
        """Forget all state (called once per engine run)."""

    def on_admit(self, job: Job) -> None:
        """``job`` entered the ready queue."""

    def on_pop(self, job: Job) -> None:
        """``job`` left the queue (about to be dispatched)."""

    def apply(self, job: Job, start: float, budget: float) -> float:
        """Return the (possibly reduced) budget for ``job`` starting at
        ``start``."""
        return budget

    # -- decision rollback (power-capped engine only) ------------------- #
    def snapshot(self):
        """Opaque state token taken *before* ``on_pop``/``apply`` of a
        decision that might be rolled back — the power-capped engine defers
        a dispatch (job back to the queue, device waits for a grant
        release) when not even the cheapest clock fits the cluster's
        remaining headroom, and the manager must forget that decision.

        Contract: between :meth:`snapshot` and a matching :meth:`restore`
        the engine performs exactly one ``on_pop`` + one ``apply`` — an
        implementation may therefore record an O(1) undo token instead of
        copying state. Default: stateless per decision, nothing to save."""
        return None

    def restore(self, state) -> None:
        """Undo every mutation since the matching :meth:`snapshot`."""


class QueueAwareBudget(BudgetManager):
    """Cap job i's budget so queued jobs can still sprint to their deadlines:

        budget_i = min(budget_i, min_m(d_{j_m} − start − Σ_{k≤m} tmin_{j_k}))

    over the queued jobs j in EDF order. Incremental: the EDF order is a
    bisect-maintained sorted list and each job's ``t_min`` is computed once
    at admission (the prediction service memoizes it per app anyway)."""

    def __init__(self, t_min: Callable[[Job], float]):
        self.t_min = t_min
        self.reset()

    def reset(self):
        self._entries: list[tuple[float, int, float]] = []  # (dl, seq, tmin)
        # id(job) -> FIFO of admission keys (the same Job object may be
        # admitted more than once in synthetic/replayed workloads)
        self._keys_of: dict[int, list[tuple[float, int]]] = {}
        self._seq = 0
        self._last_pop = None     # O(1) undo token for capped rollback

    def on_admit(self, job):
        key = (job.deadline, self._seq)
        self._seq += 1
        self._keys_of.setdefault(id(job), []).append(key)
        bisect.insort(self._entries, (*key, self.t_min(job)))

    def on_pop(self, job):
        self._last_pop = None
        keys = self._keys_of.get(id(job))
        if not keys:
            return
        key = keys.pop(0)   # earliest admission first — matches EDF tiebreak
        if not keys:
            del self._keys_of[id(job)]
        i = bisect.bisect_left(self._entries, key)
        entry = None
        if i < len(self._entries) and self._entries[i][:2] == key:
            entry = self._entries[i]
            del self._entries[i]
        self._last_pop = (id(job), key, entry)

    def snapshot(self):
        # O(1): on_pop records the undo token (one removal per decision —
        # the BudgetManager.snapshot contract); nothing to copy here
        return "undo-last-pop"

    def restore(self, state):
        if self._last_pop is None:
            return
        jid, key, entry = self._last_pop
        self._keys_of.setdefault(jid, []).insert(0, key)
        if entry is not None:
            bisect.insort(self._entries, entry)
        self._last_pop = None

    def apply(self, job, start, budget):
        cum = 0.0
        for dl, _, tmin in self._entries:
            cum += tmin
            budget = min(budget, dl - start - cum)
        return budget


class VirtualPacingBudget(BudgetManager):
    """Track the virtual default-clock schedule over execution order and cap
    each job's budget at DC-pace plus a ``slack_share`` fraction of its own
    deadline slack — bounding the delay imposed on future arrivals (see
    scheduler module docstring)."""

    def __init__(self, t_dc: Callable[[Job], float], slack_share: float = 0.2):
        self.t_dc = t_dc
        self.slack_share = float(slack_share)
        self.reset()

    def reset(self):
        self._vdc = 0.0   # virtual DC-schedule completion time

    def apply(self, job, start, budget):
        t_dc_i = self.t_dc(job)
        vdc_i = max(self._vdc, job.arrival) + t_dc_i
        self._vdc = vdc_i
        pace = (vdc_i - start) + self.slack_share * max(
            0.0, job.deadline - vdc_i)
        return min(budget, max(pace, t_dc_i))

    def snapshot(self):
        return self._vdc

    def restore(self, state):
        self._vdc = state
