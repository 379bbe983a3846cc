"""Predictive overload admission control for multi-tenant streams.

The :class:`AdmissionController` sits in the :class:`~repro_torch.core.engine.
EventEngine`'s admit path (both the plain and preemptive loops) and
decides, per sheddable arrival, whether to **admit**, **defer**, or
**shed** it before it ever reaches the EDF queue. The signal is the
corrected prediction tables: aggregate predicted sprint-time demand
inside a lookahead window versus the pool's effective service capacity
(device-seconds, derated by a finite power cap's model-envelope sprint
draw), plus a per-job doom test — predicted queueing delay behind
EDF-ahead work plus the job's own predicted time overshooting its
deadline.

Decision table (``check``), evaluated only for jobs whose
:class:`~repro_torch.core.workload.TierSpec` is ``sheddable`` — SLO and batch
tiers are *always* admitted:

========================  ==========
window overloaded, doomed  **shed**
window overloaded, viable  **defer** (parked; re-checked at every
                           admit wave, released greedily as headroom
                           reappears, shed if doomed meanwhile)
window not overloaded      admit
========================  ==========

Contracts mirroring every other optional subsystem here:

* ``admission=None`` (the default everywhere) runs zero controller code —
  bit-identical to the plain engine.
* A controller attached to a stream with no sheddable jobs never sheds,
  never defers, and never perturbs RNG state — also bit-identical.
* Every job is conserved: admitted (→ executed) or shed, never silently
  dropped; deferred jobs are force-drained when the stream and queue
  empty out. ``shed_jobs`` / :class:`AdmissionStats` make the shed work
  explicit — a shed job consumes no energy and is *not* counted as a
  deadline miss, and benchmarks must report it alongside both.

When predictions are unavailable (no fitted predictor and a table-free
policy), demand is unknowable: the controller admits everything, which
degrades gracefully to the tierless engine.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Optional

from .workload import Job, edf_key

if TYPE_CHECKING:                                    # pragma: no cover
    from .engine import EventEngine

__all__ = ["AdmissionController", "AdmissionStats"]


@dataclasses.dataclass
class AdmissionStats:
    """Counters for one engine run (reset by ``reset``)."""
    checks: int = 0        # arrivals evaluated (all tiers)
    admitted: int = 0      # admitted straight into the queue
    deferred: int = 0      # parked at least once
    released: int = 0      # parked jobs later admitted
    shed: int = 0          # dropped (at check time or while parked)
    overloads: int = 0     # checks that saw an overloaded window
    shed_by_tier: dict = dataclasses.field(default_factory=dict)

    def summary(self) -> str:
        by_tier = ", ".join(f"{k}: {v}"
                            for k, v in sorted(self.shed_by_tier.items()))
        return (f"checks {self.checks}, admitted {self.admitted}, "
                f"deferred {self.deferred} (released {self.released}), "
                f"shed {self.shed} [{by_tier}], "
                f"overloaded checks {self.overloads}")


class AdmissionController:
    """Predictive overload admission for best-effort work.

    Parameters
    ----------
    lookahead_s:
        Width of the overload window. Demand is the sum of predicted
        sprint times of queued + parked jobs (and the candidate) whose
        deadlines fall within ``now + lookahead_s``; supply is
        ``n_effective_devices × lookahead_s``.
    threshold:
        Demand/supply ratio above which the window counts as
        overloaded (1.0 = at capacity).
    margin:
        Fractional inflation of the candidate's own predicted time in
        the doom test — absorbs prediction noise, like the preemption
        manager's ``margin``.
    defer:
        When False, overloaded-but-viable jobs are admitted rather than
        parked (shed-only mode).
    """

    def __init__(self, lookahead_s: float = 30.0, threshold: float = 1.0,
                 margin: float = 0.0, defer: bool = True):
        if lookahead_s <= 0:
            raise ValueError("lookahead_s must be > 0")
        self.lookahead_s = float(lookahead_s)
        self.threshold = float(threshold)
        self.margin = float(margin)
        self.defer = bool(defer)
        self.stats = AdmissionStats()
        self.shed_jobs: list[Job] = []
        self._deferred: list[tuple[int, Job]] = []
        self._defer_seq = 0
        self._engine: Optional["EventEngine"] = None
        self._n_eff = 1.0
        self._t_cache: dict[str, Optional[float]] = {}

    # -- lifecycle ---------------------------------------------------

    def reset(self, engine: "EventEngine") -> None:
        """Bind to an engine at run start; derate capacity for a cap.

        Effective parallelism is ``n_devices`` scaled by
        ``cap / Σ model-envelope sprint draw`` when a finite
        :class:`~repro_torch.core.powercap.PowerCapCoordinator` cap binds —
        the same table-free upper envelope the cap filter uses
        (``Policy.model_power``), so no prediction tables are needed to
        know the cap throttles throughput.
        """
        self.stats = AdmissionStats()
        self.shed_jobs = []
        self._deferred = []
        self._defer_seq = 0
        self._t_cache = {}
        self._engine = engine
        n = engine.n_devices
        scale = 1.0
        coord = engine.power_coordinator
        cap_w = getattr(coord, "cap_w", math.inf) if coord else math.inf
        if math.isfinite(cap_w):
            classes = engine.device_classes or [None] * n
            draw = 0.0
            for cls in classes:
                dvfs = cls.dvfs if cls is not None else engine.testbed.dvfs
                draw += engine.policy.model_power(dvfs.max_clock, dvfs)
            if draw > 0:
                scale = min(1.0, cap_w / draw)
        self._n_eff = max(n * scale, 1e-9)

    @property
    def n_deferred(self) -> int:
        return len(self._deferred)

    # -- prediction helpers ------------------------------------------

    def _t_est(self, job: Job) -> Optional[float]:
        """Predicted sprint time for a fresh job (cached per app name);
        None when no prediction source exists."""
        t = self._t_cache.get(job.name, _MISSING)
        if t is _MISSING:
            t = self._engine._t_min_est(
                dataclasses.replace(job, work_frac=1.0), None)
            self._t_cache[job.name] = t
        if t is None:
            return None
        pre = self._engine.preemption
        t_full = t * job.work_frac
        return pre.scale_t(job, t_full) if pre is not None else t_full

    def _supply_s(self) -> float:
        return self._n_eff * self.lookahead_s * self.threshold

    def _window_demand(self, now: float, queue, extra=()) -> float:
        horizon = now + self.lookahead_s
        d = 0.0
        for _, _, j in queue:
            if j.deadline <= horizon:
                d += self._t_est(j) or 0.0
        for _, j in self._deferred:
            if j.deadline <= horizon:
                d += self._t_est(j) or 0.0
        for j in extra:
            if j.deadline <= horizon:
                d += self._t_est(j) or 0.0
        return d

    def _doomed(self, job: Job, now: float, queue) -> bool:
        """Predicted miss even if admitted: queueing delay behind
        EDF-ahead work plus the job's own time overshoots its deadline."""
        tj = self._t_est(job)
        if tj is None:
            return False
        key = edf_key(job)
        ahead = 0.0
        for _, _, q in queue:
            if edf_key(q) <= key:
                ahead += self._t_est(q) or 0.0
        finish = now + ahead / self._n_eff + tj * (1.0 + self.margin)
        return finish > job.deadline + 1e-9

    # -- engine entry points -----------------------------------------

    def check(self, job: Job, now: float, queue) -> bool:
        """Admission verdict for one arrival. True → the engine enqueues
        the job now; False → the controller consumed it (shed or
        parked) and the engine must drop it from this wave."""
        self.stats.checks += 1
        if not job.tier.sheddable:
            self.stats.admitted += 1
            return True
        if self._window_demand(now, queue, extra=(job,)) > self._supply_s():
            self.stats.overloads += 1
            if self._doomed(job, now, queue):
                self._shed(job)
                return False
            if self.defer:
                self._deferred.append((self._defer_seq, job))
                self._defer_seq += 1
                self.stats.deferred += 1
                return False
        self.stats.admitted += 1
        return True

    def release(self, now: float, queue, force: bool = False) -> list[Job]:
        """Drain parked jobs: shed the now-doomed, admit greedily (in
        dispatch-key order) while window demand stays under supply.
        ``force`` (stream exhausted, queue drained) admits every
        surviving job regardless — deferred work is never stranded."""
        if not self._deferred:
            return []
        supply = self._supply_s()
        demand = self._window_demand(now, queue)
        horizon = now + self.lookahead_s
        out: list[Job] = []
        keep: list[tuple[int, Job]] = []
        for seq, job in sorted(self._deferred,
                               key=lambda e: (edf_key(e[1]), e[0])):
            tj = self._t_est(job) or 0.0
            in_window = job.deadline <= horizon
            if self._doomed(job, now, queue):
                self._shed(job)
            elif force or not in_window or demand + tj <= supply:
                out.append(job)
                self.stats.released += 1
                if in_window:
                    demand += tj
            else:
                keep.append((seq, job))
        self._deferred = keep
        return out

    # -- internals ---------------------------------------------------

    def _shed(self, job: Job) -> None:
        self.stats.shed += 1
        name = job.tier.name
        self.stats.shed_by_tier[name] = (
            self.stats.shed_by_tier.get(name, 0) + 1)
        self.shed_jobs.append(job)


_MISSING = object()
