"""Cluster power-budget subsystem: telemetry ledger + dynamic cap coordinator.

The paper minimizes per-job energy under deadlines on one device; a
production pool is additionally provisioned against an *aggregate* power
envelope — racks have breakers and contracted power, and both the DVFS
survey (arXiv:1610.01784) and the heterogeneous-cluster scheduling work
(arXiv:2104.00486) treat cluster-level power as the binding constraint that
per-device frequency scaling must respect. This module supplies the two
pieces the engine needs to express "this pool may never draw more than
2 kW":

* :class:`PowerTelemetry` — the accounting side. Cluster power over
  simulated time is an exact **step function** assembled from per-device
  busy intervals (each :class:`~repro_torch.core.engine.ExecutionRecord` is one
  busy interval at its realized — or predicted, or granted — draw) plus
  idle intervals at each device's class idle floor
  (:meth:`~repro_torch.core.dvfs.DeviceClass.idle_power`, the same accessor the
  simulator's truth path uses — single source of truth). Integrals are
  exact (no sampling grid), peak and peak-window queries are closed-form,
  and energy attributes cleanly to device classes (busy vs idle).
* :class:`PowerCapCoordinator` — the enforcement side. Owns a cluster-wide
  cap and hands out per-device power **grants** at event time. Grant
  sizing is pluggable (:data:`GRANT_POLICIES`): ``uniform`` static split,
  ``greedy-edf`` (the EDF-first dispatch may assume all current headroom),
  and ``slack-weighted`` (headroom is redistributed from idle/low-urgency
  devices toward deadline-critical jobs in proportion to inverse predicted
  slack). A **deadline-rescue escalation** path reclaims granted-but-unused
  headroom (running grants above their realized draw) when a grant is the
  only thing blocking a deadline-feasible clock.

Grant lifecycle (one dispatch decision, driven by the engine)::

    advance(start)      expire grants whose jobs ended by `start`
    offer(dev, job)     policy-shaped max watts this dispatch may assume
    ── policy filters the clock ladder to clocks fitting the offer ──
    escalate(dev, W)    only if the offer blocks a feasible clock: reclaim
                        unused headroom, return the best grant ≤ W
    commit(dev, W, end, drawn)
                        allocate W (clamped so Σ grants never exceeds the
                        cap) until `end`; `drawn` is the realized draw the
                        next escalation may reclaim down to

The reference coordinator's federation hooks (``reclaimable_w``,
``reclaim_unused``, ``resize_cap``, ``release_cap``, ``active_grants``),
which only its rack coordinators call, arrive with ROADMAP §1.10.

Invariants (held against the reference by tests/test_torch_layers.py):

1. **Cap safety** — at every instant, Σ committed grants + Σ idle floors
   of ungranted devices ≤ ``cap_w``. ``commit`` clamps; it never throws
   work away (the engine still runs the job — a clamped grant below the
   realized draw is counted in ``stats.violations`` instead, which only
   happens under pathological caps near the idle floor).
2. **Cap = ∞ identity** — every ``offer`` is ``inf``, ladder filtering
   keeps every clock, escalation never fires: the engine's decisions (and
   RNG stream) are bit-identical to the capless engine, for every policy.
3. **Ledger exactness** — the step function is nonnegative and its
   integral equals Σ busy-interval energy + Σ idle energy, exactly (up to
   float rounding, not discretization).
4. **Grants floor at idle** — a device is never granted less than its
   class's idle draw; escalation reclaims other grants only down to
   ``max(realized draw, idle floor)``.
"""
from __future__ import annotations

import bisect
import dataclasses
import math
from typing import Callable, Iterable, Optional, Sequence

import numpy as np

from .dvfs import DeviceClass
from .workload import Job

__all__ = [
    "GRANT_POLICIES",
    "PowerSegment",
    "PowerTelemetry",
    "CoordinatorStats",
    "PowerCapCoordinator",
]

#: Grant-sizing policies the coordinator supports.
GRANT_POLICIES: tuple[str, ...] = ("uniform", "greedy-edf", "slack-weighted")


# ---------------------------------------------------------------------- #
#  Telemetry ledger
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class PowerSegment:
    """One step of the cluster power function: ``watts`` over [t0, t1)."""

    t0: float
    t1: float
    watts: float

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    @property
    def energy_j(self) -> float:
        return self.watts * (self.t1 - self.t0)


class PowerTelemetry:
    """Exact step-function view of cluster power over simulated time.

    Build one with :meth:`from_result`; query peaks, windows, integrals
    and per-class attribution. The ``view`` chooses which per-interval
    draw the busy steps use:

    * ``"measured"`` — the realized draw (``record.power_w``): the truth
      path, what a rack power meter would integrate;
    * ``"predicted"`` — the scheduler's predicted draw
      (``record.predicted_power``; falls back to measured for
      non-predictive policies): what the cap decisions were based on;
    * ``"granted"`` — the committed grant (``record.power_grant_w``;
      falls back to measured on capless runs): the coordinator's
      allocation — its peak can never exceed the cap (invariant 1).

    Comparing the ``predicted``/``granted`` views against ``measured`` is
    the reconciliation loop: grant minus measured is the headroom
    escalation can reclaim; measured above granted is a cap violation.
    """

    def __init__(self, segments: Sequence[PowerSegment],
                 busy_energy_by_class: Optional[dict[str, float]] = None,
                 idle_energy_by_class: Optional[dict[str, float]] = None):
        self.segments: tuple[PowerSegment, ...] = tuple(segments)
        self._starts = [s.t0 for s in self.segments]
        self.busy_energy_by_class = dict(busy_energy_by_class or {})
        self.idle_energy_by_class = dict(idle_energy_by_class or {})

    # -- construction --------------------------------------------------- #
    @classmethod
    def from_result(
        cls,
        result,
        pool: Optional[Sequence[DeviceClass]] = None,
        idle_powers: "float | Sequence[float] | None" = None,
        n_devices: Optional[int] = None,
        horizon: Optional[float] = None,
        view: str = "measured",
    ) -> "PowerTelemetry":
        """Ledger for a :class:`~repro_torch.core.engine.ScheduleResult`.

        ``pool`` (one :class:`DeviceClass` per device, positional — the
        same list handed to the engine) supplies per-device idle floors
        and class attribution; without it, ``idle_powers`` may give a
        scalar or per-device idle draw (default 0: job power only). The
        ledger spans [0, ``horizon``] (default: the makespan).
        """
        records = list(result.records)
        if pool is not None:
            n = len(pool)
            idle = [c.idle_power() for c in pool]
        else:
            n = n_devices if n_devices is not None else (
                max((r.device for r in records), default=-1) + 1)
            if idle_powers is None:
                idle = [0.0] * n
            elif np.isscalar(idle_powers):
                idle = [float(idle_powers)] * n
            else:
                idle = [float(x) for x in idle_powers]
                n = max(n, len(idle))
        if horizon is None:
            horizon = max((r.end for r in records), default=0.0)
        horizon = float(horizon)

        def draw_of(r) -> float:
            if view == "measured":
                return r.power_w
            if view == "predicted":
                return (r.predicted_power if r.predicted_power is not None
                        else r.power_w)
            if view == "granted":
                g = getattr(r, "power_grant_w", None)
                return g if g is not None else r.power_w
            raise ValueError(f"unknown view {view!r}; use measured | "
                             "predicted | granted")

        # delta sweep: baseline = every device idle; a busy interval adds
        # (draw − idle) over [start, end), clipped to the ledger span so an
        # explicit short horizon truncates cleanly. Exact — no sampling
        # grid; integral == Σ clipped busy energy + idle energy.
        baseline = math.fsum(idle)
        events: dict[float, float] = {0.0: 0.0, horizon: 0.0}
        busy_by_dev = [0.0] * n
        busy_e: dict[str, float] = {}
        for r in records:
            if r.device >= n:
                raise ValueError(
                    f"record on device {r.device} but ledger sized for {n}")
            s, e = max(r.start, 0.0), min(r.end, horizon)
            if e <= s:
                continue
            w = float(draw_of(r))
            d_idle = idle[r.device]
            events[s] = events.get(s, 0.0) + (w - d_idle)
            events[e] = events.get(e, 0.0) - (w - d_idle)
            busy_by_dev[r.device] += e - s
            key = r.device_class or "default"
            busy_e[key] = busy_e.get(key, 0.0) + w * (e - s)

        idle_e: dict[str, float] = {}
        for dev in range(n):
            key = pool[dev].name if pool is not None else "default"
            idle_e[key] = idle_e.get(key, 0.0) + idle[dev] * max(
                horizon - busy_by_dev[dev], 0.0)

        times = sorted(events)
        segments: list[PowerSegment] = []
        level = baseline
        for t0, t1 in zip(times, times[1:]):
            level += events[t0]
            if t1 > t0:
                # mathematically ≥ 0 (a sum of positive draws); clamp the
                # float-rounding dust so the step function is nonnegative
                segments.append(PowerSegment(t0, t1, max(level, 0.0)))
        return cls(segments, busy_energy_by_class=busy_e,
                   idle_energy_by_class=idle_e)

    # -- queries --------------------------------------------------------- #
    def __len__(self) -> int:
        return len(self.segments)

    @property
    def t_start(self) -> float:
        return self.segments[0].t0 if self.segments else 0.0

    @property
    def t_end(self) -> float:
        return self.segments[-1].t1 if self.segments else 0.0

    @property
    def peak_w(self) -> float:
        """Maximum instantaneous cluster power."""
        return max((s.watts for s in self.segments), default=0.0)

    @property
    def peak_t(self) -> float:
        """Start time of the first segment attaining :attr:`peak_w`."""
        p = self.peak_w
        for s in self.segments:
            if s.watts == p:
                return s.t0
        return 0.0

    def power_at(self, t: float) -> float:
        """Cluster power at time ``t`` (0 outside the ledger span)."""
        if not self.segments or t < self.t_start or t >= self.t_end:
            return 0.0
        i = bisect.bisect_right(self._starts, t) - 1
        return self.segments[i].watts

    def energy_j(self, t0: Optional[float] = None,
                 t1: Optional[float] = None) -> float:
        """Exact integral of cluster power over [t0, t1] (default: all)."""
        t0 = self.t_start if t0 is None else t0
        t1 = self.t_end if t1 is None else t1
        parts = []
        for s in self.segments:
            lo, hi = max(s.t0, t0), min(s.t1, t1)
            if hi > lo:
                parts.append(s.watts * (hi - lo))
        return math.fsum(parts)

    def mean_w(self) -> float:
        dur = self.t_end - self.t_start
        return self.energy_j() / dur if dur > 0 else 0.0

    def peak_window(self, width_s: float) -> tuple[float, float]:
        """(start, mean watts) of the worst sliding window of ``width_s``.

        For a step function the rolling-integral extrema occur where a
        window edge aligns with a step boundary, so scanning candidate
        starts at every breakpoint (and every breakpoint minus the width)
        is exact — no discretization.
        """
        if not self.segments:
            return (0.0, 0.0)
        width_s = float(width_s)
        if width_s <= 0:
            return (self.peak_t, self.peak_w)
        lo, hi = self.t_start, self.t_end
        if width_s >= hi - lo:
            return (lo, self.energy_j() / width_s)
        cand = {lo, hi - width_s}
        for s in self.segments:
            for edge in (s.t0, s.t0 - width_s):
                if lo <= edge <= hi - width_s:
                    cand.add(edge)
        best_t, best_e = lo, -1.0
        for t in sorted(cand):
            e = self.energy_j(t, t + width_s)
            if e > best_e:
                best_t, best_e = t, e
        return (best_t, best_e / width_s)

    def duration_above(self, watts: float) -> float:
        """Total time the cluster spends strictly above ``watts``."""
        return math.fsum(s.duration_s for s in self.segments
                         if s.watts > watts)

    def overage_w(self, cap_w: float) -> float:
        """How far the peak exceeds ``cap_w`` (0 when within the cap)."""
        return max(self.peak_w - cap_w, 0.0)

    def energy_by_class(self) -> dict[str, dict[str, float]]:
        """Per-device-class attribution: busy and idle energy (J)."""
        keys = set(self.busy_energy_by_class) | set(self.idle_energy_by_class)
        return {
            k: {"busy": self.busy_energy_by_class.get(k, 0.0),
                "idle": self.idle_energy_by_class.get(k, 0.0)}
            for k in sorted(keys)
        }

    def series(self) -> tuple[np.ndarray, np.ndarray]:
        """(breakpoints, watts) arrays — watts[i] holds over
        [breakpoints[i], breakpoints[i+1])."""
        if not self.segments:
            return np.array([]), np.array([])
        t = np.array(self._starts + [self.t_end])
        w = np.array([s.watts for s in self.segments])
        return t, w


# ---------------------------------------------------------------------- #
#  Cap coordinator
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class CoordinatorStats:
    offers: int = 0
    commits: int = 0
    escalations: int = 0          # deadline-rescue attempts
    rescues: int = 0              # escalations that covered the need
    reclaimed_w: float = 0.0      # total watts clawed back from grants
    clamped: int = 0              # commits clamped to remaining headroom
    violations: int = 0           # realized draw above the committed grant

    def summary(self) -> str:
        return (f"offers={self.offers} commits={self.commits} "
                f"escalations={self.escalations} rescues={self.rescues} "
                f"reclaimed={self.reclaimed_w:.0f}W clamped={self.clamped} "
                f"violations={self.violations}")


class PowerCapCoordinator:
    """Owns a cluster-wide power cap and grants per-device budgets.

    Duck-typed against the engine: ``reset(idle_powers, t_min_fn)``,
    ``advance(t)``, ``offer(dev, job, start, queue)``,
    ``escalate(dev, needed_w, start)``, ``commit(dev, w, end, drawn)``,
    plus the ``guard`` attribute the ladder filter inflates predicted
    power by (insurance against prediction error and measurement noise —
    the realized draw must stay under the grant for the cluster to stay
    under the cap).

    ``grant_policy`` (:data:`GRANT_POLICIES`):

    * ``uniform`` — every device may assume ``cap / n_devices``,
      regardless of cluster state. Simple, fair, and wasteful: an urgent
      job cannot use the headroom its idle neighbours are not drawing.
    * ``greedy-edf`` — the dispatching job (the engine dispatches in EDF
      order, so this is the earliest deadline) may assume *all* current
      headroom. Later co-running dispatches squeeze into what remains.
    * ``slack-weighted`` — the offer is the job's share of headroom in
      proportion to inverse predicted slack (``deadline − start − t_min``)
      against the most urgent queued jobs that could co-run on the
      remaining free devices: deadline-critical jobs get most of the
      headroom, slack-rich ones are pushed toward cheaper clocks.

    The coordinator never drops work: when even escalation cannot fit a
    job, ``commit`` clamps the grant to the remaining headroom (keeping
    invariant 1) and counts the realized overage in ``stats.violations``.
    """

    def __init__(
        self,
        cap_w: float,
        grant_policy: str = "slack-weighted",
        guard: float = 0.1,
        slack_eps: float = 1e-3,
        t_min_fn: Optional[Callable] = None,
    ):
        if grant_policy not in GRANT_POLICIES:
            raise ValueError(f"unknown grant policy {grant_policy!r}; "
                             f"choose from {GRANT_POLICIES}")
        if not cap_w > 0:
            raise ValueError("cap_w must be positive (use math.inf to "
                             "disable enforcement)")
        self.cap_w = float(cap_w)
        self.grant_policy = grant_policy
        self.guard = float(guard)
        self.slack_eps = float(slack_eps)
        self.t_min_fn = t_min_fn
        self._t_min = t_min_fn
        self.stats = CoordinatorStats()
        self._idle: list[float] = []
        self._alloc: list[float] = []
        self._device_classes: Optional[list[DeviceClass]] = None
        #: dev -> (grant_w, end, drawn_w, record) for running jobs —
        #: ``record`` (optional) is kept in sync when reclaims shrink the
        #: grant, so a granted-view telemetry ledger reflects the watts
        #: actually *held* and provably never sums above the cap
        self._active: dict[int, tuple[float, float, float, object]] = {}

    # ------------------------------------------------------------------ #
    @property
    def n_devices(self) -> int:
        return len(self._idle)

    def idle_of(self, dev: int) -> float:
        return self._idle[dev]

    @property
    def allocated_w(self) -> float:
        """Σ current allocations (committed grants + idle floors)."""
        return math.fsum(self._alloc)

    @property
    def headroom_w(self) -> float:
        """Watts not yet spoken for (cap − Σ allocations)."""
        return max(self.cap_w - self.allocated_w, 0.0)

    # ------------------------------------------------------------------ #
    def reset(self, idle_powers: Sequence[float],
              t_min_fn: Optional[Callable] = None,
              device_classes: Optional[Sequence[DeviceClass]] = None,
              ) -> None:
        """Bind the pool (one idle floor per device, plus the positional
        device classes on explicit pools) and start an episode.

        ``t_min_fn(job, device_class)`` (predicted sprint time, for slack
        weights — ``device_class`` is the dispatching device's class, or
        None for still-queued jobs whose placement is undecided) is only
        adopted when the constructor did not already supply one."""
        self._idle = [float(x) for x in idle_powers]
        if not self._idle:
            raise ValueError("idle_powers must not be empty")
        self._device_classes = (None if device_classes is None
                                else list(device_classes))
        self._t_min = self.t_min_fn if self.t_min_fn is not None else t_min_fn
        self._alloc = list(self._idle)
        self._active = {}
        self.stats = CoordinatorStats()
        if math.isfinite(self.cap_w) and sum(self._idle) > self.cap_w + 1e-9:
            raise ValueError(
                f"cap {self.cap_w:.1f}W is below the pool's idle floor "
                f"{sum(self._idle):.1f}W — no schedule can satisfy it")

    def advance(self, t: float) -> None:
        """Release grants whose jobs ended at or before ``t`` — their
        devices revert to the idle floor."""
        done = [dev for dev, (_, end, _, _) in self._active.items()
                if end <= t + 1e-12]
        for dev in done:
            del self._active[dev]
            self._alloc[dev] = self._idle[dev]

    # ------------------------------------------------------------------ #
    def _urgency(self, job: Job, start: float,
                 dev: Optional[int] = None) -> float:
        """Inverse predicted slack. ``dev`` (the dispatching device, when
        known) resolves the sprint time on *that device's class* — on a
        mixed pool a v5lite dispatch is far closer to its deadline than
        the baseline ladder suggests. Queued jobs are unplaced, so their
        slack uses the baseline class."""
        t_min = 0.0
        if self._t_min is not None:
            cls = (self._device_classes[dev]
                   if dev is not None and self._device_classes is not None
                   else None)
            t_min = float(self._t_min(job, cls))
        slack = job.deadline - start - t_min
        # weighted tier fairness: a tier's share of contended
        # headroom tracks its weight. Stock weights are powers of two, so
        # an all-one-tier queue's weight factor cancels exactly in the
        # w0/(w0+others) share — single-tier runs keep bit-identical
        # shares (the default tier's 1.0 trivially so).
        return job.tier.weight / max(slack, self.slack_eps)

    def next_release(self, t: float) -> Optional[float]:
        """Earliest time strictly after ``t`` at which a running grant
        releases — when a deferral can retry with more headroom. None when
        no grant is outstanding (the cluster is as empty as it gets)."""
        ends = [end for _, end, _, _ in self._active.values()
                if end > t + 1e-12]
        return min(ends) if ends else None

    def _reclaim(self) -> None:
        """Shrink every running grant to ``max(realized draw, idle)`` —
        the granted-but-unused headroom returns to the pool. The attached
        records follow, so they always carry the watts currently held."""
        for d2, (g, end, drawn, rec) in list(self._active.items()):
            keep = max(drawn, self._idle[d2])
            if keep < g - 1e-12:
                self.stats.reclaimed_w += g - keep
                self._alloc[d2] = keep
                self._active[d2] = (keep, end, drawn, rec)
                if rec is not None:
                    rec.power_grant_w = keep

    def offer(self, dev: int, job: Job, start: float,
              queue: Iterable = ()) -> float:
        """Max total watts device ``dev`` may assume for this dispatch.

        ``queue`` is the engine's pending EDF queue (entries
        ``(key, seq, job)``), read-only — only ``slack-weighted``
        consults it (jobs only; the key shape is the engine's business).
        The offered grant always satisfies ``idle ≤ offer ≤ idle +
        headroom``. Under ``slack-weighted``, each competitor's urgency
        is scaled by its :class:`~repro_torch.core.workload.TierSpec` weight,
        so under contention a tier's granted share of headroom tracks
        its weight, and any share a tier does not contend for
        redistributes to the others (the share is over *present*
        competitors only)."""
        self.stats.offers += 1
        idle_d = self._idle[dev]
        if not math.isfinite(self.cap_w):
            return math.inf
        head = self.headroom_w
        if self.grant_policy == "uniform":
            return min(max(self.cap_w / len(self._alloc), idle_d),
                       idle_d + head)
        if self.grant_policy == "greedy-edf":
            return idle_d + head
        # slack-weighted: this job's share of headroom against the most
        # urgent queued jobs that could co-run on the remaining free pool,
        # floored at the uniform split — redistribution moves *extra*
        # headroom toward deadline-critical jobs, it never starves a job
        # below the fair share (which is what keeps it weakly dominant
        # over uniform at tight caps instead of degenerating to greedy)
        w0 = self._urgency(job, start, dev)
        n_free_other = sum(1 for d in range(len(self._alloc))
                           if d not in self._active) - 1
        if n_free_other > 0:
            others = sorted((self._urgency(j, start) for _, _, j in queue),
                            reverse=True)[:n_free_other]
        else:
            others = []
        share = w0 / (w0 + math.fsum(others)) if others else 1.0
        uniform_w = min(max(self.cap_w / len(self._alloc), idle_d),
                        idle_d + head)
        return max(idle_d + head * share, uniform_w)

    def potential_w(self, dev: int) -> float:
        """Non-mutating upper bound on the grant a *preempt-and-retry* on
        ``dev`` could obtain: idle floor + free headroom + every other
        running grant's reclaimable slice (granted watts above
        ``max(realized draw, idle)``) + ``dev``'s **own** running grant
        above its idle floor — a preemption truncates that grant
        (:meth:`truncate`), so the remnant's re-dispatch gets those watts
        back before its offer/escalation even runs. The preemption
        manager probes this at segment boundaries to ask "could a retry
        with a bigger grant save this job?" without actually clawing
        anything back — a declined rescue must leave the coordinator
        untouched."""
        if not math.isfinite(self.cap_w):
            return math.inf
        reclaimable = math.fsum(
            max(g - max(drawn, self._idle[d2]), 0.0)
            for d2, (g, _, drawn, _) in self._active.items() if d2 != dev)
        own = (max(self._alloc[dev] - self._idle[dev], 0.0)
               if dev in self._active else 0.0)
        return self._idle[dev] + self.headroom_w + reclaimable + own

    def truncate(self, dev: int, end: float) -> None:
        """A preemption checkpointed ``dev``'s job early: shrink the
        running grant's lease to ``end`` (the checkpoint completion) so
        the watts release at the segment boundary — the next
        :meth:`advance` past ``end`` returns the device to its idle floor
        instead of holding the grant until the originally committed
        completion. The grant's *size* (and the attached record) is left
        alone: the device really did draw those watts until the
        checkpoint finished. The resumed remnant commits a fresh grant at
        re-dispatch — shrink here, regrow there."""
        ent = self._active.get(dev)
        if ent is not None:
            g, _, drawn, rec = ent
            self._active[dev] = (g, float(end), drawn, rec)

    def escalate(self, dev: int, needed_w: float, start: float) -> float:
        """Deadline rescue: the offered grant blocks a deadline-feasible
        clock needing ``needed_w`` total watts. Reclaim granted-but-unused
        headroom — running grants above ``max(realized draw, idle)`` —
        and return the best grant ≤ ``needed_w`` now available. The caller
        re-filters its ladder with the returned grant."""
        self.stats.escalations += 1
        idle_d = self._idle[dev]
        if idle_d + self.headroom_w < needed_w:
            self._reclaim()
        granted = min(needed_w, idle_d + self.headroom_w)
        if granted >= needed_w - 1e-9:
            self.stats.rescues += 1
        return granted

    def commit(self, dev: int, request_w: float, end: float,
               drawn_w: float, record=None) -> float:
        """Allocate a grant for the job now running on ``dev`` until
        ``end``. The grant is **telemetry-topped-up**: the realized draw
        is visible the moment the job starts, and where it exceeds the
        predicted request (prediction error beyond the guard) the grant
        is raised to cover it — later grants must never promise watts the
        rack is already drawing. The result is clamped into
        [idle floor, idle + headroom] so Σ allocations never exceeds the
        cap (invariant 1); a clamp below the realized draw (pathological
        caps near the idle floor only) counts as a violation.

        ``record`` (an :class:`~repro_torch.core.engine.ExecutionRecord`) is
        kept in sync when later rescues reclaim part of this grant —
        grants only ever shrink mid-job, so the record ends up holding
        the *minimum* watts held over the job's life, and a granted-view
        telemetry ledger built from records never sums above the cap.
        Returns the committed watts."""
        idle_d = self._idle[dev]
        request_w = max(float(request_w), float(drawn_w))
        if request_w > idle_d + self.headroom_w + 1e-9:
            # same pressure valve as escalation: claw back unused watts
            # from running grants before conceding a clamp
            self._reclaim()
        limit = idle_d + self.headroom_w
        grant = min(max(request_w, idle_d), limit)
        if request_w > limit + 1e-9:
            self.stats.clamped += 1
        self._alloc[dev] = grant
        self._active[dev] = (grant, float(end), float(drawn_w), record)
        if record is not None:
            record.power_grant_w = grant
        self.stats.commits += 1
        if drawn_w > grant + 1e-9:
            self.stats.violations += 1
        if math.isfinite(self.cap_w) and (
                self.allocated_w > self.cap_w * (1 + 1e-9) + 1e-6):
            raise RuntimeError(          # pragma: no cover - invariant net
                f"coordinator invariant broken: allocations "
                f"{self.allocated_w:.3f}W exceed cap {self.cap_w:.3f}W")
        return grant
