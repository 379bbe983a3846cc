"""Preemptive rescue scheduling: checkpoint / preempt / resume with
mid-job re-scaling.

The paper's Algorithm 1 commits a clock at dispatch and never revisits it
(arXiv:2004.08177): one mispredicted long job can strand every queued
deadline behind it, and no admission-time choice can undo that. The
DVFS-cluster literature (Mei et al., arXiv:2104.00486) reaches the same
conclusion from the other side — deadline guarantees under energy/power
envelopes need *runtime* reallocation. This module supplies that runtime
degree of freedom for the :class:`~repro_torch.core.engine.EventEngine`:

* **Segments.** A job with a ``checkpoint_quantum`` (seconds between
  checkpoint opportunities — :class:`~repro_torch.core.workload.Job`
  field) runs as a sequence of *segments*: the engine revisits the device
  at every quantum boundary and asks the manager whether to keep going. A
  job with no quantum (or one longer than its run) is never interruptible
  — it executes exactly as the non-preemptive engine would.
* **Preemption.** When the manager orders a preemption, the in-flight
  segment is truncated at the boundary (+ a configurable checkpoint
  overhead in seconds and joules, billed to the truncated record), and
  the job's **remaining work re-enters the EDF queue as a resumable
  remnant** (same ``job_id``/deadline, ``work_frac`` = the unfinished
  fraction, ``segment`` incremented). The remnant is redispatched through
  the normal joint (device class, clock) decision — so a resume may
  **re-scale the clock** (mid-job DVFS change), **migrate to another
  device class**, or, under a power cap, retry with a bigger grant (the
  dispatch path's ``escalate``) — paying a restore overhead on pickup.
* **Rescue triggers** (the decision, :meth:`PreemptionManager.decide`):

  1. *self-rescue* — the online adapter's **corrected** table (or the
     oracle's truth table) now predicts the committed clock misses the
     job's own deadline
     (:meth:`~repro_torch.core.policies.Policy.rescue_trigger`)
     and a faster clock / bigger grant / other class can still save it;
  2. *queue rescue* — the most urgent queued job will miss if it waits
     for the earliest running job to finish, would meet if it started at
     this boundary, and the preempted victim either still meets its own
     deadline after resuming or was doomed regardless;
  3. declining is first-class: a healthy schedule evaluates triggers at
     every boundary and never preempts — and is then **bit-identical**
     to the non-preemptive engine (the differential harness's contract).

Invariants (held against the reference by tests/test_torch_layers.py):

1. **Disabled-path identity** — ``preemption=None`` never executes a line
   of this module; a manager whose triggers never fire (or are disabled,
   ``self_rescue=False, queue_rescue=False``) produces records
   bit-identical to the non-preemptive engine for every policy × pool ×
   cap — segmentation itself is free.
2. **Conservation** — per job, Σ segment ``work_frac`` = 1 (work is never
   lost or double-run; segments are contiguous ``0..k`` with exactly one
   final, non-preempted record), and every record's billed energy equals
   its duration × measured draw plus its explicit checkpoint/restore
   joules — Σ segment energies *is* the job's bill.
3. **No overlap, grants shrink at boundaries** — a preempted device is
   busy only through the checkpoint; its records never overlap the
   successor's, and under a power cap the running grant's lease is
   truncated to the boundary
   (:meth:`~repro_torch.core.powercap.PowerCapCoordinator.truncate`) so the
   granted-view ledger never charges watts past the preemption.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .prediction_service import ClockTable
from .workload import Job, edf_key

__all__ = ["PreemptionConfig", "PreemptionStats", "PreemptionManager"]


@dataclasses.dataclass(frozen=True)
class PreemptionConfig:
    """Knobs for the rescue machinery.

    Overheads are charged explicitly: a preemption extends the truncated
    segment by ``checkpoint_s`` seconds (billed at the segment's measured
    draw) plus ``checkpoint_j`` joules; a resume prepends ``restore_s``
    seconds (billed at the resumed segment's draw) plus ``restore_j``
    joules. Both also inflate the remnant's predicted times, so the
    re-dispatch decision prices the overhead it is about to pay."""

    #: Checkpoint cost: wall seconds appended to the truncated segment,
    #: plus flat joules on top of duration x measured draw.
    checkpoint_s: float = 0.05
    checkpoint_j: float = 0.0
    #: Restore cost: wall seconds prepended to a resumed segment, plus
    #: flat joules on top of duration x measured draw.
    restore_s: float = 0.05
    restore_j: float = 0.0
    #: Fallback quantum (s) for jobs without ``checkpoint_quantum``; None
    #: leaves such jobs uninterruptible.
    default_quantum: Optional[float] = None
    #: Predicted-miss margin for the rescue trigger: the committed plan is
    #: "in trouble" when now + remaining x (1 + margin) exceeds the
    #: deadline (insurance against prediction noise re-firing rescues).
    margin: float = 0.05
    #: Enable the two trigger families independently (both off = the
    #: differential harness's segmented-but-never-preempted mode).
    self_rescue: bool = True
    queue_rescue: bool = True
    #: A job is never preempted more than this many times (remnant storms
    #: are bounded), nor when less than ``min_remnant_frac`` of its work
    #: would remain (checkpointing a nearly-done job is pure overhead).
    max_preemptions: int = 8
    min_remnant_frac: float = 0.05


@dataclasses.dataclass
class PreemptionStats:
    boundaries: int = 0         # segment boundaries visited
    checks: int = 0             # boundaries where triggers were evaluated
    declined: int = 0           # boundaries where every trigger declined
    preemptions: int = 0        # segments actually truncated
    self_rescues: int = 0       # preemptions fired by the job's own miss
    queue_rescues: int = 0      # preemptions fired for a stranded queue job
    tier_rescues: int = 0       # queue rescues where the head's SLA tier
    #                             outranked the victim's (counted inside
    #                             queue_rescues, not in addition)
    cap_rescues: int = 0        # self-rescues needing a bigger power grant
    migrations: int = 0         # resumes that landed on a different class
    rack_migrations: int = 0    # resumes that landed on a different rack
    #                             (only a federation-aware manager ever
    #                             marks a record migrated)
    resumes: int = 0            # remnant segments dispatched
    overhead_s: float = 0.0     # total checkpoint+restore seconds billed
    overhead_j: float = 0.0     # total explicit checkpoint+restore joules

    def summary(self) -> str:
        return (f"boundaries={self.boundaries} checks={self.checks} "
                f"preempt={self.preemptions} (self={self.self_rescues} "
                f"queue={self.queue_rescues} [tier={self.tier_rescues}] "
                f"cap={self.cap_rescues}) "
                f"declined={self.declined} resumes={self.resumes} "
                f"migrations={self.migrations} "
                f"rack_migrations={self.rack_migrations} "
                f"overhead={self.overhead_s:.2f}s/{self.overhead_j:.0f}J")


class PreemptionManager:
    """Owns the preempt/continue decision and the remnant bookkeeping.

    Stateless across jobs except for statistics and a per-class ladder
    index cache; the engine drives it:

    * ``quantum_of(job)`` — seconds between checkpoint opportunities
      (None = uninterruptible);
    * ``remnant_view(table, job)`` — a job's prediction table with
      remaining-work scaling and restore overhead folded into ``T`` (the
      lens every remnant decision — clock, class, cap filter, sprint —
      looks through);
    * ``scale_t(job, t)`` — the same scaling for scalar sprint/DC times
      (budget managers, coordinator slack weights);
    * ``decide(engine, seg, t_b, queue, running)`` — the rescue verdict at
      a segment boundary: a reason string to preempt, or None to
      continue.
    """

    def __init__(self, config: Optional[PreemptionConfig] = None):
        self.config = config or PreemptionConfig()
        self.stats = PreemptionStats()
        self._lidx: dict[Optional[str], dict] = {}
        self._prev_class: dict[int, Optional[str]] = {}
        self._prev_dev: dict[int, int] = {}

    def reset(self) -> None:
        self.stats = PreemptionStats()
        self._lidx.clear()
        self._prev_class.clear()
        self._prev_dev.clear()

    def note_preempt(self, remnant: Job, seg) -> None:
        """Remember where the remnant came from (migration accounting)."""
        self._prev_class[id(remnant)] = seg.class_key
        self._prev_dev[id(remnant)] = seg.dev

    def note_resume(self, job: Job, record) -> None:
        """A remnant was re-dispatched; bill its restore overhead and
        count a migration when it landed on a different device class."""
        self.stats.resumes += 1
        self.stats.overhead_s += record.overhead_s
        self.stats.overhead_j += record.overhead_j
        if self._prev_class.pop(id(job), None) != record.device_class:
            self.stats.migrations += 1
        self._prev_dev.pop(id(job), None)
        if getattr(record, "migrated", False):
            self.stats.rack_migrations += 1

    # -- federation hooks ----------------------------------------------- #
    # The engine drives these at every dispatch/boundary; the base manager
    # answers with the identity on each one, so a non-federated run never
    # changes a float — the same lever-off contract as every other
    # subsystem. :class:`~repro_torch.core.federation.
    # FederatedPreemptionManager` overrides them with StragglerMonitor-driven
    # detection, degradation truth, migration billing, and device
    # quarantine.
    def slowdown_of(self, dev: int) -> float:
        """Multiplicative execution-time degradation of device ``dev``
        (truth side). 1.0 = healthy; the engine multiplies realized
        compute time by this factor."""
        return 1.0

    def mitigate_clock(self, dev: int, clock, dvfs):
        """Chance to override the committed clock for a dispatch on
        ``dev`` (e.g. a straggler-mitigation boost). Must return ``clock``
        itself — the same object — when not intervening; the engine keys
        its recompute on identity, not equality."""
        return clock

    def migration_cost(self, job: Job, dev: int):
        """``(seconds, joules, source_rack)`` a remnant re-dispatch on
        ``dev`` pays for moving its checkpoint. ``source_rack`` None means
        no cross-rack move (and the zero costs are not billed at all)."""
        return (0.0, 0.0, None)

    def note_step(self, dev: int, observed_s: float,
                  predicted_s: Optional[float]) -> None:
        """Telemetry feed: one dispatched segment's observed compute
        seconds vs its predicted seconds on ``dev``. No-op here."""

    def retire(self, reason: str, dev: int) -> bool:
        """After a preemption fired with ``reason``, may the engine
        permanently quarantine ``dev`` (True = do not re-enter the free
        heap)? The base manager never retires a device."""
        return False

    # -- remnant lenses ------------------------------------------------- #
    def quantum_of(self, job: Job) -> Optional[float]:
        q = job.checkpoint_quantum
        if q is None:
            q = self.config.default_quantum
        if q is None or not q > 0:
            return None
        return float(q)

    def is_remnant(self, job: Job) -> bool:
        return job.segment > 0

    def remnant_view(self, table: Optional[ClockTable],
                     job: Job) -> Optional[ClockTable]:
        """``table`` through :meth:`ClockTable.remnant` — remaining-work
        scaling plus the restore overhead. For a fresh, whole job this
        returns the table object untouched (the identity lever)."""
        if table is None or (job.segment == 0 and job.work_frac == 1.0):
            return table
        return table.remnant(job.work_frac, self.config.restore_s)

    def scale_t(self, job: Job, t: float) -> float:
        """Scalar analogue of :meth:`remnant_view` for point estimates
        (sprint / default-clock times)."""
        if job.segment == 0 and job.work_frac == 1.0:
            return t
        return t * job.work_frac + self.config.restore_s

    # -- the rescue decision -------------------------------------------- #
    def _clock_index(self, table: ClockTable, class_key,
                     clock) -> Optional[int]:
        idx = self._lidx.get(class_key)
        if idx is None or len(idx) != len(table.clocks):
            idx = {c: i for i, c in enumerate(table.clocks)}
            self._lidx[class_key] = idx
        return idx.get(clock)

    def decide(self, engine, seg, t_b: float, queue,
               running) -> Optional[str]:
        """Preempt verdict for the segment ``seg`` at boundary ``t_b``.

        Returns a reason (``"self-rescue"`` / ``"cap-rescue"`` /
        ``"queue-rescue"``) or None to continue. Never mutates engine
        state — a declined boundary leaves the run bit-identical to one
        that never looked."""
        cfg = self.config
        self.stats.boundaries += 1
        rem = seg.remaining_at(t_b)
        if (rem < cfg.min_remnant_frac
                or seg.job.segment >= cfg.max_preemptions):
            return None
        if not (cfg.self_rescue or cfg.queue_rescue):
            return None
        self.stats.checks += 1
        job = seg.job
        overhead = cfg.checkpoint_s + cfg.restore_s
        tab = engine._table_for(job, seg.device_class)
        coord = engine.power_coordinator
        i = (None if tab is None
             else self._clock_index(tab, seg.class_key, seg.clock))

        # -- 1. self / cap rescue: the committed clock now misses ------- #
        if cfg.self_rescue and tab is not None and i is not None:
            pred_rem = rem * float(tab.T[i])
            if engine.policy.rescue_trigger(t_b, job.deadline, pred_rem,
                                            margin=cfg.margin):
                # savable? fastest clock on this ladder that a retry could
                # power (escalation may reclaim watts, so probe the
                # coordinator's non-mutating upper bound)
                T = np.asarray(tab.T) * rem + overhead
                ok = T <= (job.deadline - t_b) + 1e-12
                if coord is not None:
                    avail = coord.potential_w(seg.dev)
                    ok &= np.asarray(tab.P) * (1 + coord.guard) <= avail + 1e-9
                if ok.any():
                    best = float(np.min(np.where(ok, T, np.inf)))
                    # strict improvement: the rescue must beat riding the
                    # committed clock, overheads included
                    if best < pred_rem - 1e-12:
                        needs_watts = (
                            coord is not None and seg.grant is not None
                            and np.isfinite(seg.grant)
                            and float(np.min(np.where(
                                ok, np.asarray(tab.P), np.inf)))
                            * (1 + coord.guard) > seg.grant + 1e-9)
                        if needs_watts:
                            self.stats.cap_rescues += 1
                            return "cap-rescue"
                        self.stats.self_rescues += 1
                        return "self-rescue"

        # -- 2. queue rescue: a stranded urgent job can be saved -------- #
        if cfg.queue_rescue and queue:
            # most urgent job that has *arrived* by this boundary: the
            # engine's empty-queue bump can admit future arrivals before
            # an earlier boundary event is processed, and a job that is
            # not there yet cannot start at t_b — preempting for it would
            # idle the device and throw away the victim's progress
            arrived = [ent for ent in queue
                       if ent[2].arrival <= t_b + 1e-12]
            head = min(arrived)[2] if arrived else None
            t_head = (engine._t_min_est(head, seg.device_class)
                      if head is not None else None)
            # the rescued head must also outrank the would-be remnant
            # under the dispatch key (the remnant re-enters with the
            # victim's tier + deadline and a fresh, larger counter — ties
            # go to the head): otherwise the freed device would just pop
            # the remnant again and the checkpoint bought nothing. The
            # key is tier-aware: an urgent SLO head outranks a
            # best-effort victim even with a *later* absolute deadline —
            # within one tier this is exactly the old deadline test.
            if head is not None and edf_key(head) > edf_key(job):
                head, t_head = None, None
            if t_head is not None:
                t_head = self.scale_t(head, t_head)
                # head is queued, so every device is occupied; the best it
                # can do without preemption is the earliest running end
                busy = [s.end for s in running.values() if not s.done]
                if len(busy) == engine.n_devices:
                    wait_start = min(busy)
                    misses_waiting = engine.policy.rescue_trigger(
                        wait_start, head.deadline, t_head, margin=cfg.margin)
                    start_here = t_b + cfg.checkpoint_s
                    saved_here = (start_here + t_head
                                  <= head.deadline + 1e-12)
                    if misses_waiting and saved_here:
                        victim_ok = victim_doomed = False
                        if tab is not None:
                            t_back = start_here + t_head + cfg.restore_s
                            v_sprint = rem * float(np.min(tab.T))
                            victim_ok = (t_back + v_sprint
                                         <= job.deadline + 1e-12)
                            if i is not None and not victim_ok:
                                # already past saving even untouched
                                victim_doomed = (
                                    t_b + rem * float(np.min(tab.T))
                                    > job.deadline + 1e-12)
                        if victim_ok or victim_doomed:
                            self.stats.queue_rescues += 1
                            if head.tier.priority > job.tier.priority:
                                self.stats.tier_rescues += 1
                            return "queue-rescue"

        self.stats.declined += 1
        return None
