"""Fault tolerance: DVFS straggler mitigation.

:class:`StragglerMonitor` — fleet-health application of the paper's DVFS
machinery: per-replica EMA of step time relative to the fleet median; a
replica whose EMA exceeds ``threshold`` is flagged and gets a core-clock
boost one ladder step at a time (:meth:`StragglerMonitor.mitigation_clock`).
A replica still straggling at max clock is beyond what frequency can fix
(bad host, bad HBM) and :meth:`StragglerMonitor.should_evict` recommends
eviction. The federation layer
(:class:`~repro_torch.core.federation.FederatedPreemptionManager`) runs one
over the devices of a multi-rack pool.

Host numpy, as in the reference. The reference module's checkpointed
restart loop (``TrainingRunner``, ``FailureInjector``) comes with the
training substrate (ROADMAP §1.13).
"""
from __future__ import annotations

import numpy as np

from ..core.dvfs import ClockPair, DVFSConfig

__all__ = ["StragglerMonitor"]


class StragglerMonitor:
    """Detect slow replicas and propose DVFS boosts (paper's knob, pointed at
    fleet health instead of energy)."""

    def __init__(self, n_replicas: int, dvfs: DVFSConfig,
                 threshold: float = 1.3, ema_alpha: float = 0.3):
        self.n_replicas = n_replicas
        self.dvfs = dvfs
        self.threshold = float(threshold)
        self.ema_alpha = float(ema_alpha)
        self.ema = np.ones(n_replicas, dtype=np.float64)
        self.flagged: list[int] = []
        self.boosts: dict[int, ClockPair] = {}

    def observe(self, step_times) -> list[int]:
        """Feed one round of per-replica step times; returns flagged ids."""
        t = np.asarray(step_times, dtype=np.float64)
        assert t.shape == (self.n_replicas,)
        ratio = t / max(float(np.median(t)), 1e-12)
        self.ema = self.ema_alpha * ratio + (1 - self.ema_alpha) * self.ema
        self.flagged = [int(i) for i in np.nonzero(
            self.ema > self.threshold)[0]]
        # recovery resets the mitigation ladder: a replica whose EMA
        # drops back under threshold starts from scratch if it ever
        # degrades again (and can no longer trip should_evict on a stale
        # max-clock boost)
        for r in list(self.boosts):
            if r not in self.flagged:
                del self.boosts[r]
        return self.flagged

    def mitigation_clock(self, replica: int, current: ClockPair) -> ClockPair:
        """Next core-clock ladder step up for a straggling replica (memory
        clock untouched — stragglers are usually compute/thermal)."""
        ladder = sorted(self.dvfs.core_scales)
        higher = [s for s in ladder if s > current.s_core]
        new = ClockPair(higher[0] if higher else ladder[-1], current.s_mem)
        self.boosts[replica] = new
        return new

    def should_evict(self, replica: int) -> bool:
        """Still straggling at max core clock → DVFS can't fix it."""
        boost = self.boosts.get(replica)
        if boost is None or replica not in self.flagged:
            return False
        return boost.s_core >= max(self.dvfs.core_scales)
