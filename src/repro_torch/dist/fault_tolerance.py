"""Fault tolerance: checkpointed restart loop + DVFS straggler mitigation.

Two pieces, as the reference's ``repro/dist/fault_tolerance.py``:

* :class:`TrainingRunner` — a restartable training loop. State is
  checkpointed every ``ckpt_interval`` steps *before* the step executes, so
  a failure at step ``s`` resumes from the last multiple of the interval
  and replays deterministically (synthetic data is a pure function of the
  step index, so a restarted run is bit-exact). :class:`FailureInjector`
  raises :class:`SimulatedFailure` at chosen steps (each trigger fires
  once) to exercise the restart path. The port's train step updates the
  parameters and optimizer state in place, so a restart copies the
  checkpoint into the live state
  (:func:`repro_torch.ckpt.checkpoint.restore_into`); it never relies on
  the caller's initial objects being unchanged.

* :class:`StragglerMonitor` — fleet-health application of the paper's DVFS
  machinery: per-replica EMA of step time relative to the fleet median; a
  replica whose EMA exceeds ``threshold`` is flagged and gets a core-clock
  boost one ladder step at a time
  (:meth:`StragglerMonitor.mitigation_clock`). A replica still straggling
  at max clock is beyond what frequency can fix (bad host, bad HBM) and
  :meth:`StragglerMonitor.should_evict` recommends eviction. The
  federation layer
  (:class:`~repro_torch.core.federation.FederatedPreemptionManager`) runs
  one over the devices of a multi-rack pool.

Host code, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

from ..ckpt import checkpoint as ckpt
from ..core.dvfs import ClockPair, DVFSConfig

__all__ = [
    "SimulatedFailure",
    "FailureInjector",
    "RunnerConfig",
    "TrainingRunner",
    "StragglerMonitor",
]


class SimulatedFailure(RuntimeError):
    """Injected failure standing in for a preemption / hardware fault."""


class FailureInjector:
    """Raise :class:`SimulatedFailure` the first time each step in
    ``fail_at`` is reached (one-shot per step, like a transient fault)."""

    def __init__(self, fail_at: Sequence[int] = ()):
        self._pending = set(int(s) for s in fail_at)

    def maybe_fail(self, step: int) -> None:
        if step in self._pending:
            self._pending.discard(step)
            raise SimulatedFailure(f"injected failure at step {step}")


@dataclasses.dataclass(frozen=True)
class RunnerConfig:
    ckpt_dir: str
    ckpt_interval: int = 10
    max_restarts: int = 3


class TrainingRunner:
    """Restartable train loop: ``step_fn(params, opt, batch) → (params,
    opt, metrics)``; ``data_fn(step) → batch`` must be deterministic in
    ``step``."""

    def __init__(
        self,
        cfg: RunnerConfig,
        step_fn: Callable,
        data_fn: Callable[[int], dict],
        injector: Optional[FailureInjector] = None,
    ):
        self.cfg = cfg
        self.step_fn = step_fn
        self.data_fn = data_fn
        self.injector = injector
        self.restarts = 0

    def run(self, params, opt_state, start_step: int, stop_step: int):
        """Steps ``[start_step, stop_step)``; returns (params, opt_state,
        the last step's metrics). A :class:`SimulatedFailure` restores the
        latest checkpoint into the live state and replays from its step;
        more than ``max_restarts`` failures re-raise."""
        state = {"params": params, "opt": opt_state}
        metrics = None
        s = start_step
        while s < stop_step:
            try:
                if (s - start_step) % self.cfg.ckpt_interval == 0:
                    ckpt.save(self.cfg.ckpt_dir, s, state)
                if self.injector is not None:
                    self.injector.maybe_fail(s)
                batch = self.data_fn(s)
                p, o, metrics = self.step_fn(state["params"], state["opt"],
                                             batch)
                state = {"params": p, "opt": o}
                s += 1
            except SimulatedFailure:
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                latest = ckpt.latest_step(self.cfg.ckpt_dir)
                if latest is None:   # the state may be half-updated
                    raise
                ckpt.restore_into(self.cfg.ckpt_dir, state, step=latest)
                s = latest
        return state["params"], state["opt"], metrics


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
