"""Ground-truth testbed simulator — the Grid'5000/P100 stand-in.

The paper measures power/time on real hardware; this container has no
DVFS-capable accelerator, so the *measurement substrate* is simulated. The
simulator is deliberately richer than anything exposed to the learned models:

* roofline time base (compute / memory / collective terms) with a *smooth*
  max (domains partially overlap, as on real chips);
* per-application **nonlinear responses**: seeded smooth Fourier "wiggles" in
  both time and power, plus optional resonance spikes (clock-domain-crossing
  penalties) — reproducing the paper's Fig. 1 (lavaMD's erratic response,
  CORR's non-convex energy valley);
* stall sensitivity: apps with dependency stalls gain little from core clock
  (the paper's backprop/particlefilter observation that faster execution does
  not always need the highest frequency);
* multiplicative measurement noise.

The learned predictors see only (a) profiling counters at the default clock
and (b) the clock pair — they must *learn* the nonlinear map, which is the
paper's entire premise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .dvfs import ClockPair, DeviceClass, DVFSConfig, V5E_DVFS

__all__ = ["AppProfile", "Measurement", "Testbed"]


@dataclasses.dataclass(frozen=True)
class AppProfile:
    """Latent ground-truth characteristics of one application (one run)."""

    name: str
    flops: float                  # useful FLOPs per chip per run
    hbm_bytes: float              # HBM traffic per chip per run
    coll_bytes: float = 0.0       # collective bytes per chip per run
    overhead_s: float = 0.05      # serial launch/host overhead
    kind: str = "kernel"          # kernel | train | prefill | decode
    n_chips: int = 1

    # latent nonlinearity knobs (hidden from the predictor's feature set)
    wiggle_time: float = 0.04     # amplitude of smooth time nonlinearity
    wiggle_power: float = 0.03
    spike: float = 0.0            # resonance spike amplitude (lavaMD-style)
    stall_frac: float = 0.0       # fraction of compute cycles stalled
    core_eff: float = 0.92        # achievable fraction of peak FLOP/s
    mem_eff: float = 0.88         # achievable fraction of peak bandwidth
    seed: int = 0

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)


@dataclasses.dataclass(frozen=True)
class Measurement:
    time_s: float
    power_w: float

    @property
    def energy_j(self) -> float:
        return self.time_s * self.power_w


def _wiggle(seed: int, amp: float, x: float, y: float, n_terms: int = 4) -> float:
    """Smooth seeded 2D pseudo-random function in [-amp, amp]."""
    if amp <= 0:
        return 0.0
    rng = np.random.default_rng(seed)
    ks = rng.uniform(0.5, 3.0, size=(n_terms, 2))
    phase = rng.uniform(0, 2 * np.pi, size=n_terms)
    w = rng.normal(size=n_terms)
    w /= np.sqrt((w ** 2).sum()) + 1e-12
    val = float(np.sum(w * np.sin(2 * np.pi * (ks[:, 0] * x + ks[:, 1] * y) + phase)))
    return amp * val / np.sqrt(2)


class Testbed:
    """Simulated DVFS-capable accelerator fleet (the measurement substrate)."""

    __test__ = False  # not a pytest class

    def __init__(
        self,
        dvfs: DVFSConfig = V5E_DVFS,
        noise: float = 0.01,
        seed: int = 0,
    ):
        self.dvfs = dvfs
        self.noise = float(noise)
        self._rng = np.random.default_rng(seed)

    # ------------------------------------------------------------------ #
    #  Noiseless ground truth
    # ------------------------------------------------------------------ #
    def true_time(self, app: AppProfile, clock: ClockPair,
                  dvfs: Optional[DVFSConfig] = None) -> float:
        d = dvfs or self.dvfs
        # effective throughputs at this clock
        flops_rate = d.peak_flops * clock.s_core * app.core_eff
        # dependency stalls make a fraction of compute insensitive to clock
        t_compute = (1 - app.stall_frac) * app.flops / flops_rate + (
            app.stall_frac * app.flops / (d.peak_flops * app.core_eff)
        )
        t_mem = app.hbm_bytes / (d.hbm_bw * clock.s_mem * app.mem_eff)
        t_coll = app.coll_bytes / d.ici_bw
        # smooth max: overlap between domains is imperfect on real chips
        p = 8.0
        terms = np.array([t_compute, t_mem, t_coll, 1e-12])
        t_base = float((terms ** p).sum() ** (1.0 / p))
        w = _wiggle(app.seed * 7919 + 13, app.wiggle_time, clock.s_core, clock.s_mem)
        s = 0.0
        if app.spike > 0:
            rng = np.random.default_rng(app.seed * 104729 + 3)
            c = rng.uniform(0.5, 1.05)
            width = rng.uniform(0.03, 0.08)
            s = app.spike * float(np.exp(-((clock.s_core - c) ** 2) / (2 * width ** 2)))
        return t_base * (1.0 + w + s) + app.overhead_s

    def _utilizations(self, app: AppProfile, clock: ClockPair, t_total: float,
                      dvfs: Optional[DVFSConfig] = None):
        d = dvfs or self.dvfs
        t_busy_core = app.flops / (d.peak_flops * clock.s_core * app.core_eff)
        t_busy_mem = app.hbm_bytes / (d.hbm_bw * clock.s_mem * app.mem_eff)
        u_core = min(t_busy_core / max(t_total, 1e-12), 1.0)
        u_mem = min(t_busy_mem / max(t_total, 1e-12), 1.0)
        return u_core, u_mem

    def true_power(self, app: AppProfile, clock: ClockPair,
                   dvfs: Optional[DVFSConfig] = None) -> float:
        d = dvfs or self.dvfs
        t = self.true_time(app, clock, dvfs=d)
        u_core, u_mem = self._utilizations(app, clock, t, dvfs=d)
        base = d.power(clock, u_core, u_mem)
        w = _wiggle(app.seed * 15485863 + 29, app.wiggle_power,
                    clock.s_core, clock.s_mem)
        return base * (1.0 + w)

    def true_energy(self, app: AppProfile, clock: ClockPair,
                    dvfs: Optional[DVFSConfig] = None) -> float:
        return (self.true_time(app, clock, dvfs=dvfs)
                * self.true_power(app, clock, dvfs=dvfs))

    def idle_power(self, device_class: Optional[DeviceClass] = None,
                   dvfs: Optional[DVFSConfig] = None) -> float:
        """Truth-path draw of a device holding no job.

        A device's power over simulated time is piecewise constant: *busy*
        intervals draw :meth:`true_power` (what :meth:`run` measures for
        each execution), *idle* intervals draw this floor. Explicit pools
        delegate to :meth:`DeviceClass.idle_power` — the single source of
        truth shared with the telemetry ledger and the pool-level energy
        accounting — while classless devices idle at their config's static
        floor (leakage + board overhead; the clock-tree terms gate to zero
        with no work resident)."""
        if device_class is not None:
            return device_class.idle_power()
        return (dvfs or self.dvfs).p_static

    # ------------------------------------------------------------------ #
    #  Measured (noisy) execution — what the scheduler observes
    # ------------------------------------------------------------------ #
    def run(
        self,
        app: AppProfile,
        clock: ClockPair,
        rng: Optional[np.random.Generator] = None,
        dvfs: Optional[DVFSConfig] = None,
    ) -> Measurement:
        rng = rng or self._rng
        # one time draw then one power draw per execution, regardless of
        # which device class runs the job — the engine's determinism
        # invariant (dispatch order alone fixes the RNG stream)
        t = self.true_time(app, clock, dvfs=dvfs) * (
            1 + self.noise * rng.normal())
        p = self.true_power(app, clock, dvfs=dvfs) * (
            1 + self.noise * rng.normal())
        return Measurement(time_s=max(t, 1e-6), power_w=max(p, 1.0))

    # ------------------------------------------------------------------ #
    def sweep(self, app: AppProfile, clocks=None,
              dvfs: Optional[DVFSConfig] = None) -> dict:
        """Exhaustive noiseless sweep (paper's profiling campaign)."""
        clocks = clocks or (dvfs or self.dvfs).clock_list()
        return {
            c.key(): Measurement(self.true_time(app, c, dvfs=dvfs),
                                 self.true_power(app, c, dvfs=dvfs))
            for c in clocks
        }
