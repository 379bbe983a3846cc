"""TPU DVFS model: clock ladders, voltage curve, two-domain power model.

The paper targets a Tesla P100 with 62 SM clocks x 1 memory clock. The TPU
adaptation keeps the paper's two frequency domains:

* **core domain** — MXU/VPU (the GPU "SM clock" analogue). Scaling it scales
  peak FLOP/s.
* **memory domain** — HBM (the GPU "mem clock" analogue). Scaling it scales
  HBM bandwidth. (The P100 had a single memory clock; the paper explicitly
  predicts multi-mem-clock hardware would benefit — our 4-step HBM ladder
  exercises that.)

Clock scales are expressed relative to nominal (1.0 = the v5e-class chip that
delivers 197 TFLOP/s bf16 and 819 GB/s HBM). Voltage tracks core frequency
through a piecewise-linear curve with a floor: frequency steps below the floor
share a voltage rail, exactly the behavior the paper notes ("certain frequency
ranges can share the same voltage level") — this produces the non-trivial
energy-vs-frequency shape at the low end (P grows only linearly in f there, so
racing slightly faster can cost near-zero energy).

Dynamic power per domain follows the paper's Eq. 1, P_dyn proportional to V^2*f,
gated by that domain's utilization.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = [
    "ClockPair",
    "DVFSConfig",
    "DeviceClass",
    "V5E_DVFS",
    "V5E_CLASS",
    "V5P_CLASS",
    "V5LITE_CLASS",
    "DEVICE_CLASSES",
]


@dataclasses.dataclass(frozen=True, order=True)
class ClockPair:
    """A (core, memory) clock setting, as scales relative to nominal."""

    s_core: float
    s_mem: float

    @property
    def core_mhz(self) -> int:
        return int(round(940 * self.s_core))  # 940 MHz nominal core

    @property
    def mem_mhz(self) -> int:
        return int(round(3200 * self.s_mem))  # 3.2 GHz nominal HBM

    def key(self) -> tuple[int, int]:
        return (self.core_mhz, self.mem_mhz)


@dataclasses.dataclass(frozen=True)
class DVFSConfig:
    """Clock ladder + electrical model for one accelerator generation."""

    # --- nominal performance (v5e-class) ------------------------------- #
    peak_flops: float = 197e12        # bf16 FLOP/s per chip at s_core = 1.0
    hbm_bw: float = 819e9             # B/s per chip at s_mem = 1.0
    ici_bw: float = 50e9              # B/s per link (collective roofline)

    # --- ladders -------------------------------------------------------- #
    core_scales: tuple = tuple(np.round(np.linspace(0.40, 1.10, 16), 4))
    mem_scales: tuple = (0.55, 0.70, 0.85, 1.00)
    default_core: float = 0.90        # "default application clock" analogue
    default_mem: float = 1.00

    # --- electrical model ------------------------------------------------ #
    # Calibrated so: peak ~210 W at max clocks fully utilized, idle floor
    # ~12% of peak (P100-class), and the energy-vs-core-clock curve for a
    # compute-bound app dips at ~0.5-0.6x nominal — the regime the paper's
    # scheduler exploits (racing costs V^2, crawling costs static-time).
    p_static: float = 25.0            # W, leakage + board overhead
    a_core: float = 140.0             # W at V=1, s=1, full core utilization
    a_mem: float = 45.0               # W at V=1, s=1, full mem utilization
    v_floor: float = 0.70             # shared low-voltage rail
    v_slope: float = 0.55             # V(s) = max(v_floor, 0.45 + v_slope*s)
    idle_core_frac: float = 0.12      # clock-tree power at zero utilization
    idle_mem_frac: float = 0.15

    # ------------------------------------------------------------------ #
    def voltage(self, s_core: float) -> float:
        return max(self.v_floor, 0.45 + self.v_slope * s_core)

    def voltage_mem(self, s_mem: float) -> float:
        return max(0.80, 0.60 + 0.40 * s_mem)

    def clock_list(self) -> list[ClockPair]:
        """All supported clock pairs, ascending (mem-major, then core) —
        the documented iteration order of Algorithm 1's inner loop."""
        return [
            ClockPair(float(c), float(m))
            for m in self.mem_scales
            for c in self.core_scales
        ]

    @property
    def default_clock(self) -> ClockPair:
        return ClockPair(self.default_core, self.default_mem)

    @property
    def max_clock(self) -> ClockPair:
        return ClockPair(max(self.core_scales), max(self.mem_scales))

    @property
    def min_clock(self) -> ClockPair:
        return ClockPair(min(self.core_scales), min(self.mem_scales))

    # ------------------------------------------------------------------ #
    def power(self, clock: ClockPair, u_core: float, u_mem: float) -> float:
        """Chip power (W) for a clock pair at given domain utilizations.

        P = P_static + a_core * V(f_c)^2 * f_c * g(u_core)
                     + a_mem  * V_m(f_m)^2 * f_m * g(u_mem)
        with g(u) = idle_frac + (1 - idle_frac) * u  (clock tree burns power
        even when the domain stalls — why racing a memory-bound app's core
        clock wastes energy, the exact effect the paper's Fig. 10 calls out).
        """
        vc = self.voltage(clock.s_core)
        vm = self.voltage_mem(clock.s_mem)
        g_c = self.idle_core_frac + (1 - self.idle_core_frac) * float(np.clip(u_core, 0, 1))
        g_m = self.idle_mem_frac + (1 - self.idle_mem_frac) * float(np.clip(u_mem, 0, 1))
        return (
            self.p_static
            + self.a_core * vc * vc * clock.s_core * g_c
            + self.a_mem * vm * vm * clock.s_mem * g_m
        )


V5E_DVFS = DVFSConfig()


# ---------------------------------------------------------------------- #
#  Device classes — heterogeneous pools
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class DeviceClass:
    """One accelerator generation in a heterogeneous pool.

    Wraps a full :class:`DVFSConfig` (its own ladder + electrical model)
    plus the scalars that summarize it relative to the v5e baseline —
    placement policies and pool builders reason about classes, never about
    raw configs. ``name`` keys every per-(app, class) cache in the
    prediction service and the online adapter, so names must be unique
    within a pool.

    ``idle_power_w`` is the power a device of this class burns while it
    sits in the free heap with no job — pool-level accounting only (job
    energy already includes the chip's static power during execution).
    """

    name: str
    dvfs: DVFSConfig
    perf_scale: float = 1.0       # peak-FLOPs multiple of the v5e baseline
    bw_scale: float = 1.0         # HBM-bandwidth multiple of the baseline
    idle_power_w: float = V5E_DVFS.p_static

    def idle_power(self) -> float:
        """Draw (W) of a device of this class holding no job — the single
        source of truth for idle intervals: the simulator's truth path
        (:meth:`~repro_torch.core.simulator.Testbed.idle_power`) reads the
        idle floor through this accessor."""
        return self.idle_power_w

    @classmethod
    def derive(
        cls,
        name: str,
        base: DVFSConfig = V5E_DVFS,
        perf_scale: float = 1.0,
        bw_scale: float = 1.0,
        core_power_scale: float | None = None,
        mem_power_scale: float | None = None,
        p_static: float | None = None,
        idle_power_w: float | None = None,
        **dvfs_overrides,
    ) -> "DeviceClass":
        """Scale a baseline config into a new generation.

        ``perf_scale``/``bw_scale`` multiply peak FLOP/s and HBM bandwidth;
        the power coefficients default to scaling with them (same J/FLOP,
        J/byte) unless ``core_power_scale``/``mem_power_scale`` say
        otherwise — a big *efficient* chip passes a power scale below its
        perf scale. Ladder/voltage fields pass through ``dvfs_overrides``.
        """
        cfg = dataclasses.replace(
            base,
            peak_flops=base.peak_flops * perf_scale,
            hbm_bw=base.hbm_bw * bw_scale,
            a_core=base.a_core * (perf_scale if core_power_scale is None
                                  else core_power_scale),
            a_mem=base.a_mem * (bw_scale if mem_power_scale is None
                                else mem_power_scale),
            p_static=base.p_static if p_static is None else p_static,
            **dvfs_overrides,
        )
        return cls(name=name, dvfs=cfg, perf_scale=perf_scale,
                   bw_scale=bw_scale,
                   idle_power_w=(cfg.p_static if idle_power_w is None
                                 else idle_power_w))


#: The baseline chip — wraps :data:`V5E_DVFS` unchanged, so a pool of only
#: this class is the uniform testbed every pre-heterogeneity benchmark ran.
V5E_CLASS = DeviceClass("v5e", V5E_DVFS)

#: Big, *efficient* chip: ~2.3x FLOP/s and ~3.3x HBM bandwidth, at power
#: coefficients below those scale factors (better J/FLOP and J/byte) but a
#: much higher static floor — racing a tiny job here wastes the floor,
#: which is exactly the placement trade-off heterogeneous scheduling must
#: weigh (Mei et al., arXiv:2104.00486).
V5P_CLASS = DeviceClass.derive(
    "v5p", perf_scale=2.3, bw_scale=3.3,
    core_power_scale=1.8, mem_power_scale=2.2,
    p_static=60.0)

#: Small, low-power chip: under half the throughput with a coarser ladder
#: (8 core x 3 mem steps — per-class ladders are first-class, and the low
#: end reaches into the shared-voltage-rail plateau) and a ~10 W static
#: floor. Slack-rich memory-light jobs are cheapest here.
V5LITE_CLASS = DeviceClass.derive(
    "v5lite", perf_scale=0.45, bw_scale=0.55,
    core_power_scale=0.55, mem_power_scale=0.60,
    p_static=10.0,
    core_scales=tuple(np.round(np.linspace(0.35, 1.00, 8), 4)),
    mem_scales=(0.60, 0.80, 1.00),
    default_core=0.85)

#: Registry of the stock classes (pools may mix in custom ones freely).
DEVICE_CLASSES: dict[str, DeviceClass] = {
    c.name: c for c in (V5E_CLASS, V5P_CLASS, V5LITE_CLASS)
}
