"""Hierarchical multi-rack federation: facility caps, grant escalation,
and straggler-driven cross-rack migration.

One :class:`~repro_torch.core.powercap.PowerCapCoordinator` models one rack.
Real deployments of the paper's data-driven DVFS idea run across *racks*
under a shared facility power envelope (cf. arXiv:2104.00486 on
DVFS-enabled heterogeneous clusters), where deadline-aware frequency
scaling must coordinate groups of devices: watts a cold rack is not using
should rescue deadlines on a hot one, and a degraded device's work should
move to healthy hardware instead of missing in place. This module scales
the single-rack coordinator out into that hierarchy:

* :class:`RackCoordinator` — a thin wrapper owning one
  :class:`~repro_torch.core.powercap.PowerCapCoordinator` plus its contiguous
  device slice (global device index = rack offset + local index).
* :class:`FacilityCoordinator` — duck-types the engine's
  ``power_coordinator`` interface and owns the racks. It splits a
  facility-wide cap into per-rack caps (:data:`FACILITY_SHARE_POLICIES`):
  ``static`` (idle floor + device-count share, fixed for the episode),
  ``demand-weighted`` (unallocated facility headroom follows the racks
  with *free* devices — absorption capacity, where the engine's next
  dispatch can actually commit watts — re-split at every ``advance``),
  and
  ``tier-weighted`` (headroom follows the SLA-tier weight of each rack's
  running grants — the tier weighted-fairness discipline lifted one
  level up). **Hierarchical grant escalation**: a rack that cannot
  rescue a deadline locally via ``escalate()`` requests headroom from
  the facility, which first hands over any unassigned facility watts and
  then reclaims *unallocated* cap from sibling racks
  (:meth:`~repro_torch.core.powercap.PowerCapCoordinator.release_cap`,
  richest spare capacity first) — cap moves between racks, never watts a
  running grant already holds.
* :class:`FederatedPreemptionManager` — the scheduler half of
  :class:`~repro_torch.dist.fault_tolerance.StragglerMonitor`, wired into the
  preemptive engine's federation hooks: per-device observed/
  predicted step-time ratios feed the monitor; a flagged device first
  gets a **mitigation clock boost** one ladder rung per dispatch; a
  device still straggling at the top of the ladder
  (:meth:`~repro_torch.dist.fault_tolerance.StragglerMonitor.should_evict`)
  triggers **rescue-migration**: its running segment is checkpointed
  (the preemption machinery), the device is quarantined, and the remnant
  re-enters the EDF queue to be re-scored — class, clock, grant — on a
  healthy rack, billed a :class:`MigrationCostModel` transfer cost
  (checkpoint-size seconds at the destination's draw + explicit joules)
  when it lands cross-rack.

Invariants (held against the reference by tests/test_torch_federation.py):

1.  **Facility cap safety** — Σ per-rack caps never exceeds the facility
    cap (rebalancing re-splits exactly, escalation conserves — every
    watt one rack gains another rack or the unassigned pool lost), so
    the facility-wide granted-view ledger peak stays ≤ the facility cap
    for every share × grant policy.
2.  **Single-rack identity** — a 1-rack federation assigns the facility
    cap to its one rack *exactly* (no idle-split arithmetic), never
    rebalances, and forwards every engine call verbatim: the run is
    bit-identical to the bare ``PowerCapCoordinator`` engine for all six
    policies (the honesty anchor — the hierarchy is provably free when
    there is no hierarchy).
3.  **No device overlap** — racks partition the pool; every global
    device index belongs to exactly one rack and records never migrate
    *work*, only checkpointed remnants (Σ ``work_frac`` per job is
    exactly 1 across racks — the preemption layer's conservation rule).
4.  **Quarantine never strands work** — rescue-migration refuses to
    retire the last in-service device, and a quarantined device's
    remnant re-enters the queue before the device leaves the heap.
"""
from __future__ import annotations

import dataclasses
import math
from typing import TYPE_CHECKING, Callable, Iterable, Optional, Sequence

import numpy as np

from .dvfs import ClockPair, DeviceClass, DVFSConfig
from .powercap import GRANT_POLICIES, PowerCapCoordinator
from .preemption import PreemptionConfig, PreemptionManager
from .workload import Job, TIERS

if TYPE_CHECKING:  # the runtime import is lazy (_fresh_monitor) to keep
    # ``repro_torch.dist`` → ``repro_torch.core.dvfs`` → ``repro_torch.core``
    # → ``federation`` from becoming a circular import
    from ..dist.fault_tolerance import StragglerMonitor

__all__ = [
    "FACILITY_SHARE_POLICIES",
    "RackTopology",
    "MigrationCostModel",
    "FacilityStats",
    "RackCoordinator",
    "FacilityCoordinator",
    "FederatedStats",
    "FederatedPreemptionManager",
]

#: How the facility splits its cap into per-rack caps.
FACILITY_SHARE_POLICIES: tuple[str, ...] = (
    "static", "demand-weighted", "tier-weighted")


@dataclasses.dataclass(frozen=True)
class RackTopology:
    """Contiguous partition of the device pool into racks.

    Global device ``d`` lives on the rack whose slice covers it; racks
    are numbered in slice order. Frozen — the topology is fixed for a
    federation's lifetime (devices do not move between racks; *work*
    does, via remnant migration)."""

    rack_sizes: tuple[int, ...]
    offsets: tuple[int, ...] = dataclasses.field(init=False)

    def __post_init__(self):
        sizes = tuple(int(s) for s in self.rack_sizes)
        if not sizes or any(s < 1 for s in sizes):
            raise ValueError(f"rack_sizes must be positive: {sizes!r}")
        offs, acc = [], 0
        for s in sizes:
            offs.append(acc)
            acc += s
        object.__setattr__(self, "rack_sizes", sizes)
        object.__setattr__(self, "offsets", tuple(offs))

    @property
    def n_racks(self) -> int:
        return len(self.rack_sizes)

    @property
    def n_devices(self) -> int:
        return self.offsets[-1] + self.rack_sizes[-1]

    def rack_of(self, dev: int) -> int:
        if not 0 <= dev < self.n_devices:
            raise IndexError(f"device {dev} outside pool of "
                             f"{self.n_devices}")
        for r in range(self.n_racks - 1, -1, -1):
            if dev >= self.offsets[r]:
                return r
        raise AssertionError  # pragma: no cover

    def local_of(self, dev: int) -> int:
        return dev - self.offsets[self.rack_of(dev)]

    def devices_of(self, rack: int) -> range:
        return range(self.offsets[rack],
                     self.offsets[rack] + self.rack_sizes[rack])


@dataclasses.dataclass(frozen=True)
class MigrationCostModel:
    """Cost of moving a checkpointed remnant between racks.

    The checkpoint is the job's device-resident state, proxied by its
    :attr:`~repro_torch.core.simulator.AppProfile.hbm_bytes` clamped at
    ``max_bytes`` (``hbm_bytes`` is per-run HBM *traffic*; resident
    state cannot exceed the device's memory, so the ceiling defaults to
    a 32 GB HBM footprint). Moving it costs ``overhead_s + bytes×8 /
    (link_gbps×1e9)`` wall seconds (billed at the destination device's
    draw — the device sits in restore while the checkpoint streams in)
    plus ``joules_per_gb × bytes/1e9`` explicit joules (NIC/switch
    transfer + (de)serialization energy, drawn outside the device
    envelope)."""

    link_gbps: float = 200.0
    overhead_s: float = 0.05
    joules_per_gb: float = 25.0
    max_bytes: float = 32e9

    def cost(self, ckpt_bytes: float) -> tuple[float, float]:
        gb = min(max(float(ckpt_bytes), 0.0), self.max_bytes) / 1e9
        secs = self.overhead_s + gb * 8.0 / self.link_gbps
        return secs, self.joules_per_gb * gb


@dataclasses.dataclass
class FacilityStats:
    escalations: int = 0       # rack escalations forwarded to the facility
    rescues: int = 0           # forwarded escalations fully covered
    transfers: int = 0         # sibling cap transfers executed
    transferred_w: float = 0.0  # total watts moved between rack caps
    rebalances: int = 0        # share-policy cap re-splits

    def summary(self) -> str:
        return (f"escalations={self.escalations} rescues={self.rescues} "
                f"transfers={self.transfers} "
                f"transferred={self.transferred_w:.0f}W "
                f"rebalances={self.rebalances}")


class RackCoordinator:
    """One rack: a :class:`PowerCapCoordinator` plus its device slice.

    Deliberately thin — all grant mechanics live in the wrapped
    coordinator; the rack only owns the global↔local index mapping and
    its slice bounds. The facility resizes :attr:`coord`'s cap when
    shares rebalance or escalation moves headroom between racks."""

    def __init__(self, index: int, offset: int, size: int,
                 coord: PowerCapCoordinator):
        self.index = int(index)
        self.offset = int(offset)
        self.size = int(size)
        self.coord = coord

    def local(self, dev: int) -> int:
        local = dev - self.offset
        if not 0 <= local < self.size:
            raise IndexError(
                f"device {dev} not on rack {self.index} "
                f"[{self.offset}, {self.offset + self.size})")
        return local

    @property
    def cap_w(self) -> float:
        return self.coord.cap_w

    @property
    def spare_w(self) -> float:
        """Cap this rack could cede right now without touching a running
        grant: free headroom + reclaimable grant slack."""
        return self.coord.headroom_w + self.coord.reclaimable_w

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"RackCoordinator({self.index}, devs=[{self.offset}.."
                f"{self.offset + self.size}), cap={self.coord.cap_w:.0f}W)")


class FacilityCoordinator:
    """Facility-wide power cap federated over per-rack coordinators.

    Duck-types the engine's ``power_coordinator`` interface (``reset`` /
    ``advance`` / ``offer`` / ``escalate`` / ``commit`` / ``truncate`` /
    ``next_release`` / ``potential_w`` / ``idle_of`` / ``guard``) by
    routing every device-addressed call to the owning rack's coordinator
    with the local index. On top of that routing it adds the two
    facility-level behaviors:

    * **cap shares** (``share_policy``): the initial split assigns each
      rack its idle floor plus a device-count share of the burnable
      watts; ``demand-weighted``/``tier-weighted`` re-split unallocated
      headroom at every ``advance`` (allocated grants are each rack's
      floor — rebalancing never claws back committed watts);
    * **hierarchical escalation**: when a rack's own ``escalate`` cannot
      cover a deadline-rescue need, the facility tops it up from the
      unassigned pool and then from sibling racks' spare cap, richest
      first, and retries locally.

    A 1-rack facility takes none of these paths: the rack's cap is the
    facility cap *assigned exactly* (no split arithmetic — float
    identity matters), rebalancing and escalation forwarding are
    structurally skipped, and every call delegates verbatim — the
    single-rack bit-identity lever (invariant 2)."""

    def __init__(
        self,
        cap_w: float,
        rack_sizes: Sequence[int],
        share_policy: str = "demand-weighted",
        grant_policy: str = "slack-weighted",
        guard: float = 0.1,
        slack_eps: float = 1e-3,
        t_min_fn: Optional[Callable] = None,
        escalation: bool = True,
        demand_free_weight: float = 3.0,
    ):
        if share_policy not in FACILITY_SHARE_POLICIES:
            raise ValueError(
                f"unknown share policy {share_policy!r}; choose from "
                f"{FACILITY_SHARE_POLICIES}")
        if grant_policy not in GRANT_POLICIES:
            raise ValueError(f"unknown grant policy {grant_policy!r}; "
                             f"choose from {GRANT_POLICIES}")
        if not cap_w > 0:
            raise ValueError("cap_w must be positive (use math.inf to "
                             "disable enforcement)")
        self.cap_w = float(cap_w)
        self.topology = RackTopology(tuple(int(s) for s in rack_sizes))
        self.share_policy = share_policy
        self.grant_policy = grant_policy
        self.guard = float(guard)
        self.escalation = bool(escalation)
        self.demand_free_weight = float(demand_free_weight)
        self.t_min_fn = t_min_fn
        self.racks: list[RackCoordinator] = [
            RackCoordinator(i, off, size, PowerCapCoordinator(
                self.cap_w, grant_policy=grant_policy, guard=guard,
                slack_eps=slack_eps))
            for i, (off, size) in enumerate(
                zip(self.topology.offsets, self.topology.rack_sizes))
        ]
        self.stats = FacilityStats()
        self._grant_tiers: dict[int, float] = {}

    # -- topology routing ---------------------------------------------- #
    @property
    def n_racks(self) -> int:
        return self.topology.n_racks

    @property
    def n_devices(self) -> int:
        return self.topology.n_devices

    def rack_of(self, dev: int) -> int:
        return self.topology.rack_of(dev)

    def _route(self, dev: int) -> tuple[RackCoordinator, int]:
        rack = self.racks[self.topology.rack_of(dev)]
        return rack, rack.local(dev)

    def caps(self) -> list[float]:
        """Current per-rack caps (Σ ≤ facility cap, invariant 1)."""
        return [r.coord.cap_w for r in self.racks]

    def rack_stats(self):
        """Per-rack :class:`~repro_torch.core.powercap.CoordinatorStats`."""
        return [r.coord.stats for r in self.racks]

    # -- engine duck interface ------------------------------------------ #
    def reset(self, idle_powers: Sequence[float],
              t_min_fn: Optional[Callable] = None,
              device_classes: Optional[Sequence[DeviceClass]] = None,
              ) -> None:
        idle = [float(x) for x in idle_powers]
        if len(idle) != self.n_devices:
            raise ValueError(
                f"pool of {len(idle)} devices does not match topology "
                f"{self.topology.rack_sizes} ({self.n_devices} devices)")
        self.stats = FacilityStats()
        self._grant_tiers = {}
        fn = self.t_min_fn if self.t_min_fn is not None else t_min_fn
        if self.n_racks == 1:
            # exact assignment, no split arithmetic: `idle + (F − idle)`
            # is not `F` in floats, and the single-rack run must be
            # bit-identical to the bare coordinator (invariant 2)
            caps = [self.cap_w]
        elif not math.isfinite(self.cap_w):
            caps = [math.inf] * self.n_racks
        else:
            idle_r = [math.fsum(idle[d] for d in
                                self.topology.devices_of(r))
                      for r in range(self.n_racks)]
            burn = self.cap_w - math.fsum(idle_r)
            if burn < -1e-9:
                raise ValueError(
                    f"facility cap {self.cap_w:.1f}W is below the pool's "
                    f"idle floor {math.fsum(idle_r):.1f}W — no schedule "
                    "can satisfy it")
            burn = max(burn, 0.0)
            n = self.n_devices
            caps = [idle_r[r] + burn * self.topology.rack_sizes[r] / n
                    for r in range(self.n_racks)]
            # the last rack absorbs the float residual so Σ caps is the
            # facility cap exactly (never above it)
            caps[-1] = max(self.cap_w - math.fsum(caps[:-1]), idle_r[-1])
        for rack, cap_r in zip(self.racks, caps):
            rack.coord.cap_w = float(cap_r)
            lo, size = rack.offset, rack.size
            rack.coord.reset(
                idle[lo:lo + size], t_min_fn=fn,
                device_classes=(None if device_classes is None
                                else list(device_classes[lo:lo + size])))

    def advance(self, t: float) -> None:
        for rack in self.racks:
            rack.coord.advance(t)
        if self.n_racks > 1:
            if self._grant_tiers:
                live = set()
                for rack in self.racks:
                    live.update(rack.offset + d
                                for d in rack.coord.active_grants())
                self._grant_tiers = {d: w for d, w in
                                     self._grant_tiers.items() if d in live}
            if (self.share_policy != "static"
                    and math.isfinite(self.cap_w)):
                self._rebalance()

    def _rebalance(self) -> None:
        """Re-split unallocated facility headroom across racks by the
        share policy's weights. Each rack's floor is its currently
        allocated watts — committed grants are never clawed back, only
        free cap moves. Σ new caps == facility cap exactly (the last
        rack takes the float residual, floored at its allocations)."""
        floors = [r.coord.allocated_w for r in self.racks]
        dist = self.cap_w - math.fsum(floors)
        if dist < 0.0:
            dist = 0.0
        bw = self.demand_free_weight
        if self.share_policy == "demand-weighted":
            # watts follow *absorption capacity*: the engine dispatches
            # onto free devices, so spare cap belongs where devices are
            # free to commit it. Weighting by busy devices instead is
            # actively harmful — a degraded rack's long-running grants
            # would attract watts it cannot use (its devices are all
            # leased) while healthy, churning racks starve.
            weights = [1.0 + bw * max(
                rack.size - len(rack.coord.active_grants()), 0)
                for rack in self.racks]
        else:  # tier-weighted
            weights = [
                rack.size + bw * math.fsum(
                    self._grant_tiers.get(rack.offset + d, 1.0)
                    for d in rack.coord.active_grants())
                for rack in self.racks]
        total = math.fsum(weights)
        if total <= 0:
            weights = [float(rack.size) for rack in self.racks]
            total = math.fsum(weights)
        caps = [f + dist * w / total for f, w in zip(floors, weights)]
        caps[-1] = max(self.cap_w - math.fsum(caps[:-1]), floors[-1])
        for rack, cap_r in zip(self.racks, caps):
            rack.coord.resize_cap(cap_r)
        self.stats.rebalances += 1

    def offer(self, dev: int, job: Job, start: float,
              queue: Iterable = ()) -> float:
        rack, local = self._route(dev)
        return rack.coord.offer(local, job, start, queue)

    def escalate(self, dev: int, needed_w: float, start: float) -> float:
        """Deadline rescue, hierarchically: the rack first (reclaiming
        its own unused grants), then — if it still cannot cover the need
        — the facility moves spare cap in from the unassigned pool and
        sibling racks (richest spare first) and the rack retries. Cap
        transfers conserve invariant 1 by construction: the requester
        gains exactly what the pool and siblings lost."""
        rack, local = self._route(dev)
        got = rack.coord.escalate(local, needed_w, start)
        if (got >= needed_w - 1e-9 or self.n_racks == 1
                or not self.escalation or not math.isfinite(self.cap_w)):
            return got
        self.stats.escalations += 1
        deficit = needed_w - got
        pool = self.cap_w - math.fsum(r.coord.cap_w for r in self.racks)
        if pool > 1e-12:
            take = min(pool, deficit)
            rack.coord.resize_cap(rack.coord.cap_w + take)
            deficit -= take
        if deficit > 1e-12:
            siblings = sorted(
                (r for r in self.racks if r is not rack),
                key=lambda r: r.spare_w, reverse=True)
            for sib in siblings:
                if deficit <= 1e-12:
                    break
                give = sib.coord.release_cap(deficit)
                if give > 0.0:
                    rack.coord.resize_cap(rack.coord.cap_w + give)
                    deficit -= give
                    self.stats.transfers += 1
                    self.stats.transferred_w += give
        got = rack.coord.escalate(local, needed_w, start)
        if got >= needed_w - 1e-9:
            self.stats.rescues += 1
        return got

    def commit(self, dev: int, request_w: float, end: float,
               drawn_w: float, record=None) -> float:
        rack, local = self._route(dev)
        grant = rack.coord.commit(local, request_w, end, drawn_w,
                                  record=record)
        if self.share_policy == "tier-weighted":
            tier = getattr(record, "tier", None)
            spec = TIERS.get(tier) if tier is not None else None
            self._grant_tiers[dev] = 1.0 if spec is None else spec.weight
        return grant

    def truncate(self, dev: int, end: float) -> None:
        rack, local = self._route(dev)
        rack.coord.truncate(local, end)

    def next_release(self, t: float) -> Optional[float]:
        ends = [e for e in (r.coord.next_release(t) for r in self.racks)
                if e is not None]
        return min(ends) if ends else None

    def potential_w(self, dev: int) -> float:
        """Upper bound on what a preempt-and-retry on ``dev`` could
        obtain: the rack's own potential, plus — when hierarchical
        escalation is live — every sibling's spare cap and the
        unassigned facility pool (escalation could move all of it in)."""
        rack, local = self._route(dev)
        base = rack.coord.potential_w(local)
        if (self.n_racks == 1 or not self.escalation
                or not math.isfinite(self.cap_w)):
            return base
        pool = max(self.cap_w
                   - math.fsum(r.coord.cap_w for r in self.racks), 0.0)
        extra = math.fsum(r.spare_w for r in self.racks if r is not rack)
        return base + pool + extra

    def idle_of(self, dev: int) -> float:
        rack, local = self._route(dev)
        return rack.coord.idle_of(local)

    @property
    def allocated_w(self) -> float:
        return math.fsum(r.coord.allocated_w for r in self.racks)

    @property
    def headroom_w(self) -> float:
        return max(self.cap_w - self.allocated_w, 0.0)

    def active_grants(self) -> dict[int, tuple[float, float, float]]:
        """Running grants with *global* device keys."""
        out: dict[int, tuple[float, float, float]] = {}
        for rack in self.racks:
            for d, ent in rack.coord.active_grants().items():
                out[rack.offset + d] = ent
        return out


# ---------------------------------------------------------------------- #
#  Straggler-driven federation-aware preemption
# ---------------------------------------------------------------------- #
@dataclasses.dataclass
class FederatedStats:
    observations: int = 0      # step-time samples fed to the monitor
    boosts: int = 0            # dispatches with a mitigation clock boost
    rescue_migrations: int = 0  # evictions fired at a segment boundary
    quarantined: int = 0       # devices retired from the pool
    migration_s: float = 0.0   # checkpoint-transfer seconds billed
    migration_j: float = 0.0   # checkpoint-transfer joules billed

    def summary(self) -> str:
        return (f"obs={self.observations} boosts={self.boosts} "
                f"rescue_migrations={self.rescue_migrations} "
                f"quarantined={self.quarantined} migration="
                f"{self.migration_s:.2f}s/{self.migration_j:.0f}J")


class FederatedPreemptionManager(PreemptionManager):
    """Preemption manager that knows the rack topology and drives the
    engine's federation hooks.

    Three roles on top of the base rescue machinery:

    * **degradation truth** — ``device_slowdown`` injects per-device
      execution-time stretch factors (the simulated fault:
      :meth:`slowdown_of` multiplies realized compute time);
    * **detection & mitigation** — observed/predicted step-time ratios
      from every dispatch feed a
      :class:`~repro_torch.dist.fault_tolerance.StragglerMonitor`
      (:meth:`note_step`); a flagged device's next dispatch gets its
      committed clock boosted one core-ladder rung
      (:meth:`mitigate_clock`), escalating per dispatch until the top of
      the ladder. Detection is observation-driven only — the injected
      truth is never consulted;
    * **rescue-migration & quarantine** — a device still flagged at max
      boost (``should_evict``) has its running segment checkpointed at
      the next boundary (:meth:`decide` returns ``"rescue-migration"``)
      and is quarantined (:meth:`retire`) — unless it is the last
      in-service device (invariant 4). The remnant re-enters the EDF
      queue and is re-scored wherever it lands; a cross-rack landing is
      billed the :class:`MigrationCostModel` (:meth:`migration_cost`)
      and counted in ``stats.rack_migrations``.

    Mitigation and eviction need the monitor's clock ladder to be the
    pool's ladder, so they are restricted to pools whose active DVFS
    config matches ``dvfs`` (classless pools, or explicit pools of one
    class); on a foreign ladder the boost is skipped, never mis-stepped.
    With ``dvfs=None`` the monitor is disabled and only the topology /
    migration-billing roles remain active."""

    def __init__(
        self,
        rack_sizes: Sequence[int],
        config: Optional[PreemptionConfig] = None,
        cost_model: Optional[MigrationCostModel] = None,
        device_slowdown: Optional[dict[int, float]] = None,
        dvfs: Optional[DVFSConfig] = None,
        straggler_threshold: float = 1.3,
        ema_alpha: float = 0.3,
    ):
        super().__init__(config)
        self.topology = (rack_sizes if isinstance(rack_sizes, RackTopology)
                         else RackTopology(tuple(int(s)
                                                 for s in rack_sizes)))
        self.cost_model = cost_model or MigrationCostModel()
        self.device_slowdown = dict(device_slowdown or {})
        self.dvfs = dvfs
        self.straggler_threshold = float(straggler_threshold)
        self.ema_alpha = float(ema_alpha)
        self.fed = FederatedStats()
        self.monitor: Optional[StragglerMonitor] = None
        self._quarantined: set[int] = set()
        self._obs = np.ones(self.topology.n_devices)
        self._fresh_monitor()

    def _fresh_monitor(self) -> None:
        if self.dvfs is not None:
            from ..dist.fault_tolerance import StragglerMonitor
            self.monitor = StragglerMonitor(
                self.topology.n_devices, self.dvfs,
                threshold=self.straggler_threshold,
                ema_alpha=self.ema_alpha)
        else:
            self.monitor = None

    def reset(self) -> None:
        super().reset()
        self.fed = FederatedStats()
        self._quarantined = set()
        self._obs = np.ones(self.topology.n_devices)
        self._fresh_monitor()

    # -- topology ------------------------------------------------------- #
    def rack_of(self, dev: int) -> int:
        return self.topology.rack_of(dev)

    @property
    def quarantined(self) -> frozenset[int]:
        return frozenset(self._quarantined)

    # -- degradation truth ---------------------------------------------- #
    def slowdown_of(self, dev: int) -> float:
        return float(self.device_slowdown.get(dev, 1.0))

    # -- detection & mitigation ----------------------------------------- #
    def note_step(self, dev: int, observed_s: float,
                  predicted_s: Optional[float]) -> None:
        """One dispatched segment's compute seconds vs the prediction.
        Ratios near 1 are healthy (noise); a degraded device's ratio
        tracks its slowdown. Table-free policies provide no prediction —
        the device's last ratio simply persists (no detection signal,
        no false one either)."""
        if self.monitor is None:
            return
        if predicted_s is not None and predicted_s > 0:
            self._obs[dev] = float(observed_s) / float(predicted_s)
        self.fed.observations += 1
        self.monitor.observe(self._obs)

    def _ladder_matches(self, dvfs: Optional[DVFSConfig]) -> bool:
        if dvfs is None:
            return True    # classless pool: the monitor's ladder IS the
        #                    testbed ladder the manager was built with
        return tuple(dvfs.core_scales) == tuple(
            self.monitor.dvfs.core_scales)

    def mitigate_clock(self, dev: int, clock: ClockPair,
                       dvfs: Optional[DVFSConfig]) -> ClockPair:
        mon = self.monitor
        if (mon is None or dev not in mon.flagged
                or not self._ladder_matches(dvfs)):
            return clock
        prev = mon.boosts.get(dev)
        # escalate from the highest rung already tried, not the policy's
        # fresh pick — otherwise an energy-greedy policy re-picking a low
        # clock would pin the boost to its first rung forever and the
        # eviction threshold (top of ladder) would never be reached
        core = (clock.s_core if prev is None
                else max(clock.s_core, prev.s_core))
        new = mon.mitigation_clock(dev, ClockPair(core, clock.s_mem))
        if new.s_core > clock.s_core:
            self.fed.boosts += 1
            return new
        return clock

    # -- rescue-migration & quarantine ---------------------------------- #
    def _spare_devices(self) -> int:
        return self.topology.n_devices - len(self._quarantined) - 1

    def decide(self, engine, seg, t_b: float, queue,
               running) -> Optional[str]:
        mon, cfg = self.monitor, self.config
        if (mon is not None and mon.should_evict(seg.dev)
                and seg.remaining_at(t_b) >= cfg.min_remnant_frac
                and seg.job.segment < cfg.max_preemptions
                and self._spare_devices() >= 1):
            self.stats.boundaries += 1
            self.stats.checks += 1
            self.fed.rescue_migrations += 1
            return "rescue-migration"
        return super().decide(engine, seg, t_b, queue, running)

    def retire(self, reason: str, dev: int) -> bool:
        if reason != "rescue-migration":
            return False
        if self._spare_devices() < 1:
            return False   # never strand work on an empty pool
        self._quarantined.add(dev)
        self.fed.quarantined += 1
        return True

    # -- migration billing ---------------------------------------------- #
    def migration_cost(self, job: Job, dev: int):
        src_dev = self._prev_dev.get(id(job))
        if src_dev is None:
            return (0.0, 0.0, None)
        src = self.topology.rack_of(src_dev)
        if src == self.topology.rack_of(dev):
            return (0.0, 0.0, None)
        secs, joules = self.cost_model.cost(
            getattr(job.app, "hbm_bytes", 0.0))
        self.fed.migration_s += secs
        self.fed.migration_j += joules
        return (secs, joules, src)
