"""Workload generation (paper §V-C) and the beyond-paper streams.

Arrival times: truncated normal over [1, 50] s (paper: "for the arrival time,
the minimum and maximum value range of distribution are set to (1, 50)").

Deadlines: the paper draws from a normal over (1 s, 2x default-clock execution
time). A literal lower bound of 1 s can make a job infeasible at *every*
clock; the paper's own runs evidently drew feasible deadlines (their Fig. 10
shows all jobs completing in-deadline), so we truncate at 1.0x the
default-clock completion time instead: each job's absolute deadline is

    d_abs = completion_time_under_DC_schedule + U[0.25, 1.0] * T_default

which preserves the paper's "up to 2x execution time" headroom semantics
while guaranteeing the Default-Clock baseline itself is schedulable (as in
the paper, where DC/MC meet all deadlines but burn more energy).

Host numpy throughout: every draw comes from ``np.random.default_rng``, so
a stream is the same job for job as the reference generator's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .dvfs import DeviceClass, DVFSConfig
from .simulator import AppProfile, Testbed

__all__ = ["Job", "TierSpec", "SLO_TIER", "BATCH_TIER", "BEST_EFFORT_TIER",
           "DEFAULT_TIER", "TIERS", "edf_key", "make_workload",
           "stream_workload", "drifting_workload", "drift_profile",
           "make_device_pool", "heterogeneous_workload",
           "cap_stress_workload", "rescue_stress_workload",
           "multi_tenant_workload", "multi_rack_workload",
           "serving_workload", "training_workload", "merge_workloads"]


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """A tenancy class (SLA tier) a :class:`Job` belongs to.

    ``priority`` orders tiers in the engine's dispatch queue (higher
    dispatches first — see :func:`edf_key`); ``weight`` scales the tier's
    slack-weighted share of cap headroom in the
    :class:`~repro_torch.core.powercap.PowerCapCoordinator`; ``sheddable``
    marks work an :class:`~repro_torch.core.admission.AdmissionController` may
    defer or shed under predicted overload; ``slack_range`` is the
    tier's deadline-slack draw (multiples of the app's default-clock
    time) used by :func:`multi_tenant_workload`.

    The module-level :data:`DEFAULT_TIER` (priority 0, weight 1.0, not
    sheddable) is the inert default: every pre-tier code path sees
    ``-priority == 0`` and ``weight == 1.0``, so single-tier runs stay
    bit-identical to the tierless engine.
    """
    name: str
    priority: int = 0
    weight: float = 1.0
    sheddable: bool = False
    slack_range: tuple[float, float] = (0.25, 1.0)


#: Latency-SLO inference traffic: dispatches first, largest cap share,
#: never shed, tight arrival-anchored deadlines.
SLO_TIER = TierSpec("slo", priority=2, weight=4.0, sheddable=False,
                    slack_range=(0.25, 1.0))
#: Deadline-driven batch: above best-effort, below SLO; never shed.
BATCH_TIER = TierSpec("batch", priority=1, weight=2.0, sheddable=False,
                      slack_range=(2.0, 6.0))
#: Backfill: lowest priority and weight, the only tier admission control
#: is allowed to defer or shed.
BEST_EFFORT_TIER = TierSpec("best-effort", priority=0, weight=1.0,
                            sheddable=True, slack_range=(6.0, 16.0))
#: The inert tier every untagged job carries (tierless semantics).
DEFAULT_TIER = TierSpec("default")

TIERS: dict[str, TierSpec] = {
    t.name: t for t in (SLO_TIER, BATCH_TIER, BEST_EFFORT_TIER, DEFAULT_TIER)
}


@dataclasses.dataclass
class Job:
    app: AppProfile
    arrival: float
    deadline: float            # absolute
    job_id: int = 0
    #: Seconds between checkpoint opportunities when the engine runs with
    #: a :class:`~repro_torch.core.preemption.PreemptionManager`; None = the job
    #: is uninterruptible (and on the non-preemptive engine the field is
    #: inert either way).
    checkpoint_quantum: "float | None" = None
    #: Fraction of the job's work this (remnant) entry still covers, and
    #: which resume this is. A fresh job is ``(1.0, 0)``; the preemption
    #: machinery re-enqueues remnants via ``dataclasses.replace`` with the
    #: unfinished fraction and an incremented segment. Σ dispatched
    #: fractions per job is exactly 1 (conservation invariant).
    work_frac: float = 1.0
    segment: int = 0
    #: SLA tier this job belongs to. The default tier has priority 0 /
    #: weight 1.0 / not sheddable, so untagged workloads keep tierless
    #: semantics bit-exactly. Remnant re-enqueue (``dataclasses.replace``)
    #: carries the tier automatically.
    tier: TierSpec = DEFAULT_TIER

    @property
    def name(self) -> str:
        return self.app.name


def edf_key(job: Job) -> tuple[int, float]:
    """Tier-aware EDF dispatch key: ``(-tier.priority, deadline)``.

    Higher-priority tiers dispatch strictly before lower ones; within a
    tier, ordering is the classic earliest-deadline-first. When every job
    carries the same tier (any single tier, not just the default), the
    leading component is a shared constant and tuple comparison reduces
    to plain deadline order — which is how single-tier runs stay
    bit-identical to the tierless engine."""
    return (-job.tier.priority, job.deadline)


def _truncnorm(rng, lo, hi, mu=None, sigma=None, size=None):
    mu = (lo + hi) / 2 if mu is None else mu
    sigma = (hi - lo) / 4 if sigma is None else sigma
    out = rng.normal(mu, sigma, size=size)
    return np.clip(out, lo, hi)


def make_workload(
    apps: list[AppProfile],
    testbed: Testbed,
    seed: int = 0,
    arrival_range: tuple[float, float] = (1.0, 50.0),
    slack_range: tuple[float, float] = (0.25, 1.0),
) -> list[Job]:
    """One job per application, paper-style arrivals + feasible deadlines."""
    rng = np.random.default_rng(seed)
    d: DVFSConfig = testbed.dvfs
    arrivals = np.sort(
        _truncnorm(rng, arrival_range[0], arrival_range[1], size=len(apps))
    )
    order = rng.permutation(len(apps))
    jobs = []
    # simulate the DC (default clock) schedule to anchor feasible deadlines
    now = 0.0
    for jid, (idx, arr) in enumerate(zip(order, arrivals)):
        app = apps[idx]
        t_def = testbed.true_time(app, d.default_clock)
        now = max(now, arr) + t_def
        slack = rng.uniform(*slack_range) * t_def
        jobs.append(Job(app=app, arrival=float(arr),
                        deadline=float(now + slack), job_id=jid))
    return jobs


def stream_workload(
    apps: list[AppProfile],
    testbed: Testbed,
    n_jobs: int = 1000,
    seed: int = 0,
    mean_interarrival: float | None = None,
    slack_range: tuple[float, float] = (0.25, 1.0),
    n_devices: int = 1,
    utilization: float = 0.8,
):
    """Open-ended Poisson job stream — a *generator*, never materialized.

    The large-scale / online-arrival path of the event engine: jobs are
    yielded in nondecreasing arrival order, app sampled uniformly per job.
    Deadlines follow :func:`make_workload`'s DC-anchoring, generalized to
    ``n_devices``: a virtual default-clock schedule is advanced on the
    earliest-free virtual device and the deadline is its completion plus a
    uniform slack — so the fleet-wide DC baseline stays (approximately)
    schedulable at the configured ``utilization`` (fraction of aggregate DC
    throughput consumed by the arrival rate).
    """
    rng = np.random.default_rng(seed)
    d: DVFSConfig = testbed.dvfs
    t_dc = np.array([testbed.true_time(a, d.default_clock) for a in apps])
    if mean_interarrival is None:
        mean_interarrival = float(t_dc.mean()) / (n_devices * utilization)
    dev_free = np.zeros(n_devices)
    now = 0.0
    for jid in range(n_jobs):
        now += float(rng.exponential(mean_interarrival))
        idx = int(rng.integers(len(apps)))
        dev = int(np.argmin(dev_free))     # virtual DC dispatch
        done = max(dev_free[dev], now) + t_dc[idx]
        dev_free[dev] = done
        slack = float(rng.uniform(*slack_range)) * t_dc[idx]
        yield Job(app=apps[idx], arrival=now, deadline=float(done + slack),
                  job_id=jid)


def make_device_pool(*spec: tuple[DeviceClass, int]) -> list[DeviceClass]:
    """Flatten a ``(DeviceClass, count)`` spec into the positional pool the
    engine consumes: ``make_device_pool((V5P_CLASS, 2), (V5E_CLASS, 4))``
    → ``[v5p, v5p, v5e, v5e, v5e, v5e]``. Device indices are positions in
    this list — spec order is dispatch tie-break order."""
    pool: list[DeviceClass] = []
    for cls, count in spec:
        if count < 0:
            raise ValueError(f"negative device count for {cls.name!r}")
        pool.extend([cls] * count)
    if not pool:
        raise ValueError("empty device pool")
    return pool


def heterogeneous_workload(
    apps: list[AppProfile],
    testbed: Testbed,
    pool: list[DeviceClass],
    n_jobs: int = 1000,
    seed: int = 0,
    mean_interarrival: float | None = None,
    slack_range: tuple[float, float] = (0.25, 1.0),
    utilization: float = 0.8,
):
    """:func:`stream_workload` generalized to a heterogeneous pool.

    Deadlines keep the DC-anchoring guarantee *on the mixed pool*: a
    virtual default-clock schedule dispatches each job to the
    earliest-free virtual device (tie-break: pool position, mirroring the
    engine) and the deadline is that device's completion plus a uniform
    slack share of its class's default-clock time — so the pool-wide
    "every device at its default clock" baseline stays approximately
    schedulable at the configured ``utilization``. The same job list can
    then be replayed against uniform single-class pools for paired
    comparisons (the bench_hetero protocol)."""
    rng = np.random.default_rng(seed)
    t_dc: dict[str, np.ndarray] = {}
    for cls in pool:
        if cls.name not in t_dc:
            t_dc[cls.name] = np.array([
                testbed.true_time(a, cls.dvfs.default_clock, dvfs=cls.dvfs)
                for a in apps])
    if mean_interarrival is None:
        # aggregate DC throughput: each device serves 1/mean(t_dc) jobs/s
        rate = sum(1.0 / float(t_dc[cls.name].mean()) for cls in pool)
        mean_interarrival = 1.0 / (rate * utilization)
    dev_free = np.zeros(len(pool))
    now = 0.0
    for jid in range(n_jobs):
        now += float(rng.exponential(mean_interarrival))
        idx = int(rng.integers(len(apps)))
        dev = int(np.argmin(dev_free))      # virtual DC dispatch
        t_cls = float(t_dc[pool[dev].name][idx])
        done = max(float(dev_free[dev]), now) + t_cls
        dev_free[dev] = done
        slack = float(rng.uniform(*slack_range)) * t_cls
        yield Job(app=apps[idx], arrival=now, deadline=done + slack,
                  job_id=jid)


def cap_stress_workload(
    apps: list[AppProfile],
    testbed: Testbed,
    pool: list[DeviceClass],
    n_jobs: int = 240,
    seed: int = 0,
    burst: int | None = None,
    mean_interburst: float | None = None,
    slack_range: tuple[float, float] = (0.05, 0.4),
    utilization: float = 0.85,
):
    """Bursty arrival stream sized to overrun a cluster power cap.

    The power-budget stress case (:mod:`~repro_torch.core.powercap`): arrivals
    come in **bursts** of ``burst`` simultaneous jobs (default: one per
    device), so right after each burst every device is busy at once and an
    *uncapped* pool draws roughly the sum of per-device sprint power — the
    aggregate spike a finite cap must reshape. Deadline slack is kept tight
    (default 5–40% of the class default-clock time, vs. the Poisson
    stream's 25–100%), so uncapped policies race clocks high and the
    coordinator has real urgency differences to redistribute headroom
    around.

    Deadlines keep :func:`heterogeneous_workload`'s DC-anchoring guarantee
    on the mixed pool (virtual default-clock schedule, earliest-free
    virtual device, pool-position tie-break), so the pool-wide
    default-clock baseline stays approximately schedulable at the
    configured ``utilization`` — misses under a cap are the cap's doing,
    not an infeasible workload. A generator, yielded in nondecreasing
    arrival order like every stream here.
    """
    rng = np.random.default_rng(seed)
    if burst is None:
        burst = len(pool)
    if burst < 1:
        raise ValueError("burst must be >= 1")
    t_dc: dict[str, np.ndarray] = {}
    for cls in pool:
        if cls.name not in t_dc:
            t_dc[cls.name] = np.array([
                testbed.true_time(a, cls.dvfs.default_clock, dvfs=cls.dvfs)
                for a in apps])
    if mean_interburst is None:
        # aggregate DC throughput, as in heterogeneous_workload, but the
        # load arrives `burst` jobs at a time
        rate = sum(1.0 / float(t_dc[cls.name].mean()) for cls in pool)
        mean_interburst = burst / (rate * utilization)
    dev_free = np.zeros(len(pool))
    now, jid = 0.0, 0
    while jid < n_jobs:
        now += float(rng.exponential(mean_interburst))
        for _ in range(min(burst, n_jobs - jid)):
            idx = int(rng.integers(len(apps)))
            dev = int(np.argmin(dev_free))      # virtual DC dispatch
            t_cls = float(t_dc[pool[dev].name][idx])
            done = max(float(dev_free[dev]), now) + t_cls
            dev_free[dev] = done
            slack = float(rng.uniform(*slack_range)) * t_cls
            yield Job(app=apps[idx], arrival=now, deadline=done + slack,
                      job_id=jid)
            jid += 1


def multi_rack_workload(
    apps: list[AppProfile],
    testbed: Testbed,
    n_devices: int = 64,
    n_jobs: int = 10_000,
    seed: int = 0,
    burst: int | None = None,
    mean_interburst: float | None = None,
    slack_range: tuple[float, float] = (0.08, 0.5),
    utilization: float = 0.8,
    quantum_frac: float = 0.25,
    dvfs: DVFSConfig | None = None,
    device_classes: list[DeviceClass] | None = None,
):
    """Bursty checkpointable stream for a federated multi-rack pool.

    The federation stress case (:mod:`~repro_torch.core.federation`): an
    ``n_devices`` pool partitioned into racks by the facility
    coordinator, fed **bursts** of ``burst`` simultaneous jobs (default:
    half the pool). On a classless pool the engine's free-heap tie-break
    dispatches each burst onto the *lowest-index* free devices, so
    bursts pile onto the first racks while later racks idle; on an
    explicit heterogeneous pool (``device_classes`` — positional, like
    :func:`run_schedule`'s argument), joint placement concentrates work
    on the classes worth running, while a **static** per-rack cap split
    hands every device the *same* burn share — starving racks of
    power-hungry fast devices while racks of low-draw devices sit on
    watts they physically cannot burn. Both imbalances are precisely
    what demand-weighted rebalancing, hierarchical grant escalation,
    and cross-rack migration exist to fix.

    Deadlines keep :func:`cap_stress_workload`'s DC-anchoring guarantee
    (virtual default-clock schedule over the whole pool — per-class
    default clocks when ``device_classes`` is given, tight
    ``slack_range`` slack), so the uncapped pool-wide baseline stays
    approximately schedulable at ``utilization`` — misses under a
    facility cap are the cap split's doing, not an infeasible stream.
    Every job carries ``checkpoint_quantum = quantum_frac × t_dc`` so
    segments exist for the migration machinery to move. A generator in
    nondecreasing arrival order, like every stream here.
    """
    rng = np.random.default_rng(seed)
    if device_classes is not None:
        n_devices = len(device_classes)
    if burst is None:
        burst = max(1, n_devices // 2)
    if burst < 1:
        raise ValueError("burst must be >= 1")
    if device_classes is None:
        d = dvfs or testbed.dvfs
        t_dc_dev = [np.array([testbed.true_time(a, d.default_clock,
                                                dvfs=dvfs)
                              for a in apps])] * n_devices
        rate = n_devices / float(t_dc_dev[0].mean())
    else:
        by_cls: dict[str, np.ndarray] = {}
        for cls in device_classes:
            if cls.name not in by_cls:
                by_cls[cls.name] = np.array([
                    testbed.true_time(a, cls.dvfs.default_clock,
                                      dvfs=cls.dvfs) for a in apps])
        t_dc_dev = [by_cls[cls.name] for cls in device_classes]
        rate = sum(1.0 / float(t.mean()) for t in t_dc_dev)
    if mean_interburst is None:
        mean_interburst = burst / (rate * utilization)
    dev_free = np.zeros(n_devices)
    now, jid = 0.0, 0
    while jid < n_jobs:
        now += float(rng.exponential(mean_interburst))
        for _ in range(min(burst, n_jobs - jid)):
            idx = int(rng.integers(len(apps)))
            dev = int(np.argmin(dev_free))      # virtual DC dispatch
            t_a = float(t_dc_dev[dev][idx])
            done = max(float(dev_free[dev]), now) + t_a
            dev_free[dev] = done
            slack = float(rng.uniform(*slack_range)) * t_a
            yield Job(app=apps[idx], arrival=now, deadline=done + slack,
                      job_id=jid, checkpoint_quantum=quantum_frac * t_a)
            jid += 1


def rescue_stress_workload(
    apps: list[AppProfile],
    testbed: Testbed,
    n_jobs: int = 120,
    seed: int = 0,
    n_devices: int = 1,
    burst: int = 4,
    whale_slack: tuple[float, float] = (2.6, 3.4),
    short_slack: tuple[float, float] = (0.15, 0.45),
    gap_frac: float = 0.08,
    drain_frac: float = 0.4,
    quantum_frac: float = 0.12,
    react_s: float | None = None,
    dvfs: DVFSConfig | None = None,
):
    """Deadline-tight stream engineered to strand jobs behind long runs —
    the preemptive-rescue stress case (:mod:`~repro_torch.core.preemption`).

    The non-preemptive EDF failure mode: a long **whale** job with a
    *loose* deadline arrives into an idle pool and starts immediately (a
    min-energy policy crawls it at a cheap clock — its own deadline
    allows that); a **burst** of short, *tight*-deadline jobs arrives
    just after, queues behind the whale, and misses — EDF cannot help,
    because dispatch order is only decided when a device frees. A
    preemptive engine checkpoints the whale at its next quantum boundary
    (``checkpoint_quantum`` = ``quantum_frac`` x its default-clock time),
    runs the shorts, and resumes the remnant — the whale's loose deadline
    absorbs the detour.

    Deadline anchoring: whales get ``arrival + U[whale_slack] x t_dc``
    (generous — a resumed remnant plus overheads still fits); shorts are
    anchored on a virtual default-clock schedule of the *burst alone*
    over the full pool, as if the whale were preemptible — starting
    ``react_s`` after the burst arrives (the preemptive scheduler's
    reaction latency: one whale quantum plus a checkpoint; default
    ``quantum_frac x t_dc(whale) + 0.15``) — plus ``U[short_slack] x
    t_dc``. Every short is therefore feasible for a preemptive scheduler
    by construction, while the whale's remaining crawl (an energy-greedy
    policy stretches it far past ``react_s``) strands them on the
    non-preemptive engine. Rounds are spaced past a worst-case
    slow-clock whale plus the burst's serial span, so backlog never
    leaks across rounds and each round's misses are the stranding's
    doing. A generator in nondecreasing arrival order, like every
    stream here."""
    rng = np.random.default_rng(seed)
    d = dvfs or testbed.dvfs
    t_dc = np.array([testbed.true_time(a, d.default_clock, dvfs=dvfs)
                     for a in apps])
    order = np.argsort(t_dc)
    whale_idx = [int(i) for i in order[-max(1, len(apps) // 4):]]
    short_idx = [int(i) for i in order[:max(1, len(apps) // 2)]]
    now, jid = 0.0, 0
    while jid < n_jobs:
        # whale into an idle pool
        wi = whale_idx[int(rng.integers(len(whale_idx)))]
        t_w = float(t_dc[wi])
        slack_w = float(rng.uniform(*whale_slack))
        yield Job(app=apps[wi], arrival=now, deadline=now + slack_w * t_w,
                  job_id=jid, checkpoint_quantum=quantum_frac * t_w)
        jid += 1
        # burst of tight shorts shortly after the whale has started; their
        # anchor concedes the preemptive reaction latency (whale quantum +
        # checkpoint) before the pool is assumed free
        t_burst = now + gap_frac * t_w
        react = (quantum_frac * t_w + 0.15) if react_s is None else react_s
        dev_free = np.full(n_devices, t_burst + react)
        burst_end, serial_s = t_burst, 0.0
        for _ in range(min(burst, n_jobs - jid)):
            si = short_idx[int(rng.integers(len(short_idx)))]
            t_s = float(t_dc[si])
            dev = int(np.argmin(dev_free))     # virtual DC dispatch,
            done = float(dev_free[dev]) + t_s  # whale assumed preemptible
            dev_free[dev] = done
            slack_s = float(rng.uniform(*short_slack))
            yield Job(app=apps[si], arrival=t_burst,
                      deadline=done + slack_s * t_s, job_id=jid,
                      checkpoint_quantum=quantum_frac * t_s)
            jid += 1
            burst_end = max(burst_end, done)
            serial_s += t_s
        # next round only after even a slow-clock whale plus the whole
        # burst has drained — stranding stays within the round
        now = (max(now + 1.8 * t_w, burst_end) + serial_s
               + drain_frac * t_w)


#: Default tenant mix for :func:`multi_tenant_workload`: a thin stream of
#: latency-SLO traffic, a moderate batch band, and a flood of best-effort
#: backfill — so at 10× overload the SLO tier alone still fits inside the
#: pool's capacity (isolation is achievable) while best-effort supplies
#: the overload the admission controller must shed.
DEFAULT_TIER_MIX: tuple[tuple[TierSpec, float], ...] = (
    (SLO_TIER, 0.10), (BATCH_TIER, 0.15), (BEST_EFFORT_TIER, 0.75),
)


def multi_tenant_workload(
    apps: list[AppProfile],
    testbed: Testbed,
    n_jobs: int = 400,
    seed: int = 0,
    n_devices: int = 8,
    pool: list[DeviceClass] | None = None,
    overload: float = 1.0,
    tier_mix: tuple[tuple[TierSpec, float], ...] | None = None,
    diurnal_amp: float = 0.6,
    period_s: float | None = None,
    burst: int = 4,
    mean_interarrival: float | None = None,
    quantum_frac: float | None = None,
):
    """Diurnal/bursty multi-tenant stream — the SLA-tier stress case.

    Arrivals are a nonhomogeneous Poisson process: the base rate is
    ``overload`` × the pool's aggregate default-clock throughput
    (``overload=10`` is the bench's 10×-overload setting), modulated by a
    sinusoidal diurnal factor ``1 + diurnal_amp·sin(2πt/period_s)`` so
    load peaks and troughs like production traffic. Each arrival draws a
    tier from ``tier_mix`` (default :data:`DEFAULT_TIER_MIX`); sheddable
    (best-effort) arrivals land as **bursts** of ``burst`` simultaneous
    jobs — the backfill flood pattern admission control exists to absorb.

    Deadlines are **arrival-anchored** per tier — ``arrival +
    (1 + U[tier.slack_range]) × t_dc`` with ``t_dc`` the app's
    default-clock time on the *slowest* class in ``pool`` (conservative
    anchor) — *not* DC-schedule-anchored like :func:`stream_workload`:
    under sustained overload a virtual-DC anchor diverges with the
    backlog and every deadline becomes vacuously loose. An SLO job is
    feasible iff dispatched promptly; a starved one misses — which is
    exactly the isolation signal the tier machinery must protect.

    ``quantum_frac`` (optional) sets ``checkpoint_quantum`` to that
    fraction of each job's anchor time, making the stream preemptible
    for tier-rescue scenarios. A generator in nondecreasing arrival
    order, like every stream here.
    """
    if overload <= 0:
        raise ValueError("overload must be > 0")
    if not 0.0 <= diurnal_amp < 1.0:
        raise ValueError("diurnal_amp must be in [0, 1)")
    mix = DEFAULT_TIER_MIX if tier_mix is None else tuple(tier_mix)
    total_p = sum(p for _, p in mix)
    if total_p <= 0:
        raise ValueError("tier_mix probabilities must sum to > 0")
    cum, acc = [], 0.0
    for _, p in mix:
        acc += p / total_p
        cum.append(acc)
    rng = np.random.default_rng(seed)
    if pool is None:
        t_ref = np.array([testbed.true_time(a, testbed.dvfs.default_clock)
                          for a in apps])
        n_dev = n_devices
        rate = n_dev / float(t_ref.mean())
    else:
        n_dev = len(pool)
        t_cls = {}
        for cls in pool:
            if cls.name not in t_cls:
                t_cls[cls.name] = np.array([
                    testbed.true_time(a, cls.dvfs.default_clock,
                                      dvfs=cls.dvfs) for a in apps])
        # conservative per-app anchor: default-clock time on the slowest
        # class present — a deadline feasible even with a bad placement
        t_ref = np.max(np.stack(list(t_cls.values())), axis=0)
        rate = sum(1.0 / float(t_cls[cls.name].mean()) for cls in pool)
    if mean_interarrival is None:
        # normalize by expected jobs per draw: a sheddable draw emits a
        # whole burst, so without this the bursts would silently multiply
        # the offered load past the requested ``overload`` factor
        e_jobs = sum((p / total_p) * (burst if t.sheddable and burst > 1
                                      else 1) for t, p in mix)
        mean_interarrival = e_jobs / (rate * overload)
    if period_s is None:
        period_s = max(n_jobs * mean_interarrival / 3.0,
                       8.0 * mean_interarrival)
    now, jid = 0.0, 0
    while jid < n_jobs:
        gap = float(rng.exponential(mean_interarrival))
        mod = 1.0 + diurnal_amp * np.sin(2.0 * np.pi * now / period_s)
        now += gap / max(float(mod), 1e-9)
        u = float(rng.random())
        tier = mix[-1][0]
        for (t, _), edge in zip(mix, cum):
            if u <= edge:
                tier = t
                break
        k = burst if (tier.sheddable and burst > 1) else 1
        for _ in range(min(k, n_jobs - jid)):
            idx = int(rng.integers(len(apps)))
            t_a = float(t_ref[idx])
            slack = 1.0 + float(rng.uniform(*tier.slack_range))
            q = None if quantum_frac is None else quantum_frac * t_a
            yield Job(app=apps[idx], arrival=now,
                      deadline=now + slack * t_a, job_id=jid,
                      checkpoint_quantum=q, tier=tier)
            jid += 1


#: Default drift: a **bottleneck flip** — the app's compute shrinks while
#: its memory traffic grows (think: a new input format, or an autotuned
#: kernel that trades FLOPs for HBM traffic). Total default-clock time stays
#: in the same ballpark, but the *shape* of the time-vs-clock response
#: inverts: the true optimum moves from high-core/low-mem clocks to
#: low-core/high-mem ones. A frozen predictor keeps paying for core
#: frequency the app no longer uses — the worst case for offline DVFS and
#: exactly what measurement feedback can recover.
DEFAULT_DRIFT: dict[str, float] = {
    "flops": 0.3, "hbm_bytes": 1.55,
}


def drift_profile(app: AppProfile, factors: dict[str, float]) -> AppProfile:
    """A copy of ``app`` with the given numeric fields scaled
    multiplicatively (same ``name`` — downstream feature lookups and
    deadlines keep using the stale offline profile, which is the point)."""
    return dataclasses.replace(
        app, **{k: getattr(app, k) * v for k, v in factors.items()})


def drifting_workload(
    apps: list[AppProfile],
    testbed: Testbed,
    n_jobs: int = 1000,
    seed: int = 0,
    drift_names: list[str] | None = None,
    drift_at_frac: float = 0.4,
    drift: dict[str, float] | None = None,
    **stream_kw,
):
    """:func:`stream_workload` where some apps' *true* coefficients shift
    mid-stream (the online-adaptation stress case).

    After the first ``drift_at_frac`` fraction of the stream, every job of
    an app in ``drift_names`` (default: the first app) carries a
    :func:`drift_profile`-modified ``AppProfile`` — same name, shifted
    ground truth. The offline predictor, profiled features, and the
    DC-anchored deadlines are all computed from the *pre-drift* profile, so
    a frozen scheduler keeps consuming stale predictions while a
    measurement-feedback scheduler can re-learn the shift from completions.
    Arrivals, app sequence, and deadlines are identical to the undrifted
    stream (same ``seed``), making frozen-vs-corrected runs exactly paired.

    ``drift`` is either one ``{field: factor}`` dict applied to every
    drifting app, or a per-app ``{app_name: {field: factor}}`` mapping
    (drift_names then defaults to its keys).
    """
    factors = DEFAULT_DRIFT if drift is None else drift
    per_app = factors and all(isinstance(v, dict) for v in factors.values())
    if drift_names is None:
        drift_names = list(factors) if per_app else [apps[0].name]
    if per_app:
        unspecified = set(drift_names) - set(factors)
        if unspecified:
            raise ValueError("drift_names missing from the per-app drift "
                             f"spec: {sorted(unspecified)}")
    drifted = {
        a.name: drift_profile(
            a, factors[a.name] if per_app else factors)
        for a in apps if a.name in drift_names
    }
    unknown = set(drift_names) - set(drifted)
    if unknown:
        raise ValueError(f"drift_names not in apps: {sorted(unknown)}")
    cut = int(n_jobs * drift_at_frac)
    for i, job in enumerate(stream_workload(apps, testbed, n_jobs=n_jobs,
                                            seed=seed, **stream_kw)):
        if i >= cut and job.name in drifted:
            job = dataclasses.replace(job, app=drifted[job.name])
        yield job


def _conservative_t_ref(apps: list[AppProfile], testbed: Testbed,
                        pool: list[DeviceClass] | None, n_devices: int
                        ) -> tuple[np.ndarray, float, int]:
    """Per-app default-clock anchor time on the *slowest* class present
    (feasible even under a bad placement) plus the pool's aggregate
    default-clock throughput — the :func:`multi_tenant_workload` anchoring
    contract, shared by the serving/training generators."""
    if pool is None:
        t_ref = np.array([testbed.true_time(a, testbed.dvfs.default_clock)
                          for a in apps])
        return t_ref, n_devices / float(t_ref.mean()), n_devices
    t_cls: dict[str, np.ndarray] = {}
    for cls in pool:
        if cls.name not in t_cls:
            t_cls[cls.name] = np.array([
                testbed.true_time(a, cls.dvfs.default_clock,
                                  dvfs=cls.dvfs) for a in apps])
    t_ref = np.max(np.stack(list(t_cls.values())), axis=0)
    rate = sum(1.0 / float(t_cls[cls.name].mean()) for cls in pool)
    return t_ref, rate, len(pool)


#: Default serving tier mix: latency-SLO interactive traffic dominates,
#: with a batch band (bulk scoring) and a best-effort backfill slice.
SERVING_TIER_MIX: tuple[tuple[TierSpec, float], ...] = (
    (SLO_TIER, 0.50), (BATCH_TIER, 0.30), (BEST_EFFORT_TIER, 0.20),
)


def serving_workload(
    apps: list[AppProfile],
    testbed: Testbed,
    n_jobs: int = 400,
    seed: int = 0,
    n_devices: int = 4,
    pool: list[DeviceClass] | None = None,
    overload: float = 1.0,
    tier_mix: tuple[tuple[TierSpec, float], ...] | None = None,
    diurnal_amp: float = 0.6,
    period_s: float | None = None,
    prefill_frac: float = 0.3,
    mean_interarrival: float | None = None,
    quantum_frac: float | None = None,
):
    """Diurnal inference traffic over the model-derived suite.

    Draws only the ``decode`` apps in ``apps`` (each a generation
    segment), plus — with probability ``prefill_frac`` — a ``prefill``
    admission burst, so the stream looks like production serving: mostly
    decode, punctuated by prompt ingestion. Arrivals are the
    :func:`multi_tenant_workload` nonhomogeneous Poisson process
    (``1 + diurnal_amp·sin(2πt/period_s)`` rate modulation at ``overload``
    × the pool's aggregate default-clock throughput); each request draws
    an SLA tier from ``tier_mix`` (default :data:`SERVING_TIER_MIX`) and
    an **arrival-anchored** deadline ``arrival + (1 + U[tier.slack_range])
    × t_ref`` with ``t_ref`` the app's default-clock time on the slowest
    class in ``pool`` — the conservative anchor that keeps SLO misses a
    dispatch-latency signal rather than a backlog artifact. A generator
    in nondecreasing arrival order, like every stream here.
    """
    if not 0.0 <= prefill_frac <= 1.0:
        raise ValueError("prefill_frac must be in [0, 1]")
    decode_apps = [a for a in apps if a.kind == "decode"]
    prefill_apps = [a for a in apps if a.kind == "prefill"]
    if not decode_apps:
        raise ValueError("serving_workload needs at least one decode app")
    if not prefill_apps:
        prefill_frac = 0.0
    mix = SERVING_TIER_MIX if tier_mix is None else tuple(tier_mix)
    total_p = sum(p for _, p in mix)
    if total_p <= 0:
        raise ValueError("tier_mix probabilities must sum to > 0")
    cum, acc = [], 0.0
    for _, p in mix:
        acc += p / total_p
        cum.append(acc)
    rng = np.random.default_rng(seed)
    served = decode_apps + prefill_apps
    t_ref, rate, _ = _conservative_t_ref(served, testbed, pool, n_devices)
    if mean_interarrival is None:
        mean_interarrival = 1.0 / (rate * overload)
    if period_s is None:
        period_s = max(n_jobs * mean_interarrival / 3.0,
                       8.0 * mean_interarrival)
    now = 0.0
    for jid in range(n_jobs):
        gap = float(rng.exponential(mean_interarrival))
        mod = 1.0 + diurnal_amp * np.sin(2.0 * np.pi * now / period_s)
        now += gap / max(float(mod), 1e-9)
        u = float(rng.random())
        tier = mix[-1][0]
        for (t, _), edge in zip(mix, cum):
            if u <= edge:
                tier = t
                break
        if prefill_frac and float(rng.random()) < prefill_frac:
            idx = len(decode_apps) + int(rng.integers(len(prefill_apps)))
        else:
            idx = int(rng.integers(len(decode_apps)))
        t_a = float(t_ref[idx])
        slack = 1.0 + float(rng.uniform(*tier.slack_range))
        q = None if quantum_frac is None else quantum_frac * t_a
        yield Job(app=served[idx], arrival=now, deadline=now + slack * t_a,
                  job_id=jid, checkpoint_quantum=q, tier=tier)


def training_workload(
    apps: list[AppProfile],
    testbed: Testbed,
    n_jobs: int = 120,
    seed: int = 0,
    n_devices: int = 4,
    pool: list[DeviceClass] | None = None,
    utilization: float = 0.4,
    slack_range: tuple[float, float] = (2.0, 6.0),
    tier: TierSpec = BATCH_TIER,
    mean_interarrival: float | None = None,
    quantum_frac: float | None = None,
):
    """Background training jobs over the model-derived suite.

    A steady (non-diurnal) Poisson stream of the ``train`` apps in
    ``apps`` — optimizer steps with gradient all-reduce traffic — sized to
    ``utilization`` of the pool's aggregate default-clock throughput and
    tagged ``tier`` (default :data:`BATCH_TIER`: above best-effort, below
    the serving SLO tier, never shed). Deadlines are arrival-anchored with
    generous batch slack (``arrival + (1 + U[slack_range]) × t_ref``, the
    conservative slowest-class anchor), so train steps yield headroom to
    interactive traffic without becoming unschedulable. Meant to be merged
    under a serving stream via :func:`merge_workloads`. A generator in
    nondecreasing arrival order, like every stream here.
    """
    train_apps = [a for a in apps if a.kind == "train"]
    if not train_apps:
        raise ValueError("training_workload needs at least one train app")
    rng = np.random.default_rng(seed)
    t_ref, rate, _ = _conservative_t_ref(train_apps, testbed, pool,
                                         n_devices)
    if mean_interarrival is None:
        mean_interarrival = 1.0 / (rate * utilization)
    now = 0.0
    for jid in range(n_jobs):
        now += float(rng.exponential(mean_interarrival))
        idx = int(rng.integers(len(train_apps)))
        t_a = float(t_ref[idx])
        slack = 1.0 + float(rng.uniform(*slack_range))
        q = None if quantum_frac is None else quantum_frac * t_a
        yield Job(app=train_apps[idx], arrival=now,
                  deadline=now + slack * t_a, job_id=jid,
                  checkpoint_quantum=q, tier=tier)


def merge_workloads(*streams) -> list[Job]:
    """Merge job streams into one arrival-ordered list with contiguous
    re-numbered ``job_id``\\ s (the engine requires unique ids; generators
    each number from 0). The sort is stable, so ties keep the positional
    stream order — deterministic for deterministic inputs."""
    jobs = [j for s in streams for j in s]
    jobs.sort(key=lambda j: j.arrival)
    return [dataclasses.replace(j, job_id=i) for i, j in enumerate(jobs)]
