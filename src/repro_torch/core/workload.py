"""Workload generation (paper §V-C): the base generators.

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
a stream is the same job for job as the reference generator's. The
tiered, drifting, bursty and model-derived generators arrive with the
layers that consume them (ROADMAP §1.7–§1.11).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .dvfs import DeviceClass, DVFSConfig
from .simulator import AppProfile, Testbed

__all__ = ["Job", "TierSpec", "DEFAULT_TIER", "edf_key", "make_workload",
           "stream_workload", "make_device_pool"]


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """A tenancy class (SLA tier) a :class:`Job` belongs to.

    ``priority`` orders tiers in the engine's dispatch queue (higher
    dispatches first — see :func:`edf_key`). The tier weights, shedding
    and slack draws of the reference arrive with the admission layer
    (ROADMAP §1.8). :data:`DEFAULT_TIER` (priority 0) is the inert
    default: single-tier runs order by plain deadline.
    """
    name: str
    priority: int = 0


#: The inert tier every untagged job carries (tierless semantics).
DEFAULT_TIER = TierSpec("default")


@dataclasses.dataclass
class Job:
    app: AppProfile
    arrival: float
    deadline: float            # absolute
    job_id: int = 0
    #: SLA tier this job belongs to.
    tier: TierSpec = DEFAULT_TIER

    @property
    def name(self) -> str:
        return self.app.name


def edf_key(job: Job) -> tuple[int, float]:
    """Tier-aware EDF dispatch key: ``(-tier.priority, deadline)``.

    Higher-priority tiers dispatch strictly before lower ones; within a
    tier, ordering is the classic earliest-deadline-first. When every job
    carries the same tier the leading component is a shared constant and
    tuple comparison reduces to plain deadline order."""
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
