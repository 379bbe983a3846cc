"""Deadline-aware scheduling by data-driven DVFS (paper §IV, Algorithm 1).

Policies (see :mod:`repro_torch.core.policies` for the pluggable class
registry):

* ``dc`` — Default Clock baseline (paper's DC).
* ``mc`` — Max Clock baseline (paper's MC, "computational sprinting").
* ``d-dvfs`` — the paper's Algorithm 1, implemented literally: EDF-sorted job
  queue; for each job, scan every supported clock pair in the documented
  ladder order, predict power & time, and accept a clock iff it improves BOTH
  the best predicted power and the best predicted time seen so far (the
  paper's ``P < minPower and T < maxTime`` with ``maxTime`` initialised to
  the job's remaining-deadline budget and tightened on every accept). Jobs
  with no feasible clock run at max clock (deviation: the paper leaves them
  unexecuted; dropping work would trivially "save" energy, so we sprint
  instead and count the potential miss).
* ``min-energy`` — beyond-paper: argmin predicted energy (P*T) subject to
  predicted time <= remaining budget.
* ``risk-aware`` — beyond-paper: min-energy with an inflated time estimate
  T*(1+margin) guarding against predictor underestimates (deadline insurance).
* ``oracle`` — ground-truth exhaustive minimum-energy feasible clock (the
  unreachable lower bound; quantifies the prediction gap).

Multi-device scheduling (beyond paper; their future work): ``n_devices`` > 1
dispatches EDF jobs onto the earliest-available device; per-device clocks.

**Queue-aware budgets (beyond paper, on by default).** Algorithm 1 is myopic:
it consumes a job's entire deadline slack, delaying every queued job — under
backlog even a per-job *oracle* cascades into deadline misses (each slowed
predecessor steals the successors' slack). The paper's 12-job workload was
loose enough to hide this. With ``queue_aware=True`` the time budget for job
i is capped by every queued job j's deadline minus the minimum (max-clock)
time of the jobs ahead of it:

    budget_i = min( d_i − now,  min_m ( d_{j_m} − now − Σ_{k≤m} tmin_{j_k} ) )

``queue_aware=False`` gives the paper-literal myopic behavior (kept as an
ablation; the Fig. 9/10 benchmark reports both).

**Virtual-DC pacing (beyond paper, on by default).** Queue-awareness cannot
protect jobs that have not arrived yet. The deadline generator guarantees the
*default-clock* schedule is feasible, so we track a virtual DC schedule over
the jobs in execution order (``vdc_i = max(vdc_{i-1}, arrival_i) + t_dc_i``)
and cap each job's time budget at

    (vdc_i − start) + slack_share × max(0, d_i − vdc_i)

i.e. a job may fall behind DC pace only by a ``slack_share`` fraction of its
*own* deadline slack — bounding the delay it can impose on any future
arrival. ``slack_share=1.0, virtual_pacing=False`` recovers pure Algorithm 1
semantics.

**Architecture (post-refactor).** :func:`run_schedule` is a thin wrapper
wiring three composable layers:

* :class:`~repro_torch.core.prediction_service.PredictionService` —
  memoized, vectorized per-app × clock-ladder tables (one build per
  distinct app instead of O(jobs × clocks) predictor calls per decision),
  built on the device;
* :mod:`~repro_torch.core.policies` — the policy registry + budget
  managers;
* :class:`~repro_torch.core.engine.EventEngine` — the streaming event core.

The pre-refactor monolith is retained as :func:`legacy_run_schedule`: it
is the executable specification the composed stack is held to, record for
record.

Both entry points take ``device`` (default ``"cuda"``): the device the
predictor's GBDT ensembles live on and the prediction tables are built
on. Without CUDA the default raises; pass ``device="cpu"``.
"""
from __future__ import annotations

import heapq
from typing import Optional, Sequence

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from .correlate import CorrelationIndex
from .dvfs import ClockPair, DeviceClass, DVFSConfig
from .engine import EngineHooks, EventEngine, ExecutionRecord, ScheduleResult
from .features import clock_features
from .policies import (POLICIES as _POLICY_REGISTRY, Policy,
                       QueueAwareBudget, VirtualPacingBudget, resolve_policy)
from .prediction_service import PredictionService
from .predictor import EnergyTimePredictor
from .simulator import AppProfile, Testbed
from .workload import Job

__all__ = [
    "ExecutionRecord",
    "ScheduleResult",
    "run_schedule",
    "legacy_run_schedule",
    "POLICIES",
]

#: Back-compat tuple of policy names (the registry itself lives in
#: :mod:`repro_torch.core.policies`).
POLICIES = tuple(_POLICY_REGISTRY)


# ---------------------------------------------------------------------- #
#  New composable path
# ---------------------------------------------------------------------- #
#: Options of the reference's ``run_schedule`` whose layers this package
#: does not carry yet, with the ROADMAP item that ports each.
_NOT_PORTED = {
    "coldstart": "the cold-start tier (ROADMAP §1.9)",
}


def run_schedule(
    jobs: list[Job],
    policy: "str | Policy",
    testbed: Testbed,
    predictor: EnergyTimePredictor | None = None,
    app_features: dict[str, np.ndarray] | None = None,
    corr_index: CorrelationIndex | None = None,
    corr_features: dict[str, np.ndarray] | None = None,
    n_devices: int = 1,
    risk_margin: float = 0.05,
    queue_aware: bool = True,
    virtual_pacing: bool = True,
    slack_share: float = 0.2,
    seed: int = 0,
    service: PredictionService | None = None,
    hooks: EngineHooks | None = None,
    feedback: object | None = None,
    device_classes: "Sequence[DeviceClass] | None" = None,
    power_coordinator: object | None = None,
    preemption: object | None = None,
    batch_decide: bool = True,
    admission: object | None = None,
    coldstart: object | None = None,
    device: "str | torch.device" = DEFAULT_DEVICE,
) -> ScheduleResult:
    """Event-driven schedule execution on the simulated testbed.

    ``app_features``: per-job default-clock profile vectors (the new-app
    profiling run). ``corr_index``/``corr_features``: when given, D-DVFS uses
    the *correlated* application's exhaustive-profile features as prediction
    input (the paper's §III-D indirection); otherwise the job's own
    default-clock features are used.

    ``service``: pass a shared :class:`PredictionService` to reuse its
    memoized tables across many runs (benchmark sweeps, online serving);
    when given, its predictor/app_features take precedence over the
    ``predictor``/``app_features`` arguments and it must live on
    ``device``. ``jobs`` may be any iterable in nondecreasing arrival
    order — including a generator (streaming).

    ``device_classes``: an explicit (possibly heterogeneous) pool — one
    :class:`~repro_torch.core.dvfs.DeviceClass` per device, positional;
    overrides ``n_devices``. A pool with one distinct class reproduces the
    classless engine bit-identically; a mixed pool turns every decision
    into a joint (device class, clock) choice.

    ``feedback``: an object with ``observe(record)`` — typically an
    :class:`~repro_torch.core.online.OnlineAdapter` attached to ``service``
    — called after every completion (measurement-feedback loop). ``None``
    (default) keeps the frozen path.

    ``power_coordinator``: a
    :class:`~repro_torch.core.powercap.PowerCapCoordinator` enforcing a
    cluster-wide power cap — every dispatch is granted a per-device power
    budget and the clock ladder is filtered to clocks fitting the grant.
    ``None`` (default) and cap=∞ both reproduce the capless engine
    bit-identically.

    ``preemption``: a :class:`~repro_torch.core.preemption.PreemptionManager`
    — jobs with a ``checkpoint_quantum`` become interruptible at segment
    boundaries, mispredicted runs are re-scaled mid-flight, and stranded
    urgent jobs can preempt slack-rich ones (the remnant resumes, possibly
    on another device class). ``None`` (default) runs the untouched
    non-preemptive loop; a manager whose triggers never fire is
    bit-identical to it.

    ``batch_decide``: enable the vectorized decision core — compiled
    selection ladders, batched joint scoring, and the cached measurement
    substrate, all bit-identical to the scalar decision path (the
    default). ``False`` runs the original scalar code.

    ``admission``: an :class:`~repro_torch.core.admission.AdmissionController`
    — sheddable-tier (best-effort) arrivals are deferred or shed when
    predicted demand overruns the pool/cap headroom over a lookahead
    window; shed jobs land in ``ScheduleResult.shed``. ``None`` (default)
    runs zero admission code.

    ``coldstart`` keeps the reference's signature but raises
    :class:`NotImplementedError` until its layer is ported.
    """
    if coldstart is not None:
        raise NotImplementedError(
            f"run_schedule(coldstart=...) needs {_NOT_PORTED['coldstart']}, "
            "which is not ported yet")
    device = resolve_device(device)
    if isinstance(policy, Policy):
        pol, policy = policy, policy.name
    else:
        if policy not in _POLICY_REGISTRY:
            raise ValueError(
                f"unknown policy {policy!r}; choose from {POLICIES}")
        pol = None
    d = testbed.dvfs
    if pol is None:
        pol = resolve_policy(policy, d, risk_margin=risk_margin)
    if service is None:
        service = PredictionService(
            d, predictor=predictor, app_features=app_features,
            corr_index=corr_index, corr_features=corr_features,
            testbed=testbed, device=device)
    elif service.device != device:
        raise ValueError(f"service lives on {service.device}, run_schedule "
                         f"was asked for {device}")
    predictor = service.predictor
    app_features = service.app_features
    if policy in ("d-dvfs", "min-energy", "risk-aware") and predictor is None:
        raise ValueError(f"policy {policy!r} needs a fitted predictor")

    if device_classes is not None:
        n_devices = len(device_classes)
    # on a single-device pool the budget managers anchor on that device's
    # class; None (classless or multi-device) keeps the legacy source
    dc0 = (device_classes[0]
           if device_classes is not None and n_devices == 1 else None)

    # On the preemptive engine a queued entry may be a resumable remnant:
    # its budget-manager estimates must price the *remaining* work (plus
    # the restore overhead), which the manager's scale_t lens does. With
    # preemption=None the wrap is skipped entirely (identity).
    def _scaled(fn):
        if preemption is None:
            return fn
        return lambda j: preemption.scale_t(j, fn(j))

    managers = []
    if queue_aware and n_devices == 1:
        # t_min source mirrors the legacy path: ground truth for the oracle,
        # the predictor when available, otherwise no cap
        if policy == "oracle":
            managers.append(QueueAwareBudget(
                _scaled(lambda j: service.true_t_min(j.app, dc0))))
        elif predictor is not None and app_features is not None:
            managers.append(QueueAwareBudget(
                _scaled(lambda j: service.t_min(j.name, dc0))))
    if virtual_pacing and policy not in ("dc", "mc") and n_devices == 1:
        if policy == "oracle" or app_features is None or predictor is None:
            t_dc = lambda j: service.true_t_dc(j.app, dc0)  # noqa: E731
        else:
            t_dc = lambda j: service.t_dc(j.name, dc0)      # noqa: E731
        managers.append(VirtualPacingBudget(_scaled(t_dc),
                                            slack_share=slack_share))

    engine = EventEngine(
        testbed,
        pol,
        service=service,
        n_devices=n_devices,
        budget_managers=managers,
        hooks=hooks,
        seed=seed,
        feedback=feedback,
        device_classes=device_classes,
        power_coordinator=power_coordinator,
        preemption=preemption,
        batch_decide=batch_decide,
        admission=admission,
    )
    return engine.run(jobs)


# ---------------------------------------------------------------------- #
#  Legacy monolith — executable specification for the refactored stack
# ---------------------------------------------------------------------- #
def _select_clock_paper(
    feats: np.ndarray,
    budget: float,
    clocks: list[ClockPair],
    predictor: EnergyTimePredictor,
    d: DVFSConfig,
) -> tuple[Optional[ClockPair], float | None, float | None]:
    """Algorithm 1 lines 9-20, vectorized over the clock ladder."""
    X = np.stack([np.concatenate([feats, clock_features(c, d)]) for c in clocks])
    P = predictor.predict_power(X)
    T = predictor.predict_time(X)
    min_power, max_time = np.inf, budget
    best, bp, bt = None, None, None
    for c, p, t in zip(clocks, P, T):
        if p < min_power and t < max_time:
            min_power, max_time = p, t
            best, bp, bt = c, float(p), float(t)
    return best, bp, bt


def _select_clock_min_energy(
    feats, budget, clocks, predictor, d, margin: float = 0.0
):
    X = np.stack([np.concatenate([feats, clock_features(c, d)]) for c in clocks])
    P = predictor.predict_power(X)
    T = predictor.predict_time(X)
    T_guard = T * (1.0 + margin)
    feasible = T_guard <= budget
    if not feasible.any():
        return None, None, None
    E = P * T
    E = np.where(feasible, E, np.inf)
    i = int(np.argmin(E))
    return clocks[i], float(P[i]), float(T[i])


def _select_clock_oracle(app: AppProfile, budget, clocks, testbed: Testbed):
    best, best_e = None, np.inf
    for c in clocks:
        t = testbed.true_time(app, c)
        if t > budget:
            continue
        e = t * testbed.true_power(app, c)
        if e < best_e:
            best, best_e = c, e
    if best is None:
        return None, None, None
    return best, testbed.true_power(app, best), testbed.true_time(app, best)


def legacy_run_schedule(
    jobs: list[Job],
    policy: str,
    testbed: Testbed,
    predictor: EnergyTimePredictor | None = None,
    app_features: dict[str, np.ndarray] | None = None,
    corr_index: CorrelationIndex | None = None,
    corr_features: dict[str, np.ndarray] | None = None,
    n_devices: int = 1,
    risk_margin: float = 0.05,
    queue_aware: bool = True,
    virtual_pacing: bool = True,
    slack_share: float = 0.2,
    seed: int = 0,
    device: "str | torch.device" = DEFAULT_DEVICE,
) -> ScheduleResult:
    """The pre-refactor monolithic implementation, kept verbatim.

    O(jobs × clocks) predictor calls per decision and a full queue re-sort
    per job — do not use for large workloads; use :func:`run_schedule`.
    The composed stack must reproduce this function's records bit for bit
    for every policy. Every predictor call runs on ``device``, which must
    be the predictor's.
    """
    device = resolve_device(device)
    if predictor is not None and predictor.device != device:
        raise ValueError(f"predictor lives on {predictor.device}, "
                         f"legacy_run_schedule was asked for {device}")
    if policy not in POLICIES:
        raise ValueError(f"unknown policy {policy!r}; choose from {POLICIES}")
    if policy in ("d-dvfs", "min-energy", "risk-aware") and predictor is None:
        raise ValueError(f"policy {policy!r} needs a fitted predictor")
    d = testbed.dvfs
    clocks = d.clock_list()
    rng = np.random.default_rng(seed)

    # device availability min-heap: (free_time, device_id)
    free = [(0.0, dev) for dev in range(n_devices)]
    heapq.heapify(free)
    pending = sorted(jobs, key=lambda j: j.arrival)
    records: list[ExecutionRecord] = []
    queue: list[tuple[float, int, Job]] = []  # (deadline, tiebreak, job)
    i, counter = 0, 0
    _tmin_cache: dict[str, float] = {}
    _tdc_cache: dict[str, float] = {}
    vdc = 0.0  # virtual default-clock schedule completion time

    def _t_dc(job: Job) -> float:
        key = job.name
        if key not in _tdc_cache:
            if policy == "oracle" or app_features is None or predictor is None:
                _tdc_cache[key] = testbed.true_time(job.app, d.default_clock)
            else:
                xj = np.concatenate(
                    [app_features[key], clock_features(d.default_clock, d)]
                )
                _tdc_cache[key] = float(predictor.predict_time(xj[None])[0])
        return _tdc_cache[key]

    while i < len(pending) or queue:
        free_t, dev = heapq.heappop(free)
        # admit everything that has arrived by the time this device frees up;
        # if queue empty, jump to next arrival
        if not queue:
            if i >= len(pending):
                break
            next_arr = pending[i].arrival
            free_t = max(free_t, next_arr)
        while i < len(pending) and pending[i].arrival <= free_t:
            heapq.heappush(queue, (pending[i].deadline, counter, pending[i]))
            counter += 1
            i += 1
        if not queue:
            heapq.heappush(free, (free_t, dev))
            continue
        _, _, job = heapq.heappop(queue)  # EDF (paper line 5)
        start = max(free_t, job.arrival)
        budget = job.deadline - start
        if queue_aware and queue and n_devices == 1:
            # cap by queued jobs' deadlines minus their max-clock times
            cum = 0.0
            for dl_j, _, job_j in sorted(queue):
                if policy == "oracle":
                    tmin_j = testbed.true_time(job_j.app, d.max_clock)
                elif app_features is not None and predictor is not None:
                    key = job_j.name
                    if key not in _tmin_cache:
                        xj = np.concatenate(
                            [app_features[key], clock_features(d.max_clock, d)]
                        )
                        _tmin_cache[key] = float(predictor.predict_time(xj[None])[0])
                    tmin_j = _tmin_cache[key]
                else:
                    break
                cum += tmin_j
                # job_j completes no earlier than start + T_i + cum
                budget = min(budget, dl_j - start - cum)
        if virtual_pacing and policy not in ("dc", "mc") and n_devices == 1:
            t_dc_i = _t_dc(job)
            vdc_i = max(vdc, job.arrival) + t_dc_i
            vdc = vdc_i
            pace_budget = (vdc_i - start) + slack_share * max(
                0.0, job.deadline - vdc_i
            )
            budget = min(budget, max(pace_budget, t_dc_i))

        feats = None
        if app_features is not None:
            feats = app_features[job.name]
            if corr_index is not None and corr_features is not None:
                corr_name = corr_index.correlated(feats, exclude=job.name)
                feats = corr_features.get(corr_name, feats)

        pt = pp = None
        if policy == "dc":
            clock, feasible = d.default_clock, True
        elif policy == "mc":
            clock, feasible = d.max_clock, True
        elif policy == "oracle":
            clock, pp, pt = _select_clock_oracle(job.app, budget, clocks, testbed)
            feasible = clock is not None
        elif policy == "d-dvfs":
            clock, pp, pt = _select_clock_paper(feats, budget, clocks,
                                                predictor, d)
            feasible = clock is not None
        elif policy == "min-energy":
            clock, pp, pt = _select_clock_min_energy(feats, budget, clocks,
                                                     predictor, d)
            feasible = clock is not None
        else:  # risk-aware
            clock, pp, pt = _select_clock_min_energy(
                feats, budget, clocks, predictor, d, margin=risk_margin
            )
            feasible = clock is not None
        if clock is None:
            clock = d.max_clock  # sprint (see module docstring)

        meas = testbed.run(job.app, clock, rng=rng)
        end = start + meas.time_s
        records.append(
            ExecutionRecord(
                job_id=job.job_id, name=job.name, arrival=job.arrival,
                deadline=job.deadline, start=start, end=end, device=dev,
                clock=clock, time_s=meas.time_s, power_w=meas.power_w,
                energy_j=meas.energy_j, predicted_time=pt, predicted_power=pp,
                met_deadline=end <= job.deadline + 1e-9,
                had_feasible_clock=feasible,
            )
        )
        heapq.heappush(free, (end, dev))

    return ScheduleResult(policy=policy, records=records)
