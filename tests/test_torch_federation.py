"""Multi-rack federation on CPU: the port against the reference.

``core/federation.py`` (rack topology, facility coordinator, federated
preemption with the straggler monitor of ``dist/fault_tolerance.py``), the
power-cap coordinator's federation hooks and ``multi_rack_workload``:

* the port reproduces the ``min-energy|federation|0`` golden trace, built
  as ``tests/test_golden.py`` builds it, live as its gate requires (an
  escalation, a boost, a billed cross-rack migration, split segments), and
  equals the reference record for record on it, every ``compare=False``
  field compared by name;
* on the reference's federated-migration runs, on facility-cap fuzz draws
  over rack sizes, caps, grant and share policies, and on a degraded mixed
  fleet with straggler rescue, the port equals the reference record for
  record with the same coordinator and manager statistics, and keeps the
  reference's invariants (facility cap safety, Σ work per job = 1 across
  racks, migration counters);
* a one-rack facility is the bare coordinator for all six policies;
* the host units (topology, migration cost, the coordinator's cap-transfer
  hooks, escalation, the straggler monitor) give the reference's numbers
  exactly.

Tolerance everywhere is exact equality: the layer is fp64 host numpy in
both packages.
"""
from __future__ import annotations

import dataclasses
import json
import math

import numpy as np
import pytest

import repro.core as R
from repro.dist.fault_tolerance import StragglerMonitor as RStraggler
from repro_torch import core as P
from repro_torch.dist import StragglerMonitor as PStraggler
from test_torch_coldstart import _same_runs, fuzz_fixture
from test_torch_layers import (GOLDEN_PATH, PACKAGES, _dev, _digest, _fields,
                               fixture)

CPU = "cpu"
FED_KEY = "min-energy|federation|0"
FED_JOBS = 16


def _rack_stats(fac) -> list:
    return [dataclasses.asdict(s) for s in fac.rack_stats()]


# ---------------------------------------------------------------------- #
#  The golden trace (tests/test_golden.py's _federation_run)
# ---------------------------------------------------------------------- #
def _golden_run(pkg, g):
    jobs = list(pkg.multi_rack_workload(g["apps"], g["tb"], n_devices=4,
                                        n_jobs=FED_JOBS, seed=0,
                                        utilization=0.7))
    fac = pkg.FacilityCoordinator(375.0, (2, 2),
                                  share_policy="demand-weighted",
                                  escalation=True, guard=0.2)
    pre = pkg.FederatedPreemptionManager((2, 2), dvfs=g["tb"].dvfs,
                                         device_slowdown={0: 3.0})
    res = pkg.run_schedule(jobs, "min-energy", pkg.Testbed(seed=100),
                           predictor=g["pred"], app_features=g["feats"],
                           n_devices=4, power_coordinator=fac,
                           preemption=pre, **_dev(pkg))
    return res, fac, pre


def test_port_reproduces_federation_golden_digest():
    golden = json.loads(GOLDEN_PATH.read_text())["traces"]
    res, fac, pre = _golden_run(P, fixture()["port"])
    assert _digest(res.records) == golden[FED_KEY]["digest"]
    # live, as the reference's gate requires
    assert fac.stats.escalations >= 1 and res.migrations >= 1
    assert pre.fed.boosts >= 1 and res.preemptions > 0
    assert len(res.records) > FED_JOBS
    assert any(rec.device == 0 for rec in res.records)
    assert any(rec.migrated and rec.overhead_j > 0 for rec in res.records)
    assert pre.fed.migration_j > 0                  # billed on the move


def test_federation_golden_run_equals_reference():
    f = fixture()
    (p, pf, pp), (r, rf, rp) = _golden_run(P, f["port"]), _golden_run(
        R, f["ref"])
    _same_runs(p, r)
    assert dataclasses.asdict(pf.stats) == dataclasses.asdict(rf.stats)
    assert _rack_stats(pf) == _rack_stats(rf)
    assert dataclasses.asdict(pp.fed) == dataclasses.asdict(rp.fed)
    assert dataclasses.asdict(pp.stats) == dataclasses.asdict(rp.stats)
    assert p.migrations_by_rack() == r.migrations_by_rack()
    assert pf.caps() == rf.caps()


# ---------------------------------------------------------------------- #
#  tests/test_differential.py's federated migration runs
# ---------------------------------------------------------------------- #
def _federated_run(pkg, g, seed: int):
    jobs = list(pkg.multi_rack_workload(g["apps"], g["tb"], n_devices=4,
                                        n_jobs=40, seed=seed))
    kw = dict(predictor=g["pred"], app_features=g["feats"], n_devices=4,
              **_dev(pkg))
    r0 = pkg.run_schedule(jobs, "min-energy", pkg.Testbed(seed=1000), **kw)
    idle = g["tb"].idle_power() * 4
    led = pkg.PowerTelemetry.from_result(
        r0, idle_powers=g["tb"].idle_power(), n_devices=4)
    fac = pkg.FacilityCoordinator(idle + 0.7 * max(led.peak_w - idle, 1.0),
                                  [2, 2], share_policy="demand-weighted",
                                  guard=0.15)
    pre = pkg.FederatedPreemptionManager(
        [2, 2], config=pkg.PreemptionConfig(margin=0.02,
                                            min_remnant_frac=0.02),
        dvfs=g["tb"].dvfs, device_slowdown={1: 2.5})
    res = pkg.run_schedule(jobs, "min-energy", pkg.Testbed(seed=1000),
                           power_coordinator=fac, preemption=pre, **kw)
    return jobs, res, fac, pre


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_federated_migration_equals_reference(seed):
    f = fuzz_fixture()
    (jobs, p, pf, pp), (_, r, rf, rp) = (_federated_run(P, f["port"], seed),
                                         _federated_run(R, f["ref"], seed))
    _same_runs(p, r)
    assert dataclasses.asdict(pf.stats) == dataclasses.asdict(rf.stats)
    assert dataclasses.asdict(pp.fed) == dataclasses.asdict(rp.fed)
    # the reference's conservation across racks and migration counters
    by_job: dict[int, list] = {}
    for rec in p.records:
        by_job.setdefault(rec.job_id, []).append(rec)
        if rec.migrated:
            assert rec.segment > 0 and rec.rack is not None
    assert sorted(by_job) == sorted(j.job_id for j in jobs)
    for jid, recs in by_job.items():
        assert math.fsum(x.work_frac for x in recs) == pytest.approx(
            1.0, abs=1e-9), jid
    migrated = [x for x in p.records if x.migrated]
    assert p.migrations == len(migrated)
    assert sum(p.migrations_by_rack().values()) == p.migrations
    prev_rack = {}
    for rec in sorted(p.records, key=lambda x: (x.job_id, x.segment)):
        if rec.migrated:
            assert prev_rack[rec.job_id] != rec.rack, rec
        prev_rack[rec.job_id] = rec.rack


def test_federated_migration_fires():
    f = fuzz_fixture()["port"]
    assert sum(_federated_run(P, f, s)[1].migrations for s in range(3)) > 0


# ---------------------------------------------------------------------- #
#  Facility cap safety, port == reference
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("sizes,cap_frac,grant,share,seed", [
    ((2, 1), 0.5, "uniform", "static", 0),
    ((1, 2, 1), 0.7, "greedy-edf", "demand-weighted", 3),
    ((3,), 0.45, "slack-weighted", "tier-weighted", 5),
    ((2, 2, 2), 0.9, "slack-weighted", "demand-weighted", 7),
    ((1, 1), 0.6, "uniform", "tier-weighted", 10),
    ((3, 2), 0.55, "greedy-edf", "static", 2)])
def test_facility_cap_safety_equals_reference(sizes, cap_frac, grant, share,
                                              seed):
    out = {}
    for name, pkg in PACKAGES:
        g = fuzz_fixture()[name]
        n_dev = sum(sizes)
        jobs = list(pkg.multi_rack_workload(g["apps"], g["tb"],
                                            n_devices=n_dev, n_jobs=24,
                                            seed=seed))
        kw = dict(predictor=g["pred"], app_features=g["feats"],
                  n_devices=n_dev, **_dev(pkg))
        r0 = pkg.run_schedule(jobs, "min-energy", pkg.Testbed(seed=1000),
                              **kw)
        idle_w = g["tb"].idle_power()
        led0 = pkg.PowerTelemetry.from_result(r0, idle_powers=idle_w,
                                              n_devices=n_dev)
        idle = idle_w * n_dev
        cap = idle + cap_frac * max(led0.peak_w - idle, 1.0)
        fac = pkg.FacilityCoordinator(cap, sizes, grant_policy=grant,
                                      share_policy=share)
        res = pkg.run_schedule(jobs, "min-energy", pkg.Testbed(seed=1000),
                               power_coordinator=fac, **kw)
        peaks = [pkg.PowerTelemetry.from_result(
            res, idle_powers=idle_w, n_devices=n_dev, view=v).peak_w
            for v in ("granted", "measured")]
        out[name] = res, cap, peaks, fac
    (p, cap, peaks, pf), (r, _, r_peaks, rf) = out["port"], out["ref"]
    _same_runs(p, r)
    assert peaks == r_peaks
    assert dataclasses.asdict(pf.stats) == dataclasses.asdict(rf.stats)
    assert all(pk <= cap * (1 + 1e-9) + 1e-6 for pk in peaks)
    assert math.fsum(pf.caps()) <= cap * (1 + 1e-9) + 1e-6
    for rec in p.records:
        assert pf.rack_of(rec.device) == rec.rack


# ---------------------------------------------------------------------- #
#  A degraded mixed fleet with straggler rescue (bench_federation, reduced)
# ---------------------------------------------------------------------- #
def _rescue_run(pkg, g, monitor: bool):
    pool = pkg.make_device_pool((pkg.V5P_CLASS, 2), (pkg.V5E_CLASS, 4),
                                (pkg.V5LITE_CLASS, 2))
    racks = [2, 4, 2]
    jobs = list(pkg.multi_rack_workload(g["apps"], g["tb"], n_jobs=200,
                                        seed=0, utilization=0.5,
                                        device_classes=pool))
    svc = pkg.PredictionService(pkg.V5E_DVFS, predictor=g["pred"],
                                app_features=g["feats"], testbed=g["tb"],
                                **_dev(pkg))
    policy = pkg.RiskAware(pkg.V5E_DVFS, margin=0.05)
    r0 = pkg.run_schedule(jobs, policy, pkg.Testbed(seed=100), service=svc,
                          device_classes=pool, **_dev(pkg))
    led0 = pkg.PowerTelemetry.from_result(r0, pool=pool)
    floor = sum(c.idle_power() for c in pool)
    cap = floor + 0.65 * (led0.peak_w - floor)
    fac = pkg.FacilityCoordinator(cap, racks, share_policy="demand-weighted",
                                  escalation=True, guard=0.2)
    pre = pkg.FederatedPreemptionManager(
        racks, dvfs=pkg.V5E_CLASS.dvfs if monitor else None,
        device_slowdown={2: 4.0, 3: 4.0})
    res = pkg.run_schedule(jobs, pkg.RiskAware(pkg.V5E_DVFS, margin=0.05),
                           pkg.Testbed(seed=100), service=svc,
                           device_classes=pool, power_coordinator=fac,
                           preemption=pre, **_dev(pkg))
    return res, fac, pre


@pytest.mark.parametrize("monitor", [False, True], ids=["blind", "monitor"])
def test_degraded_fleet_rescue_equals_reference(monitor):
    f = fixture()
    (p, pf, pp), (r, rf, rp) = (_rescue_run(P, f["port"], monitor),
                                _rescue_run(R, f["ref"], monitor))
    _same_runs(p, r)
    assert dataclasses.asdict(pf.stats) == dataclasses.asdict(rf.stats)
    assert _rack_stats(pf) == _rack_stats(rf)
    assert dataclasses.asdict(pp.fed) == dataclasses.asdict(rp.fed)
    assert pf.stats.escalations > 0
    if monitor:
        assert pp.fed.boosts >= 1 and pp.fed.rescue_migrations >= 1
        assert pp.fed.quarantined >= 1 and p.migrations >= 1


# ---------------------------------------------------------------------- #
#  One rack is the bare coordinator
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", ["dc", "mc", "d-dvfs", "min-energy",
                                    "risk-aware", "oracle"])
def test_single_rack_is_bare_coordinator(policy):
    g = fuzz_fixture()["port"]
    jobs = list(P.multi_rack_workload(g["apps"], g["tb"], n_devices=3,
                                      n_jobs=30, seed=5))
    kw = dict(predictor=g["pred"], app_features=g["feats"], n_devices=3,
              device=CPU)
    for grant in P.GRANT_POLICIES:
        fed = P.FacilityCoordinator(430.0, [3], grant_policy=grant)
        bare = P.PowerCapCoordinator(430.0, grant_policy=grant)
        r1 = P.run_schedule(jobs, policy, P.Testbed(seed=1000),
                            power_coordinator=fed, **kw)
        r2 = P.run_schedule(jobs, policy, P.Testbed(seed=1000),
                            power_coordinator=bare, **kw)
        assert len(r1.records) == len(r2.records)
        for a, b in zip(r1.records, r2.records):
            # rack provenance is the only allowed difference
            assert _fields(dataclasses.replace(a, rack=None)) == \
                _fields(b), (policy, grant)
            assert a.rack == 0 and b.rack is None
        assert r1.migrations == 0


# ---------------------------------------------------------------------- #
#  Generators and host units: the reference's numbers exactly
# ---------------------------------------------------------------------- #
def _job_rows(jobs) -> list:
    return [(j.name, j.arrival, j.deadline, j.job_id, j.checkpoint_quantum,
             j.tier.name) for j in jobs]


@pytest.mark.parametrize("classes", [None, ("v5p", "v5e", "v5e", "v5lite")])
def test_multi_rack_workload_equals_reference(classes):
    rows = {}
    for name, pkg in PACKAGES:
        g = fixture()[name]
        pool = (None if classes is None
                else [pkg.DEVICE_CLASSES[c] for c in classes])
        rows[name] = _job_rows(pkg.multi_rack_workload(
            g["apps"], g["tb"], n_devices=4 if pool is None else len(pool),
            n_jobs=120, seed=3, burst=3, utilization=0.6,
            device_classes=pool))
    assert rows["port"] == rows["ref"] and len(rows["port"]) == 120


def test_topology_and_migration_cost_equal_reference():
    out = {}
    for name, pkg in PACKAGES:
        topo = pkg.RackTopology([3, 1, 4])
        cm = pkg.MigrationCostModel()
        out[name] = (topo.n_racks, topo.n_devices, topo.rack_sizes,
                     [topo.rack_of(d) for d in range(8)],
                     [topo.devices_of(r) for r in range(3)],
                     [cm.cost(b) for b in (0.0, -5.0, 1e6, 4e9, 1e14)])
    assert out["port"] == out["ref"]


def _hook_trail(pkg) -> list:
    """The coordinator's cap-transfer hooks and the facility's split,
    rebalance and escalation over a scripted episode."""
    trail = []
    c = pkg.PowerCapCoordinator(400.0)
    c.reset([20.0, 20.0])
    c.commit(0, 150.0, end=5.0, drawn_w=100.0)
    trail += [c.reclaimable_w, c.active_grants(), c.reclaim_unused(),
              c.release_cap(60.0), c.cap_w, c.headroom_w]
    c.resize_cap(c.allocated_w + 10.0)
    trail += [c.cap_w, c.release_cap(1e9), c.release_cap(5.0)]
    for share in pkg.FACILITY_SHARE_POLICIES:
        fac = pkg.FacilityCoordinator(500.0, [2, 2, 2], share_policy=share)
        fac.reset([20.0] * 6)
        trail.append(fac.caps())
        fac.commit(0, 100.0, end=10.0, drawn_w=90.0)
        fac.commit(1, 100.0, end=10.0, drawn_w=90.0)
        fac.advance(1.0)
        trail += [fac.caps(), fac.potential_w(2),
                  fac.escalate(2, fac.caps()[2] + 40.0, start=1.0),
                  fac.caps(), fac.active_grants(),
                  dataclasses.asdict(fac.stats), _rack_stats(fac)]
        fac.advance(20.0)
        trail.append(fac.caps())
    return trail


def test_cap_transfer_and_escalation_equal_reference():
    got = {name: _hook_trail(pkg) for name, pkg in PACKAGES}
    assert got["port"] == got["ref"]
    with pytest.raises(ValueError):
        c = P.PowerCapCoordinator(300.0)
        c.reset([20.0, 20.0])
        c.commit(0, 120.0, end=5.0, drawn_w=110.0)
        c.resize_cap(c.allocated_w - 1.0)


def test_straggler_monitor_equals_reference():
    rng = np.random.default_rng(4)
    steps = rng.uniform(0.8, 1.2, size=(40, 6))
    steps[10:, 2] *= 2.5                 # replica 2 degrades ...
    steps[25:, 2] /= 2.5                 # ... and recovers
    steps[5:, 4] *= 4.0                  # replica 4 never recovers
    out = {}
    for name, mon_cls, pkg in (("port", PStraggler, P),
                               ("ref", RStraggler, R)):
        mon = mon_cls(6, pkg.V5E_DVFS, threshold=1.3, ema_alpha=0.3)
        clock = {r: pkg.V5E_DVFS.default_clock for r in range(6)}
        trail = []
        for row in steps:
            flagged = mon.observe(row)
            for rep in flagged:
                clock[rep] = mon.mitigation_clock(rep, clock[rep])
            trail.append((list(flagged), mon.ema.tolist(),
                          {r: c.key() for r, c in mon.boosts.items()},
                          [mon.should_evict(r) for r in range(6)]))
        out[name] = trail
    assert out["port"] == out["ref"]
    assert out["port"][-1][3][4] and not out["port"][-1][3][2]


def test_federated_manager_units_equal_reference():
    out = {}
    for name, pkg in PACKAGES:
        mgr = pkg.FederatedPreemptionManager((2, 2), dvfs=pkg.V5E_DVFS,
                                             device_slowdown={1: 2.5})
        for _ in range(12):
            mgr.note_step(1, observed_s=3.0, predicted_s=1.0)
            mgr.note_step(0, observed_s=1.0, predicted_s=1.0)
        clk = pkg.dvfs.ClockPair(min(pkg.V5E_DVFS.core_scales), 1.0)
        ladder = []
        for _ in range(len(pkg.V5E_DVFS.core_scales) + 1):
            clk = mgr.mitigate_clock(1, clk, None)
            ladder.append(clk.key())
        out[name] = (mgr.slowdown_of(1), mgr.slowdown_of(0), ladder,
                     list(mgr.monitor.flagged), mgr.monitor.should_evict(1),
                     mgr.retire("rescue-migration", 1),
                     mgr.retire("cap-rescue", 0), sorted(mgr.quarantined),
                     dataclasses.asdict(mgr.fed))
        mgr.reset()
        out[name] += (sorted(mgr.quarantined), mgr.monitor.flagged)
    assert out["port"] == out["ref"]
