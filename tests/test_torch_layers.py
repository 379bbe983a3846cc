"""The scheduler's beyond-paper layers on CPU: the port against the reference.

Online measurement feedback (``core/online.py``), SLA tiers and admission
(``core/admission.py``), the power-cap coordinator (``core/powercap.py``) and
preemptive rescue (``core/preemption.py`` with the engine's segmented loop):

* the port reproduces the five golden traces these layers pin
  (``tests/golden/schedule_traces.json``: cap, preempt-fire,
  preempt-decline, tenant-shed, tenant-rescue), built as
  ``tests/test_golden.py`` builds them;
* on reduced tiered, capped, preemptive and online streams the port equals
  the reference record for record, every field compared — the provenance
  fields that ``ExecutionRecord.__eq__`` skips (grant, peak, ``work_frac``,
  ``segment``, preemption, overheads, tier, rack, migration) included;
* the reference's differential identities hold in the port: segmented but
  never preempted equals plain, cap = ∞ equals capless, and a disabled
  adapter equals frozen;
* the layers' host-numpy units (observation store, RLS corrector, CUSUM
  detector, power telemetry) give the reference's numbers exactly.

Tolerance everywhere is exact equality: the layers are fp64 numpy in both
packages, and the port's GBDT sums run in numpy's order.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import math
import pathlib

import numpy as np
import pytest

import repro.core as R
from repro.configs.paper_suite import PAPER_APPS as R_APPS
from repro.core.gbdt import GBDTParams as RGBDTParams
from repro_torch import core as P
from repro_torch.configs.paper_suite import PAPER_APPS as P_APPS
from repro_torch.core.gbdt import GBDTParams as PGBDTParams

GOLDEN_PATH = pathlib.Path(__file__).parent / "golden" / \
    "schedule_traces.json"
CPU = "cpu"
_G = dict(iterations=80, depth=3, learning_rate=0.15)
PACKAGES = (("ref", R), ("port", P))
#: benchmarks/bench_online.py's detector tuning and drifted apps
DRIFT_APPS = ["SYRK", "GEMM", "2MM"]
DRIFT_KW = dict(warmup=10, k=0.75, threshold=10.0, min_ref_std=0.05,
                cooldown=5)


@functools.lru_cache(maxsize=1)
def fixture():
    """The golden fixture of tests/test_golden.py, in both packages."""
    out = {}
    for name, pkg, apps, params in (("ref", R, R_APPS, RGBDTParams),
                                    ("port", P, P_APPS, PGBDTParams)):
        tb = pkg.Testbed(seed=0)
        X, yp, yt, _ = pkg.build_dataset(list(apps), tb, seed=0)
        rng = np.random.default_rng(7)
        feats = {a.name: pkg.profile_features(a, tb, rng=rng) for a in apps}
        cfg = pkg.PredictorConfig(gbdt=params(l2_leaf_reg=5.0, **_G),
                                  gbdt_time=params(l2_leaf_reg=3.0, **_G))
        kw = {} if pkg is R else {"device": CPU}
        out[name] = dict(tb=tb, apps=list(apps), feats=feats,
                         pred=pkg.EnergyTimePredictor(cfg, **kw).fit(
                             X, yp, yt))
    return out


def _dev(pkg) -> dict:
    return {} if pkg is R else {"device": CPU}


def _round(x: float) -> float:
    return float(f"{x:.12g}")


def _digest(records) -> str:
    trace = [[r.job_id, r.name, r.device, r.clock.core_mhz, r.clock.mem_mhz,
              _round(r.start), _round(r.end), _round(r.time_s),
              _round(r.power_w), _round(r.energy_j), int(r.met_deadline),
              int(r.had_feasible_clock)] for r in records]
    blob = json.dumps(trace, separators=(",", ":"), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def _fields(rec) -> tuple:
    """Every field of an ExecutionRecord by name, ``compare=False``
    provenance included; the clock as its (core, mem) scales."""
    out = []
    for f in dataclasses.fields(rec):
        v = getattr(rec, f.name)
        if f.name == "clock":
            v = (v.s_core, v.s_mem)
        out.append((f.name, v))
    return tuple(out)


def _assert_same_records(p, r) -> None:
    assert len(p.records) == len(r.records)
    for i, (a, b) in enumerate(zip(p.records, r.records)):
        assert _fields(a) == _fields(b), (i, a, b)
    assert [j.job_id for j in p.shed] == [j.job_id for j in r.shed]
    assert p.total_energy == r.total_energy and p.misses == r.misses


# ---------------------------------------------------------------------- #
#  The five golden traces of these layers (tests/test_golden.py)
# ---------------------------------------------------------------------- #
def _golden_run(key: str):
    f = fixture()["port"]
    apps, tb = f["apps"], f["tb"]
    kw = dict(predictor=f["pred"], app_features=f["feats"], device=CPU)
    if key == "min-energy|cap|0":
        jobs = P.make_workload(apps, tb, seed=0)
        return P.run_schedule(
            jobs, "min-energy", P.Testbed(seed=100), n_devices=2,
            power_coordinator=P.PowerCapCoordinator(
                120.0, grant_policy="slack-weighted", guard=0.2), **kw), None
    if key == "min-energy|preempt-fire|0":
        jobs = list(P.rescue_stress_workload(apps, tb, n_jobs=12, seed=0,
                                             n_devices=1))
        mgr = P.PreemptionManager()
        return P.run_schedule(jobs, "min-energy", P.Testbed(seed=100),
                              preemption=mgr, **kw), mgr
    if key == "min-energy|preempt-decline|0":
        jobs = [dataclasses.replace(j, checkpoint_quantum=0.5)
                for j in P.make_workload(apps, tb, seed=0)]
        mgr = P.PreemptionManager()
        return P.run_schedule(jobs, "min-energy", P.Testbed(seed=100),
                              preemption=mgr, **kw), mgr
    if key == "min-energy|tenant-shed|0":
        jobs = list(P.multi_tenant_workload(apps, tb, n_jobs=60, seed=0,
                                            n_devices=2, overload=8.0))
        adm = P.AdmissionController(lookahead_s=20.0, threshold=0.5)
        return P.run_schedule(jobs, "min-energy", P.Testbed(seed=100),
                              n_devices=2, admission=adm, **kw), adm
    assert key == "min-energy|tenant-rescue|0"
    by_name = {a.name: a for a in apps}
    whale_app, short_app = by_name["lavaMD"], by_name["particlefilter_float"]
    t_w = tb.true_time(whale_app, tb.dvfs.default_clock)
    t_s = tb.true_time(short_app, tb.dvfs.default_clock)
    whale = dataclasses.replace(
        P.Job(app=whale_app, arrival=0.0, deadline=0.5 * t_w, job_id=0,
              checkpoint_quantum=0.2), tier=P.BEST_EFFORT_TIER)
    s1 = dataclasses.replace(
        P.Job(app=short_app, arrival=0.25 * t_w,
              deadline=0.25 * t_w + 1.7 * t_s, job_id=1), tier=P.SLO_TIER)
    s2 = dataclasses.replace(
        P.Job(app=short_app, arrival=0.25 * t_w + 0.2,
              deadline=0.25 * t_w + 0.2 + 2.2 * t_s, job_id=2),
        tier=P.SLO_TIER)
    mgr = P.PreemptionManager()
    return P.run_schedule([whale, s1, s2], "min-energy", P.Testbed(seed=100),
                          preemption=mgr, **kw), mgr


LAYER_KEYS = ("min-energy|cap|0", "min-energy|preempt-fire|0",
              "min-energy|preempt-decline|0", "min-energy|tenant-shed|0",
              "min-energy|tenant-rescue|0")


@pytest.mark.parametrize("key", LAYER_KEYS)
def test_port_reproduces_layer_golden_digest(key):
    golden = json.loads(GOLDEN_PATH.read_text())["traces"]
    res, layer = _golden_run(key)
    assert _digest(res.records) == golden[key]["digest"]
    # the scenarios are live, as the reference's gate tests require
    if key == "min-energy|preempt-fire|0":
        assert layer.stats.preemptions > 0 and res.preemptions > 0
    elif key == "min-energy|preempt-decline|0":
        assert layer.stats.boundaries > 0 and res.preemptions == 0
        assert golden[key]["digest"] == golden["min-energy|0"]["digest"]
    elif key == "min-energy|tenant-shed|0":
        assert res.shed_count > 0 and len(res.records) < 60
    elif key == "min-energy|tenant-rescue|0":
        assert layer.stats.tier_rescues > 0


# ---------------------------------------------------------------------- #
#  Port == reference, record for record, on reduced layered streams
# ---------------------------------------------------------------------- #
def _pool(pkg, names):
    return [pkg.DEVICE_CLASSES[n] for n in names]


def _both(run):
    """``run(name, pkg, g)`` in each package; returns (port's, ref's)."""
    f = fixture()
    out = {name: run(name, pkg, f[name]) for name, pkg in PACKAGES}
    return out["port"], out["ref"]


def test_multi_tenant_admission_preemption_equals_reference():
    pool = ("v5p", "v5e", "v5e", "v5lite")

    def run(name, pkg, g):
        jobs = list(pkg.multi_tenant_workload(
            g["apps"], g["tb"], n_jobs=200, seed=2, pool=_pool(pkg, pool),
            overload=10.0, quantum_frac=0.25))
        adm = pkg.AdmissionController(lookahead_s=30.0, threshold=0.75)
        mgr = pkg.PreemptionManager()
        res = pkg.run_schedule(
            jobs, "min-energy", pkg.Testbed(seed=100), predictor=g["pred"],
            app_features=g["feats"], device_classes=_pool(pkg, pool),
            admission=adm, preemption=mgr, **_dev(pkg))
        return res, dataclasses.asdict(adm.stats), dataclasses.asdict(
            mgr.stats)

    (p, p_adm, p_pre), (r, r_adm, r_pre) = _both(run)
    _assert_same_records(p, r)
    assert p_adm == r_adm and p_pre == r_pre
    assert p.misses_by_tier() == r.misses_by_tier()
    assert p.shed_count > 0 and p.preemptions > 0
    assert {x.tier for x in p.records} == {"slo", "batch", "best-effort"}


def _sprint_cap(classes, frac=0.55):
    """The pool's idle floor plus ``frac`` of its sprint headroom (each
    class's model envelope at its max clock)."""
    idle = sum(c.idle_power() for c in classes)
    sprint = sum(c.dvfs.power(c.dvfs.max_clock, 1.0, 1.0) for c in classes)
    return idle + frac * (sprint - idle)


def test_all_layers_together_equal_reference():
    """Tiers with admission, a slack-weighted cap, preemption and the GBDT
    corrector in one run — the combination chip_smoke.py drives at full
    size."""
    pool = ("v5p", "v5e", "v5e", "v5lite")

    def run(name, pkg, g):
        classes = _pool(pkg, pool)
        jobs = list(pkg.multi_tenant_workload(
            g["apps"], g["tb"], n_jobs=200, seed=2, pool=classes,
            overload=10.0, quantum_frac=0.25))
        svc = pkg.PredictionService(g["tb"].dvfs, predictor=g["pred"],
                                    app_features=g["feats"], testbed=g["tb"],
                                    **_dev(pkg))
        # min_obs 4: the corrector fits (and predicts) within 200 jobs
        corrector = pkg.GBDTCorrector(pkg.ObservationStore(keep_rows=True),
                                      min_obs=4, **_dev(pkg))
        adapter = pkg.OnlineAdapter(svc, corrector=corrector)
        coord = pkg.PowerCapCoordinator(_sprint_cap(classes),
                                        grant_policy="slack-weighted")
        mgr = pkg.PreemptionManager()
        res = pkg.run_schedule(
            jobs, "min-energy", pkg.Testbed(seed=100), service=svc,
            device_classes=classes, feedback=adapter,
            power_coordinator=coord, preemption=mgr,
            admission=pkg.AdmissionController(lookahead_s=30.0,
                                              threshold=0.75), **_dev(pkg))
        return (res, dataclasses.asdict(coord.stats),
                dataclasses.asdict(mgr.stats), adapter.n_observed,
                len(corrector._fits))

    (p, p_c, p_m, p_n, p_f), (r, r_c, r_m, r_n, r_f) = _both(run)
    _assert_same_records(p, r)
    assert p_c == r_c and p_m == r_m and p_n == r_n == len(p.records)
    assert p_f == r_f > 0
    assert p.shed_count > 0 and p_c["commits"] > 0
    assert all(x.power_grant_w is not None for x in p.records)


def _cap_stress(pkg, g, pool, grant_policy):
    classes = _pool(pkg, pool)
    jobs = list(pkg.cap_stress_workload(g["apps"], g["tb"], classes,
                                        n_jobs=80, seed=0))
    kw = dict(predictor=g["pred"], app_features=g["feats"],
              device_classes=classes, **_dev(pkg))
    free = pkg.run_schedule(jobs, "min-energy", pkg.Testbed(seed=100), **kw)
    led = pkg.PowerTelemetry.from_result(free, pool=classes)
    idle = sum(c.idle_power() for c in classes)
    cap = idle + 0.55 * (led.peak_w - idle)       # bench_powercap's sizing
    coord = pkg.PowerCapCoordinator(cap, grant_policy=grant_policy,
                                    guard=0.15)
    res = pkg.run_schedule(jobs, "min-energy", pkg.Testbed(seed=100),
                           power_coordinator=coord, **kw)
    return res, coord, free


@pytest.mark.parametrize("grant_policy", ["uniform", "greedy-edf",
                                          "slack-weighted"])
def test_cap_stress_equals_reference(grant_policy):
    pool = ("v5p", "v5e", "v5e", "v5lite")

    def run(name, pkg, g):
        res, coord, free = _cap_stress(pkg, g, pool, grant_policy)
        return res, dataclasses.asdict(coord.stats), free

    (p, p_st, p_free), (r, r_st, _) = _both(run)
    _assert_same_records(p, r)
    assert p_st == r_st
    # the cap binds: it reshapes the schedule, and every dispatch holds a
    # grant no larger than the cap
    assert [x.clock for x in p.records] != [x.clock for x in p_free.records]
    assert all(x.power_grant_w is not None for x in p.records)


def test_rescue_stress_equals_reference():
    def run(name, pkg, g):
        jobs = list(pkg.rescue_stress_workload(g["apps"], g["tb"], n_jobs=24,
                                               seed=0, n_devices=1))
        mgr = pkg.PreemptionManager()
        res = pkg.run_schedule(jobs, "min-energy", pkg.Testbed(seed=100),
                               predictor=g["pred"], app_features=g["feats"],
                               preemption=mgr, **_dev(pkg))
        return res, dataclasses.asdict(mgr.stats)

    (p, p_st), (r, r_st) = _both(run)
    _assert_same_records(p, r)
    assert p_st == r_st and p.preemptions > 0
    # conservation: per job the dispatched work fractions sum to exactly 1
    frac: dict[int, float] = {}
    for x in p.records:
        frac[x.job_id] = frac.get(x.job_id, 0.0) + x.work_frac
    assert all(v == pytest.approx(1.0, abs=1e-12) for v in frac.values())
    assert len(p.final_records()) == len(frac)


def _drifting(pkg, g, corrector, n_jobs=300):
    svc = pkg.PredictionService(g["tb"].dvfs, predictor=g["pred"],
                                app_features=g["feats"], testbed=g["tb"],
                                **_dev(pkg))
    adapter = pkg.OnlineAdapter(svc, corrector=corrector,
                                drift=pkg.DriftConfig(**DRIFT_KW),
                                risk_scale=1.0, max_margin=0.2)
    jobs = pkg.drifting_workload(g["apps"], g["tb"], n_jobs=n_jobs, seed=0,
                                 n_devices=1, drift_names=DRIFT_APPS)
    policy = pkg.RiskAware(g["tb"].dvfs, margin=0.02,
                           margin_fn=adapter.margin)
    res = pkg.run_schedule(jobs, policy, pkg.Testbed(seed=100), service=svc,
                           feedback=adapter, **_dev(pkg))
    return res, adapter, svc


@pytest.mark.parametrize("corrector", ["rls", "gbdt"])
def test_drifting_online_equals_reference(corrector):
    def run(name, pkg, g):
        res, adapter, svc = _drifting(pkg, g, corrector)
        return (res, list(adapter.detector.drift_events), adapter.n_observed,
                dataclasses.asdict(svc.stats))

    (p, p_ev, p_n, p_st), (r, r_ev, r_n, r_st) = _both(run)
    _assert_same_records(p, r)
    assert p_ev == r_ev and p_n == r_n == len(p.records)
    assert p_ev                          # drift detected and reset
    for k in ("table_builds", "corrected_builds", "corrected_hits",
              "invalidations"):
        assert p_st[k] == r_st[k], k
    assert p_st["corrected_builds"] > 0


# ---------------------------------------------------------------------- #
#  The reference's differential identities, in the port
# ---------------------------------------------------------------------- #
def _port_stream(n_jobs, n_devices, quantum=None, seed=3):
    f = fixture()["port"]
    jobs = list(P.stream_workload(f["apps"], f["tb"], n_jobs=n_jobs,
                                  seed=seed, n_devices=n_devices))
    if quantum is not None:
        jobs = [dataclasses.replace(j, checkpoint_quantum=quantum)
                for j in jobs]
    return f, jobs


_OFF = dict(self_rescue=False, queue_rescue=False)


@pytest.mark.parametrize("pool", [None, ("v5p", "v5e", "v5lite")],
                         ids=["classless-2", "mixed"])
@pytest.mark.parametrize("policy", ["min-energy", "d-dvfs", "oracle"])
def test_segmented_never_preempted_equals_plain(pool, policy):
    f, jobs = _port_stream(40, 2 if pool is None else len(pool),
                           quantum=0.3)
    classes = None if pool is None else _pool(P, pool)
    kw = dict(predictor=f["pred"], app_features=f["feats"],
              n_devices=2, device_classes=classes, device=CPU)
    a = P.run_schedule(jobs, policy, P.Testbed(seed=1000), **kw)
    mgr = P.PreemptionManager(P.PreemptionConfig(**_OFF))
    b = P.run_schedule(jobs, policy, P.Testbed(seed=1000), preemption=mgr,
                       **kw)
    assert [_fields(x) for x in a.records] == [_fields(x) for x in b.records]
    assert mgr.stats.boundaries > 0 and mgr.stats.preemptions == 0


@pytest.mark.parametrize("grant_policy", ["uniform", "greedy-edf",
                                          "slack-weighted"])
def test_infinite_cap_equals_capless(grant_policy):
    f, jobs = _port_stream(60, 3)
    pool = _pool(P, ("v5p", "v5e", "v5lite"))
    kw = dict(predictor=f["pred"], app_features=f["feats"],
              device_classes=pool, device=CPU)
    a = P.run_schedule(jobs, "min-energy", P.Testbed(seed=1000), **kw)
    coord = P.PowerCapCoordinator(math.inf, grant_policy=grant_policy)
    b = P.run_schedule(jobs, "min-energy", P.Testbed(seed=1000),
                       power_coordinator=coord, **kw)
    assert a.records == b.records
    assert coord.stats.escalations == 0 and coord.stats.clamped == 0


@pytest.mark.parametrize("corrector", ["rls", "gbdt"])
def test_disabled_adapter_equals_frozen(corrector):
    f = fixture()["port"]

    def jobs():
        return P.drifting_workload(f["apps"], f["tb"], n_jobs=120, seed=0,
                                   n_devices=1, drift_names=DRIFT_APPS)

    def svc():
        return P.PredictionService(f["tb"].dvfs, predictor=f["pred"],
                                   app_features=f["feats"], testbed=f["tb"],
                                   device=CPU)

    frozen = P.run_schedule(jobs(), "min-energy", P.Testbed(seed=100),
                            service=svc(), device=CPU)
    s = svc()
    adapter = P.OnlineAdapter(s, corrector=corrector, enabled=False)
    off = P.run_schedule(jobs(), "min-energy", P.Testbed(seed=100),
                         service=s, feedback=adapter, device=CPU)
    assert off.records == frozen.records and adapter.n_observed == 0
    s.detach_corrector()
    assert s.corrector is None
    assert s.table(f["apps"][0].name) is s.base_table(f["apps"][0].name)


def test_single_tier_admission_is_identity():
    """Admission over a stream with no sheddable job admits everything and
    leaves the records as the admission-free run's."""
    f = fixture()["port"]
    jobs = [dataclasses.replace(j, tier=P.SLO_TIER)
            for j in P.multi_tenant_workload(f["apps"], f["tb"], n_jobs=80,
                                             seed=1, n_devices=2,
                                             overload=8.0)]
    kw = dict(predictor=f["pred"], app_features=f["feats"], n_devices=2,
              device=CPU)
    a = P.run_schedule(jobs, "min-energy", P.Testbed(seed=100), **kw)
    adm = P.AdmissionController(lookahead_s=20.0, threshold=0.5)
    b = P.run_schedule(jobs, "min-energy", P.Testbed(seed=100),
                       admission=adm, **kw)
    assert a.records == b.records and b.shed_count == 0
    assert adm.stats.deferred == 0


# ---------------------------------------------------------------------- #
#  Host-numpy units: exactly the reference's numbers
# ---------------------------------------------------------------------- #
def _observations(pkg, n=60, seed=11):
    d = pkg.V5E_DVFS
    clocks = d.clock_list()
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        c = clocks[int(rng.integers(len(clocks)))]
        name = ("a", "b")[k % 2]
        out.append(pkg.Observation(
            name=name, clock=c, time_s=float(rng.uniform(0.1, 2.0)),
            power_w=float(rng.uniform(50, 150)),
            r_time=float(rng.normal(0.1 if k > n // 2 else 0.0, 0.05)),
            r_power=float(rng.normal(0.0, 0.03))))
    return out


def test_observation_store_and_rls_equal_reference():
    got = {}
    for name, pkg in PACKAGES:
        store = pkg.ObservationStore(keep_rows=True)
        rls = pkg.RLSCorrector(store)
        for k, obs in enumerate(_observations(pkg)):
            store.update(obs, innovation=obs.r_time * 0.5 if k % 3 else None)
        st = store.stats("a")
        clocks = pkg.V5E_DVFS.clock_list()
        P_, T_ = np.linspace(60, 120, len(clocks)), np.linspace(
            1, 2, len(clocks))
        wt, wp = rls.weights("a")
        got[name] = dict(
            n=st.n, G=st.G, bt=st.bt, bp=st.bp, rows=[
                (z.tolist(), rt, rp) for z, rt, rp in store.rows("b")],
            std=store.residual_std("a"), rms=store.innovation_rms("b"),
            wt=wt, wp=wp, res=rls.predicted_residual("a", clocks[5]),
            corr=rls.correct("b", clocks, P_, T_))
        store.reset("a")
        got[name]["after"] = (store.count("a"), store.generation("a"))
    p, r = got["port"], got["ref"]
    for k in ("n", "std", "rms", "res", "after", "rows"):
        assert p[k] == r[k], k
    for k in ("G", "bt", "bp", "wt", "wp"):
        np.testing.assert_array_equal(p[k], r[k])
    for a, b in zip(p["corr"], r["corr"]):
        np.testing.assert_array_equal(a, b)


def test_drift_detector_equals_reference():
    rng = np.random.default_rng(5)
    resid = np.concatenate([rng.normal(0, 0.03, 30),
                            rng.normal(0.4, 0.03, 30)])
    out = {}
    for name, pkg in PACKAGES:
        det = pkg.DriftDetector(pkg.DriftConfig(**DRIFT_KW))
        fires = []
        for k, x in enumerate(resid):
            if det.observe("app", float(x)):
                fires.append(k)
                det.reset("app")
        out[name] = (fires, det.drift_events, det.statistic("app"))
    assert out["port"] == out["ref"] and out["port"][0]


def test_power_telemetry_integrals_equal_reference():
    pool = ("v5p", "v5e", "v5e", "v5lite")
    out = {}
    for name, pkg in PACKAGES:
        g = fixture()[name]
        res, _, _ = _cap_stress(pkg, g, pool, "slack-weighted")
        classes = _pool(pkg, pool)
        vals = []
        for view in ("measured", "predicted", "granted"):
            led = pkg.PowerTelemetry.from_result(res, pool=classes,
                                                 view=view)
            t, w = led.series()
            vals.append((len(led), led.t_start, led.t_end, led.peak_w,
                         led.peak_t, led.energy_j(), led.energy_j(1.0, 5.0),
                         led.mean_w(), led.peak_window(2.0),
                         led.duration_above(0.5 * led.peak_w),
                         led.overage_w(0.8 * led.peak_w),
                         led.power_at(0.5 * led.t_end),
                         led.energy_by_class(), t.tolist(), w.tolist()))
        out[name] = vals
    assert out["port"] == out["ref"]
