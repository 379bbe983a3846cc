"""The cold-start tier on CPU: the port against the reference.

``core/coldstart.py`` with the service's synthesized tier, the engine's
arrival note and ``run_schedule(coldstart=...)``:

* the port reproduces the ``min-energy|coldstart|0`` golden trace, built as
  ``tests/test_golden.py`` builds it, and equals the reference record for
  record on it, every ``compare=False`` field compared by name;
* static embeddings and synthesized tables (standalone and service-bound,
  on every device class) equal the reference's bit for bit, and so do the
  nearest profiled neighbours and the transferred efficiencies;
* on mixed profiled/unseen streams — with the RLS corrector refining the
  synthesized tables, and over pools, policies, caps and preemption — the
  port equals the reference record for record and keeps the structural
  invariants of the reference's cold-start fuzz. Its registration count is
  held to the novel apps that are actually in the stream (the reference's
  fuzz asserts 3 even for streams that leave a novel app out);
* with every app profiled, an attached synthesizer changes nothing (all six
  policies), and the lifecycle (registration, promotion, detach) behaves as
  the reference's.

Tolerance everywhere is exact equality: the tier is fp64 host numpy in both
packages, and the nearest-profiled index labels the same clusters.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math

import numpy as np
import pytest

import repro.core as R
from repro.configs.paper_suite import PAPER_APPS as R_APPS
from repro.core.gbdt import GBDTParams as RGBDTParams
from repro_torch import core as P
from repro_torch.configs.paper_suite import PAPER_APPS as P_APPS
from repro_torch.core.gbdt import GBDTParams as PGBDTParams
from test_torch_layers import (GOLDEN_PATH, PACKAGES, _dev, _digest, _fields,
                               fixture)

CPU = "cpu"
COLD_KEY = "min-energy|coldstart|0"
COLD_HELDOUT = 4
#: tests/test_differential.py's fuzz fixture: 6 paper apps, 60 trees
FUZZ_APPS = 6
_G60 = dict(iterations=60, depth=3, learning_rate=0.15)
#: the fuzz's pools: (device classes or None, device count)
POOLS = ((None, 1), (None, 2), (("v5e",) * 3, 3), (("v5p", "v5e", "v5lite"),
                                                    3))


@functools.lru_cache(maxsize=1)
def fuzz_fixture():
    """tests/test_differential.py's ``_fixture`` in both packages."""
    out = {}
    for name, pkg, apps, params in (("ref", R, R_APPS, RGBDTParams),
                                    ("port", P, P_APPS, PGBDTParams)):
        apps = list(apps)[:FUZZ_APPS]
        tb = pkg.Testbed(seed=0)
        X, yp, yt, _ = pkg.build_dataset(apps, tb, seed=0)
        rng = np.random.default_rng(7)
        cfg = pkg.PredictorConfig(gbdt=params(l2_leaf_reg=5.0, **_G60),
                                  gbdt_time=params(l2_leaf_reg=3.0, **_G60))
        out[name] = dict(
            tb=tb, apps=apps, pred=pkg.EnergyTimePredictor(
                cfg, **_dev(pkg)).fit(X, yp, yt),
            feats={a.name: pkg.profile_features(a, tb, rng=rng)
                   for a in apps})
    return out


def _rand_app(pkg, rng: np.random.Generator, i: int = 0):
    """tests/test_coldstart.py's random static counters."""
    return pkg.AppProfile(
        name=f"h-{i}",
        flops=10.0 ** rng.uniform(10.0, 15.0),
        hbm_bytes=10.0 ** rng.uniform(8.0, 12.5),
        coll_bytes=float(rng.choice([0.0, 10.0 ** rng.uniform(6.0, 11.0)])),
        overhead_s=float(rng.uniform(0.0, 2.0)),
        kind=str(rng.choice(["kernel", "train", "prefill", "decode"])),
        n_chips=int(rng.choice([1, 4, 16])))


def _service(pkg, g, feats=None):
    return pkg.PredictionService(
        g["tb"].dvfs, predictor=g["pred"],
        app_features=dict(g["feats"] if feats is None else feats),
        testbed=g["tb"], **_dev(pkg))


def _same_runs(p, r) -> None:
    assert len(p.records) == len(r.records)
    for i, (a, b) in enumerate(zip(p.records, r.records)):
        assert _fields(a) == _fields(b), (i, a, b)
    assert p.total_energy == r.total_energy and p.misses == r.misses


# ---------------------------------------------------------------------- #
#  The golden trace (tests/test_golden.py's _coldstart_run)
# ---------------------------------------------------------------------- #
def _golden_run(pkg, g):
    held_out = {a.name for a in g["apps"][-COLD_HELDOUT:]}
    profiled = {n: v for n, v in g["feats"].items() if n not in held_out}
    svc = _service(pkg, g, profiled)
    synth = pkg.ColdStartSynthesizer()
    jobs = pkg.make_workload(g["apps"], g["tb"], seed=0)
    res = pkg.run_schedule(jobs, "min-energy", pkg.Testbed(seed=100),
                           service=svc, coldstart=synth, **_dev(pkg))
    return res, synth, svc, held_out


def test_port_reproduces_coldstart_golden_digest():
    golden = json.loads(GOLDEN_PATH.read_text())["traces"]
    res, synth, svc, held_out = _golden_run(P, fixture()["port"])
    assert _digest(res.records) == golden[COLD_KEY]["digest"]
    # live: the held-out apps really dispatched from synthesized tables
    assert synth.stats.registered == COLD_HELDOUT
    assert svc.stats.synthesized_builds > 0
    assert held_out <= {r.name for r in res.records}
    assert all(svc.base_table(n).source == "synthesized" for n in held_out)


def test_coldstart_golden_run_equals_reference():
    f = fixture()
    (p, ps, psvc, _), (r, rs, rsvc, _) = (_golden_run(P, f["port"]),
                                          _golden_run(R, f["ref"]))
    _same_runs(p, r)
    assert dataclasses.asdict(ps.stats) == dataclasses.asdict(rs.stats)
    for k in ("table_builds", "synthesized_builds", "table_hits",
              "point_predictions"):
        assert getattr(psvc.stats, k) == getattr(rsvc.stats, k), k
    for name in sorted(ps._static):
        assert ps.neighbor(name) == rs.neighbor(name)
        assert ps._transfer(name) == rs._transfer(name)


# ---------------------------------------------------------------------- #
#  Static embeddings and synthesized tables, bit for bit
# ---------------------------------------------------------------------- #
def _apps_for_embedding(pkg):
    rng = np.random.default_rng(11)
    apps = [_rand_app(pkg, rng, i) for i in range(12)]
    paper = R_APPS if pkg is R else P_APPS
    return apps + list(paper)


@pytest.mark.parametrize("cls", ["v5e", "v5p", "v5lite"])
def test_static_features_equal_reference_bitwise(cls):
    got = {}
    for name, pkg in PACKAGES:
        d = pkg.DEVICE_CLASSES[cls].dvfs
        got[name] = np.stack([pkg.static_features(a, d)
                              for a in _apps_for_embedding(pkg)])
    np.testing.assert_array_equal(got["port"], got["ref"])
    assert np.all(np.isfinite(got["port"]))


def test_standalone_synthesized_tables_equal_reference_bitwise():
    """No profiled corpus: the κ = 1 analytic prior on every class."""
    tabs = {}
    for name, pkg in PACKAGES:
        synth = pkg.ColdStartSynthesizer(dvfs=pkg.V5E_DVFS, **_dev(pkg))
        out = []
        for app in _apps_for_embedding(pkg)[:12]:
            assert synth.register(app)
            assert synth.neighbor(app.name) is None
            for cls in ("v5e", "v5p", "v5lite"):
                d = pkg.DEVICE_CLASSES[cls].dvfs
                out.append(synth.synthesize(app.name, d.clock_list(), d))
        tabs[name] = out, dataclasses.asdict(synth.stats)
    (p, p_st), (r, r_st) = tabs["port"], tabs["ref"]
    assert p_st == r_st
    for (pp, pt), (rp, rt) in zip(p, r):
        np.testing.assert_array_equal(pp, rp)
        np.testing.assert_array_equal(pt, rt)


@pytest.mark.parametrize("k", [5, None])
def test_service_synthesized_tables_equal_reference_bitwise(k):
    """κ transferred from the profiled corpus's nearest neighbour (k-means
    with k = 5, or elbow-chosen), tables served by the service on every
    device class, point predictions included."""
    out = {}
    for name, pkg in PACKAGES:
        g = fixture()[name]
        svc = _service(pkg, g)
        synth = pkg.ColdStartSynthesizer(pkg.ColdStartConfig(k=k))
        svc.attach_synthesizer(synth)
        rows = []
        for app in _apps_for_embedding(pkg)[:12]:
            assert svc.note_app(app)
            rows.append((synth.neighbor(app.name), synth._transfer(app.name),
                         synth.status(app.name)))
            for cls in (None, "v5p", "v5lite"):
                c = None if cls is None else pkg.DEVICE_CLASSES[cls]
                tab = svc.table(app.name, c)
                assert tab.source == "synthesized"
                rows.append((tab.P.tolist(), tab.T.tolist(),
                             svc.t_min(app.name, c), svc.t_dc(app.name, c)))
        out[name] = rows, svc.stats.synthesized_builds
    assert out["port"] == out["ref"]
    assert out["port"][1] > 0


# ---------------------------------------------------------------------- #
#  Mixed profiled/unseen streams: record for record
# ---------------------------------------------------------------------- #
def _novel(pkg, apps, seed: int, n: int = 3):
    rng = np.random.default_rng(seed)
    return [dataclasses.replace(
        apps[i % len(apps)], name=f"novel-{i}", seed=700 + i,
        stall_frac=float(rng.uniform(0.2, 0.5)),
        core_eff=float(rng.uniform(0.55, 0.85))) for i in range(n)]


def test_mixed_stream_with_feedback_equals_reference():
    """bench_coldstart's corrected arm, reduced: novel apps arrive through
    a 200-job stream, the RLS corrector refines their synthesized tables,
    and promotions fire."""
    def run(pkg, g):
        novel = _novel(pkg, g["apps"], 42, n=4)
        jobs = list(pkg.stream_workload(g["apps"] + novel, g["tb"],
                                        n_jobs=200, seed=11, n_devices=2,
                                        utilization=0.65))
        svc = _service(pkg, g)
        synth = pkg.ColdStartSynthesizer()
        adapter = pkg.OnlineAdapter(svc, risk_scale=1.0, max_margin=0.2)
        res = pkg.run_schedule(
            jobs, pkg.RiskAware(pkg.V5E_DVFS, margin=0.05,
                                margin_fn=adapter.margin),
            pkg.Testbed(seed=100), service=svc, n_devices=2,
            coldstart=synth, feedback=adapter, **_dev(pkg))
        return (res, dataclasses.asdict(synth.stats),
                dataclasses.asdict(svc.stats), adapter.n_observed)

    f = fixture()
    (p, p_syn, p_svc, p_n), (r, r_syn, r_svc, r_n) = (run(P, f["port"]),
                                                      run(R, f["ref"]))
    _same_runs(p, r)
    assert p_syn == r_syn and p_n == r_n
    for k in ("table_builds", "synthesized_builds", "corrected_builds",
              "invalidations"):
        assert p_svc[k] == r_svc[k], k
    assert p_syn["registered"] == 4 and p_syn["promotions"] > 0


def _mixed_jobs(pkg, g, seed: int, n_dev: int, quantum: float):
    """tests/test_differential.py's ``_mixed_jobs``."""
    novel = _novel(pkg, g["apps"], seed)
    jobs = list(pkg.stream_workload(g["apps"] + novel, g["tb"], n_jobs=30,
                                    seed=seed, n_devices=n_dev))
    return [dataclasses.replace(j, checkpoint_quantum=quantum)
            for j in jobs]


def _fuzz_run(pkg, g, seed, pool_idx, policy, cap_kind="none",
              preempt=False, quantum=0.0):
    classes, n_dev = POOLS[pool_idx]
    pool = None if classes is None else [pkg.DEVICE_CLASSES[c]
                                         for c in classes]
    jobs = _mixed_jobs(pkg, g, seed, n_dev, quantum)

    def run(coord, mgr):
        synth = pkg.ColdStartSynthesizer()
        res = pkg.run_schedule(
            jobs, policy, pkg.Testbed(seed=1000), predictor=g["pred"],
            app_features=g["feats"], n_devices=n_dev, device_classes=pool,
            power_coordinator=coord, preemption=mgr, coldstart=synth,
            **_dev(pkg))
        return res, synth

    coord = None
    if cap_kind == "inf":
        coord = pkg.PowerCapCoordinator(math.inf, guard=0.15)
    elif cap_kind == "binding":
        r0, _ = run(None, None)
        if pool is not None:
            led = pkg.PowerTelemetry.from_result(r0, pool=pool)
            idle = sum(c.idle_power() for c in pool)
        else:
            idle_w = g["tb"].idle_power()
            led = pkg.PowerTelemetry.from_result(r0, idle_powers=idle_w,
                                                 n_devices=n_dev)
            idle = idle_w * n_dev
        coord = pkg.PowerCapCoordinator(
            idle + 0.6 * max(led.peak_w - idle, 1.0),
            grant_policy="slack-weighted", guard=0.15)
    mgr = (pkg.PreemptionManager(pkg.PreemptionConfig(
        margin=0.02, min_remnant_frac=0.02)) if preempt else None)
    res, synth = run(coord, mgr)
    return jobs, res, synth


def _check_structure(jobs, res) -> None:
    """The reference fuzz's structural invariants: every job runs, its
    work fractions sum to 1 with one final segment, energy decomposes,
    devices never overlap."""
    by_job: dict[int, list] = {}
    for rec in res.records:
        by_job.setdefault(rec.job_id, []).append(rec)
    assert sorted(by_job) == sorted(j.job_id for j in jobs)
    for jid, recs in by_job.items():
        recs.sort(key=lambda x: x.start)
        assert math.fsum(x.work_frac for x in recs) == pytest.approx(
            1.0, abs=1e-9), jid
        assert [x.preempted for x in recs] == \
            [True] * (len(recs) - 1) + [False]
    for rec in res.records:
        assert rec.energy_j == pytest.approx(
            rec.time_s * rec.power_w + rec.overhead_j, rel=1e-12)
    by_dev: dict[int, list] = {}
    for rec in res.records:
        by_dev.setdefault(rec.device, []).append((rec.start, rec.end))
    for spans in by_dev.values():
        spans.sort()
        for (_, e1), (s2, _) in zip(spans, spans[1:]):
            assert s2 >= e1 - 1e-9


def _check_edf(jobs, res) -> None:
    starts = {rec.job_id: rec.start for rec in res.records
              if rec.segment == 0}
    by_id = {j.job_id: j for j in jobs}
    order = sorted(starts.items(), key=lambda kv: kv[1])
    for i, (jb, sb) in enumerate(order):
        for ja, sa in order[i + 1:]:
            a, b = by_id[ja], by_id[jb]
            if a.arrival <= sb and sa > sb:
                assert a.deadline >= b.deadline - 1e-9, (ja, jb)


def _fuzz_both(*args, **kw):
    f = fuzz_fixture()
    (pj, p, ps), (_, r, rs) = (_fuzz_run(P, f["port"], *args, **kw),
                               _fuzz_run(R, f["ref"], *args, **kw))
    _same_runs(p, r)
    assert dataclasses.asdict(ps.stats) == dataclasses.asdict(rs.stats)
    # registration counts the novel apps the stream really carries
    present = {j.name for j in pj if j.name.startswith("novel-")}
    assert ps.stats.registered == len(present)
    assert {rec.name for rec in p.records} >= present
    _check_structure(pj, p)
    return pj, p


#: seeds 10, 20, 30, 38 and 50 draw streams that leave a novel app out
@pytest.mark.parametrize("seed,pool_idx,policy", [
    (3, 0, "min-energy"), (10, 1, "d-dvfs"), (20, 2, "oracle"),
    (30, 3, "risk-aware"), (38, 0, "mc"), (50, 3, "dc"),
    (7, 2, "min-energy"), (44, 1, "risk-aware")])
def test_mixed_stream_fuzz_uncapped_equals_reference(seed, pool_idx, policy):
    jobs, res = _fuzz_both(seed, pool_idx, policy)
    _check_edf(jobs, res)


@pytest.mark.parametrize("seed,pool_idx,policy,cap_kind,preempt,quantum", [
    (5, 3, "min-energy", "binding", True, 0.2),
    (10, 1, "d-dvfs", "inf", True, 0.7),
    (20, 2, "risk-aware", "binding", False, 1.2),
    (38, 0, "min-energy", "binding", True, 0.05),
    (12, 3, "risk-aware", "none", True, 0.4),
    (50, 2, "d-dvfs", "binding", True, 1.5)])
def test_mixed_stream_fuzz_capped_preemptive_equals_reference(
        seed, pool_idx, policy, cap_kind, preempt, quantum):
    _fuzz_both(seed, pool_idx, policy, cap_kind, preempt, quantum)


def test_trigger_disabled_manager_is_identity_on_mixed_stream():
    g = fuzz_fixture()["port"]
    classes, n_dev = POOLS[1]
    jobs = _mixed_jobs(P, g, 7, n_dev, 0.2)
    kw = dict(predictor=g["pred"], app_features=g["feats"], n_devices=n_dev,
              device=CPU)
    a = P.run_schedule(jobs, "min-energy", P.Testbed(seed=1000),
                       coldstart=P.ColdStartSynthesizer(), **kw)
    mgr = P.PreemptionManager(P.PreemptionConfig(self_rescue=False,
                                                 queue_rescue=False))
    b = P.run_schedule(jobs, "min-energy", P.Testbed(seed=1000),
                       coldstart=P.ColdStartSynthesizer(), preemption=mgr,
                       **kw)
    assert [_fields(x) for x in a.records] == [_fields(x) for x in b.records]
    assert mgr.stats.boundaries > 0 and mgr.stats.preemptions == 0


# ---------------------------------------------------------------------- #
#  Zero unseen apps: the synthesizer changes nothing
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("policy", ["dc", "mc", "d-dvfs", "min-energy",
                                    "risk-aware", "oracle"])
def test_zero_unseen_apps_is_identity(policy):
    g = fixture()["port"]
    jobs = list(P.stream_workload(g["apps"], g["tb"], n_jobs=40, seed=5,
                                  n_devices=2))
    plain = P.run_schedule(jobs, policy, P.Testbed(seed=200),
                           service=_service(P, g), n_devices=2, device=CPU)
    synth = P.ColdStartSynthesizer()
    cold = P.run_schedule(jobs, policy, P.Testbed(seed=200),
                          service=_service(P, g), n_devices=2,
                          coldstart=synth, device=CPU)
    assert [_fields(x) for x in cold.records] == \
        [_fields(x) for x in plain.records]
    assert synth.stats.registered == synth.stats.synthesized_tables == 0


# ---------------------------------------------------------------------- #
#  Lifecycle and the service's tier
# ---------------------------------------------------------------------- #
def test_lifecycle_equals_reference():
    out = {}
    for name, pkg in PACKAGES:
        g = fixture()[name]
        svc = _service(pkg, g)
        synth = pkg.ColdStartSynthesizer(pkg.ColdStartConfig(warm_after=3))
        svc.attach_synthesizer(synth)
        assert svc.synthesizer is synth
        app = _rand_app(pkg, np.random.default_rng(1), 0)
        trail = [synth.status(app.name), svc.note_app(app),
                 svc.note_app(app), svc.note_app(g["apps"][0]),
                 synth.status(app.name)]
        for _ in range(3):
            svc.invalidate(app.name)       # observation-driven
            trail.append((synth.status(app.name),
                          synth.observations_of(app.name)))
        svc.invalidate(g["apps"][0].name)  # profiled: no promotion clock
        trail.append(dataclasses.asdict(synth.stats))
        out[name] = trail
    assert out["port"] == out["ref"]
    assert out["port"][-2][0] == "warmed"


def test_detach_restores_unknown_app_error():
    g = fixture()["port"]
    svc = _service(P, g)
    svc.attach_synthesizer(P.ColdStartSynthesizer())
    app = _rand_app(P, np.random.default_rng(4), 0)
    svc.note_app(app)
    assert svc.base_table(app.name).source == "synthesized"
    svc.detach_synthesizer()
    assert svc.synthesizer is None
    with pytest.raises(P.UnknownAppError, match="nearest profiled app"):
        svc.table(app.name)
    # without a synthesizer the engine raises on the unseen app, as the
    # reference does
    jobs = [P.Job(app=app, arrival=0.0, deadline=100.0, job_id=0)]
    with pytest.raises(P.UnknownAppError):
        P.run_schedule(jobs, "min-energy", P.Testbed(seed=1),
                       service=_service(P, g), device=CPU)


def test_synthesizer_index_runs_on_the_service_device():
    g = fixture()["port"]
    svc = _service(P, g)
    synth = P.ColdStartSynthesizer()
    assert synth.device is None
    svc.attach_synthesizer(synth)
    svc.note_app(_rand_app(P, np.random.default_rng(2), 0))
    synth.neighbor("h-0")
    assert synth.device == svc.device == synth._index.kmeans_.device
    standalone = P.ColdStartSynthesizer(dvfs=P.V5E_DVFS, device=CPU)
    assert standalone.device.type == "cpu"
