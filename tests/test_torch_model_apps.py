"""Model-derived apps on CPU: the port against the reference.

``core/model_apps.py`` over the port's own configs and the analytic half of
``roofline/analysis.py``, with the serving, training and merge generators:

* the port reproduces the ``min-energy|models|0`` golden trace, built as
  ``tests/test_golden.py`` builds it, live as its gate requires (decode and
  train-step apps of at least two architectures), and equals the reference
  record for record on it, every ``compare=False`` field compared by name;
* the analytic counters (``model_flops``, ``ssm_scan_correction``,
  ``derive_counters``), every ``model_app_suite`` profile (field for field)
  and every ``register_model_apps`` feature vector (bit for bit) equal the
  reference's, and so do the counters and profiles refined by a compiled
  record (the reference's XLA artifact, the port's dry-run trace), which
  fall back to the analytic terms in both packages;
* registration is inert, as in the reference: a paper-only stream is the
  same with or without the derived suite registered, for all six policies,
  capped and segmented too, and neither the testbed's stream nor the paper
  fixture moves;
* on mixed paper + serving + training streams (the reference's
  ``TestMixedModelStreamFuzz`` draws) and on a reduced capped headline mix
  the port equals the reference record for record and keeps the
  structural and tier-aware EDF invariants.

Tolerance everywhere is exact equality: derivation, profiling and the
generators are fp64 host numpy and plain Python in both packages.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import json
import math

import numpy as np
import pytest

import repro.core as R
import repro.core.model_apps as RM
from repro.configs import get_config as r_config
from repro.roofline import analysis as RA
from repro_torch import core as P
from repro_torch.configs import _ARCH_IDS, get_config as p_config
from repro_torch.core import model_apps as PM
from repro_torch.roofline import analysis as PA
from test_torch_coldstart import (POOLS, _check_structure, _same_runs,
                                  fuzz_fixture)
from test_torch_layers import (GOLDEN_PATH, PACKAGES, _dev, _digest, _fields,
                               fixture)

CPU = "cpu"
MODELS_KEY = "min-energy|models|0"


def _pool(pkg, names):
    return [pkg.DEVICE_CLASSES[n] for n in names]


# ---------------------------------------------------------------------- #
#  The golden trace (tests/test_golden.py's _models_run)
# ---------------------------------------------------------------------- #
def _golden_run(pkg, g):
    suite = pkg.model_app_suite()
    features = dict(g["feats"])
    features.update(pkg.register_model_apps(None, g["tb"]))
    pool = [pkg.V5P_CLASS, pkg.V5E_CLASS]
    jobs = pkg.merge_workloads(
        pkg.serving_workload(suite, g["tb"], n_jobs=14, seed=0,
                             n_devices=len(pool), pool=pool),
        pkg.training_workload(suite, g["tb"], n_jobs=4, seed=1,
                              n_devices=len(pool), pool=pool))
    res = pkg.run_schedule(jobs, "min-energy", pkg.Testbed(seed=100),
                           predictor=g["pred"], app_features=features,
                           n_devices=len(pool), device_classes=pool,
                           **_dev(pkg))
    return res, jobs


def test_port_reproduces_models_golden_digest():
    golden = json.loads(GOLDEN_PATH.read_text())["traces"]
    res, jobs = _golden_run(P, fixture()["port"])
    assert _digest(res.records) == golden[MODELS_KEY]["digest"]
    names = [rec.name for rec in res.records]
    assert len(res.records) == len(jobs) == 18
    assert any(n.endswith(":decode") for n in names)
    assert any(n.endswith(":train_step") for n in names)
    assert len({n.split(":")[0] for n in names}) >= 2
    assert {rec.device for rec in res.records} == {0, 1}
    assert all(":" in n for n in names)


def test_models_golden_run_equals_reference():
    f = fixture()
    (p, pj), (r, rj) = _golden_run(P, f["port"]), _golden_run(R, f["ref"])
    assert [(j.name, j.arrival, j.deadline, j.tier.name) for j in pj] == \
        [(j.name, j.arrival, j.deadline, j.tier.name) for j in rj]
    _same_runs(p, r)


# ---------------------------------------------------------------------- #
#  Counters, profiles and feature vectors
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", _ARCH_IDS)
def test_analytic_counters_equal_reference(arch):
    pc, rc = p_config(arch), r_config(arch)
    for phase in PM.PHASES:
        ps, rs = PM.phase_shape(phase), RM.phase_shape(phase)
        assert dataclasses.asdict(ps) == dataclasses.asdict(rs)
        for n in (1, 4, 16):
            assert PA.model_flops(pc, ps, n) == RA.model_flops(rc, rs, n)
            assert PA.ssm_scan_correction(pc, ps, n) == \
                RA.ssm_scan_correction(rc, rs, n)
        assert PM.chips_for(pc, phase) == RM.chips_for(rc, phase)
        assert PM.derive_counters(pc, phase) == RM.derive_counters(rc, phase)
        assert PM.derive_counters(pc, phase, n_chips=8) == \
            RM.derive_counters(rc, phase, n_chips=8)


def test_model_app_suite_equals_reference_field_for_field():
    ps, rs = P.model_app_suite(), R.model_app_suite()
    assert len(ps) == len(rs) == 3 * len(_ARCH_IDS) + 3
    for a, b in zip(ps, rs):
        assert dataclasses.asdict(a) == dataclasses.asdict(b), a.name
    # deterministic, and the CLI aliases reach the same app
    assert P.model_app_suite() == ps
    assert P.derive_app("mixtral-8x22b", "decode") == \
        P.derive_app("mixtral_8x22b", "decode")
    sub = P.model_app_suite(archs=["falcon-mamba-7b"], phases=("prefill",),
                            include_kernels=False)
    ref = R.model_app_suite(archs=["falcon-mamba-7b"], phases=("prefill",),
                            include_kernels=False)
    assert [dataclasses.asdict(a) for a in sub] == \
        [dataclasses.asdict(a) for a in ref]
    assert P.KIND_KNOBS == R.KIND_KNOBS and P.PHASES == R.PHASES


def test_register_model_apps_equals_reference_bitwise():
    got = {name: pkg.register_model_apps(None, pkg.Testbed(seed=0))
           for name, pkg in PACKAGES}
    assert list(got["port"]) == list(got["ref"])
    for n in got["port"]:
        np.testing.assert_array_equal(got["port"][n], got["ref"][n])


class _CompiledStub:
    """An XLA compiled artifact's cost interface, with cost data."""

    def cost_analysis(self):
        return {"flops": 1e15, "bytes accessed": 1e12}

    def as_text(self):
        return ""


def test_compiled_artifact_is_refused():
    """A compiled record refines nothing, in either package: the
    reference's ``aot_counters`` reads the bytes under a key its
    ``costs_of`` does not return, so both fall back to the analytic terms
    (the port keeps the quirk for parity)."""
    from repro_torch.roofline.analysis import Trace
    record = Trace(flops=1e15, bytes=1e12)
    for arch, phase in (("smollm_360m", "prefill"),
                        ("kimi_k2_1t_a32b", "train_step"),
                        ("falcon_mamba_7b", "decode")):
        analytic = PM.derive_counters(p_config(arch), phase)
        ref = RM.derive_counters(r_config(arch), phase,
                                 compiled=_CompiledStub())
        got = PM.derive_counters(p_config(arch), phase, compiled=record)
        assert got == ref == analytic == RM.derive_counters(
            r_config(arch), phase)
        assert RM.aot_counters(_CompiledStub()) is None
        assert PM.aot_counters(record) is None
        assert dataclasses.asdict(PM.derive_app(arch, phase,
                                                compiled=record)) == \
            dataclasses.asdict(RM.derive_app(arch, phase,
                                             compiled=_CompiledStub()))
    with pytest.raises(KeyError):
        PM.derive_app("smollm_360m", "backward")


# ---------------------------------------------------------------------- #
#  Inert registration (the reference's TestModelAppRegistrationInert)
# ---------------------------------------------------------------------- #
@functools.lru_cache(maxsize=1)
def model_fixture():
    f = fuzz_fixture()["port"]
    return {**f, "suite": P.model_app_suite(),
            "features_all": {**f["feats"],
                             **P.register_model_apps(None, f["tb"])}}


def _run(jobs, pool_idx, policy, feats, coordinator=None, preemption=None,
         pkg=P, g=None):
    g = g or fuzz_fixture()["port"]
    classes, n_dev = POOLS[pool_idx]
    pool = None if classes is None else _pool(pkg, classes)
    return pkg.run_schedule(
        jobs, policy, pkg.Testbed(seed=1000), predictor=g["pred"],
        app_features=feats, n_devices=n_dev, device_classes=pool,
        power_coordinator=coordinator, preemption=preemption, **_dev(pkg))


def _paper_jobs(seed, pool_idx, quantum):
    g = fuzz_fixture()["port"]
    jobs = list(P.stream_workload(g["apps"], g["tb"], n_jobs=30, seed=seed,
                                  n_devices=POOLS[pool_idx][1]))
    return [dataclasses.replace(j, checkpoint_quantum=quantum)
            for j in jobs]


@pytest.mark.parametrize("policy", ["dc", "mc", "d-dvfs", "min-energy",
                                    "risk-aware", "oracle"])
def test_registration_is_inert_for_paper_streams(policy):
    g, m = fuzz_fixture()["port"], model_fixture()
    jobs = _paper_jobs(3, 3, 0.0)
    a = _run(jobs, 3, policy, g["feats"])
    b = _run(jobs, 3, policy, m["features_all"])
    assert [_fields(x) for x in a.records] == [_fields(x) for x in b.records]


def test_registration_is_inert_capped_and_segmented():
    g, m = fuzz_fixture()["port"], model_fixture()
    jobs = _paper_jobs(5, 1, 0.3)
    r0 = _run(jobs, 1, "min-energy", g["feats"])
    idle_w = g["tb"].idle_power()
    led = P.PowerTelemetry.from_result(r0, idle_powers=idle_w, n_devices=2)
    cap = 2 * idle_w + 0.6 * max(led.peak_w - 2 * idle_w, 1.0)
    for capped in (False, True):
        def coord():
            return (P.PowerCapCoordinator(cap, grant_policy="slack-weighted",
                                          guard=0.15) if capped else None)
        a = _run(jobs, 1, "min-energy", g["feats"], coord())
        mgr = P.PreemptionManager(P.PreemptionConfig(self_rescue=False,
                                                     queue_rescue=False))
        b = _run(jobs, 1, "min-energy", m["features_all"], coord(), mgr)
        assert [_fields(x) for x in a.records] == \
            [_fields(x) for x in b.records]


def test_registration_leaves_stream_service_and_fixture_alone():
    tb = P.Testbed(seed=42)
    state = copy.deepcopy(tb._rng.bit_generator.state)
    P.register_model_apps(None, tb)
    assert tb._rng.bit_generator.state == state
    g, m = fuzz_fixture()["port"], model_fixture()
    assert set(g["feats"]) < set(m["features_all"])
    assert all(m["features_all"][n] is g["feats"][n] for n in g["feats"])
    svc = P.PredictionService(g["tb"].dvfs, predictor=g["pred"],
                              app_features=dict(g["feats"]), testbed=g["tb"],
                              device=CPU)
    before = {a.name: svc.base_table(a.name) for a in g["apps"][:4]}
    epoch = svc._epoch
    app = P.derive_app("mixtral_8x22b", "decode")
    with pytest.raises(P.UnknownAppError):
        svc.base_table(app.name)
    first = P.register_model_apps(svc, g["tb"])
    held = {n: svc.app_features[n] for n in first}
    P.register_model_apps(svc, g["tb"])
    assert svc._epoch == epoch
    assert all(svc.app_features[n] is held[n] for n in first)
    assert all(svc.base_table(n) is t for n, t in before.items())
    assert svc.note_app(app) is False
    tab = svc.base_table(app.name)
    assert np.all(np.isfinite(tab.T)) and np.all(tab.T > 0)


# ---------------------------------------------------------------------- #
#  Mixed paper + serving + training streams (TestMixedModelStreamFuzz)
# ---------------------------------------------------------------------- #
def _mixed_model_jobs(pkg, g, suite, seed, pool_idx, quantum):
    classes, n_dev = POOLS[pool_idx]
    pool = None if classes is None else _pool(pkg, classes)
    jobs = pkg.merge_workloads(
        pkg.stream_workload(g["apps"], g["tb"], n_jobs=12, seed=seed,
                            n_devices=n_dev),
        pkg.serving_workload(suite, g["tb"], n_jobs=14, seed=seed + 1,
                             pool=pool, n_devices=n_dev),
        pkg.training_workload(suite, g["tb"], n_jobs=6, seed=seed + 2,
                              pool=pool, n_devices=n_dev))
    if quantum:
        jobs = [dataclasses.replace(j, checkpoint_quantum=quantum)
                for j in jobs]
    return jobs


@functools.lru_cache(maxsize=1)
def _ref_model_fixture():
    f = fuzz_fixture()["ref"]
    return {**f, "suite": R.model_app_suite(),
            "features_all": {**f["feats"],
                             **R.register_model_apps(None, f["tb"])}}


def _mixed_both(seed, pool_idx, policy, cap_kind="none", preempt=False,
                quantum=0.0):
    out = {}
    for name, pkg, m in (("port", P, model_fixture()),
                         ("ref", R, _ref_model_fixture())):
        jobs = _mixed_model_jobs(pkg, m, m["suite"], seed, pool_idx,
                                 quantum)
        coord = None
        if cap_kind == "inf":
            coord = pkg.PowerCapCoordinator(math.inf, guard=0.15)
        elif cap_kind == "binding":
            classes, n_dev = POOLS[pool_idx]
            r0 = _run(jobs, pool_idx, policy, m["features_all"], pkg=pkg,
                      g=m)
            if classes is not None:
                pool = _pool(pkg, classes)
                led = pkg.PowerTelemetry.from_result(r0, pool=pool)
                idle = sum(c.idle_power() for c in pool)
            else:
                idle_w = m["tb"].idle_power()
                led = pkg.PowerTelemetry.from_result(
                    r0, idle_powers=idle_w, n_devices=n_dev)
                idle = idle_w * n_dev
            coord = pkg.PowerCapCoordinator(
                idle + 0.6 * max(led.peak_w - idle, 1.0),
                grant_policy="slack-weighted", guard=0.15)
        mgr = (pkg.PreemptionManager(pkg.PreemptionConfig(
            margin=0.02, min_remnant_frac=0.02)) if preempt else None)
        out[name] = jobs, _run(jobs, pool_idx, policy, m["features_all"],
                               coord, mgr, pkg=pkg, g=m)
    (jobs, p), (_, r) = out["port"], out["ref"]
    _same_runs(p, r)
    _check_structure(jobs, p)
    return jobs, p


def _check_edf_tiered(jobs, res) -> None:
    starts = {rec.job_id: rec.start for rec in res.records
              if rec.segment == 0}
    by_id = {j.job_id: j for j in jobs}
    order = sorted(starts.items(), key=lambda kv: kv[1])
    for i, (jb, sb) in enumerate(order):
        for ja, sa in order[i + 1:]:
            a, b = by_id[ja], by_id[jb]
            if a.arrival <= sb and sa > sb:
                ka, kb = P.edf_key(a), P.edf_key(b)
                assert (ka[0] > kb[0]
                        or (ka[0] == kb[0] and ka[1] >= kb[1] - 1e-9)), \
                    (ja, jb)


def test_mixed_model_stream_is_live():
    _, res = _mixed_both(0, 3, "min-energy")
    names = {rec.name for rec in res.records}
    assert any(n.endswith(":decode") for n in names)
    assert any(n.endswith(":train_step") for n in names)
    assert len({n.split(":")[0] for n in names if ":" in n}) >= 2
    assert names & {a.name for a in fuzz_fixture()["port"]["apps"]}


@pytest.mark.parametrize("seed,pool_idx,policy", [
    (1, 0, "min-energy"), (9, 1, "d-dvfs"), (17, 2, "risk-aware"),
    (23, 3, "oracle"), (31, 3, "mc"), (42, 1, "dc")])
def test_mixed_model_stream_uncapped_equals_reference(seed, pool_idx,
                                                      policy):
    jobs, res = _mixed_both(seed, pool_idx, policy)
    _check_edf_tiered(jobs, res)


@pytest.mark.parametrize("seed,pool_idx,policy,cap_kind,preempt,quantum", [
    (2, 3, "min-energy", "binding", True, 0.3),
    (11, 1, "d-dvfs", "inf", True, 1.1),
    (27, 2, "risk-aware", "binding", False, 0.6),
    (40, 0, "min-energy", "binding", True, 0.08)])
def test_mixed_model_stream_capped_preemptive_equals_reference(
        seed, pool_idx, policy, cap_kind, preempt, quantum):
    _mixed_both(seed, pool_idx, policy, cap_kind, preempt, quantum)


def test_segmented_never_preempted_identity_on_mixed_model_stream():
    m = model_fixture()
    jobs = _mixed_model_jobs(P, m, m["suite"], 7, 3, 0.2)
    a = _run(jobs, 3, "min-energy", m["features_all"])
    mgr = P.PreemptionManager(P.PreemptionConfig(self_rescue=False,
                                                 queue_rescue=False))
    b = _run(jobs, 3, "min-energy", m["features_all"], preemption=mgr)
    assert [_fields(x) for x in a.records] == [_fields(x) for x in b.records]
    assert mgr.stats.preemptions == 0


# ---------------------------------------------------------------------- #
#  bench_models_sched's capped headline mix, reduced
# ---------------------------------------------------------------------- #
def _headline(pkg, g, n_serve=40, n_train=10):
    pool = [pkg.V5P_CLASS, pkg.V5E_CLASS, pkg.V5E_CLASS, pkg.V5LITE_CLASS]
    suite = pkg.model_app_suite()
    feats = dict(g["feats"])
    feats.update(pkg.register_model_apps(None, g["tb"]))
    jobs = pkg.merge_workloads(
        pkg.serving_workload(suite, g["tb"], n_jobs=n_serve, seed=0,
                             n_devices=len(pool), pool=pool, overload=1.3),
        pkg.training_workload(suite, g["tb"], n_jobs=n_train, seed=1,
                              n_devices=len(pool), pool=pool))
    kw = dict(predictor=g["pred"], app_features=feats, n_devices=len(pool),
              device_classes=pool, **_dev(pkg))
    r0 = pkg.run_schedule(jobs, "mc", pkg.Testbed(seed=100), **kw)
    led = pkg.PowerTelemetry.from_result(r0, pool=pool)
    idle = sum(c.idle_power() for c in pool)
    cap = idle + 0.7 * max(led.peak_w - idle, 1.0)
    out = {}
    for pol in ("mc", "min-energy"):
        coord = pkg.PowerCapCoordinator(cap, grant_policy="slack-weighted",
                                        guard=0.15)
        out[pol] = (pkg.run_schedule(jobs, pol, pkg.Testbed(seed=100),
                                     power_coordinator=coord, **kw),
                    dataclasses.asdict(coord.stats))
    return out


def test_capped_headline_mix_equals_reference():
    f = fixture()
    p, r = _headline(P, f["port"]), _headline(R, f["ref"])
    for pol in ("mc", "min-energy"):
        _same_runs(p[pol][0], r[pol][0])
        assert p[pol][1] == r[pol][1]
    assert p["min-energy"][0].total_energy < p["mc"][0].total_energy
    assert {x.tier for x in p["min-energy"][0].records} >= {"slo", "batch"}
