"""The whole slice on CPU: the port's scheduler against the reference.

* The port reproduces the 12 base golden traces (6 policies × seeds 0, 1)
  of ``tests/golden/schedule_traces.json`` exactly, projected and hashed
  as ``tests/test_golden.py`` does.
* The port's ``run_schedule`` equals its ``legacy_run_schedule`` record for
  record, and its scalar decision path equals its batched one.
* A 2000-job ``stream_workload`` on 8 devices is record-identical between
  the port and ``repro.core.run_schedule`` — every float equal, predicted
  power and time included: the port's GBDT sums run in numpy's order, so
  the tables, the clocks and the RNG draws all match.
"""
from __future__ import annotations

import functools
import hashlib
import json
import pathlib

import numpy as np
import pytest

import repro.core as R
from repro.configs.paper_suite import PAPER_APPS as R_APPS
from repro.core.gbdt import GBDTParams as RGBDTParams
from repro_torch import core as P
from repro_torch.configs.paper_suite import PAPER_APPS as P_APPS
from repro_torch.core.gbdt import GBDTParams as PGBDTParams
from repro_torch.core.policies import POLICY_NAMES

GOLDEN_PATH = pathlib.Path(__file__).parent / "golden" / \
    "schedule_traces.json"
SEEDS = (0, 1)
CPU = "cpu"
_G = dict(iterations=80, depth=3, learning_rate=0.15)


@functools.lru_cache(maxsize=1)
def fixture():
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


def _round(x: float) -> float:
    return float(f"{x:.12g}")


def _digest(records) -> str:
    trace = [[r.job_id, r.name, r.device, r.clock.core_mhz, r.clock.mem_mhz,
              _round(r.start), _round(r.end), _round(r.time_s),
              _round(r.power_w), _round(r.energy_j), int(r.met_deadline),
              int(r.had_feasible_clock)] for r in records]
    blob = json.dumps(trace, separators=(",", ":"), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()


def _port_run(policy, seed, legacy=False, **kw):
    f = fixture()["port"]
    jobs = P.make_workload(f["apps"], f["tb"], seed=seed)
    fn = P.legacy_run_schedule if legacy else P.run_schedule
    return fn(jobs, policy, P.Testbed(seed=100 + seed), predictor=f["pred"],
              app_features=f["feats"], device=CPU, **kw)


@pytest.mark.parametrize("policy", POLICY_NAMES)
@pytest.mark.parametrize("seed", SEEDS)
def test_port_reproduces_golden_digest(policy, seed):
    golden = json.loads(GOLDEN_PATH.read_text())["traces"]
    assert _digest(_port_run(policy, seed).records) == \
        golden[f"{policy}|{seed}"]["digest"]


@pytest.mark.parametrize("policy", POLICY_NAMES)
def test_run_schedule_equals_legacy(policy):
    for seed in SEEDS:
        new = _port_run(policy, seed)
        old = _port_run(policy, seed, legacy=True)
        assert new.records == old.records
        assert len(new.records) == len(P_APPS)


def _fields(rec) -> tuple:
    """Every behavior field of an ExecutionRecord (both packages)."""
    return (rec.job_id, rec.name, rec.arrival, rec.deadline, rec.start,
            rec.end, rec.device, rec.clock.s_core, rec.clock.s_mem,
            rec.time_s, rec.power_w, rec.energy_j, rec.predicted_time,
            rec.predicted_power, rec.met_deadline, rec.had_feasible_clock,
            rec.device_class, rec.tier)


def _stream_pair(policy, n_devices=8, pool=None, **kw):
    f = fixture()
    out = []
    for name, pkg in (("ref", R), ("port", P)):
        g = f[name]
        jobs = pkg.stream_workload(g["apps"], g["tb"], n_jobs=2000, seed=1,
                                   n_devices=n_devices)
        extra = {} if pkg is R else {"device": CPU}
        classes = None if pool is None else [
            pkg.DEVICE_CLASSES[c] for c in pool]
        out.append(pkg.run_schedule(
            jobs, policy, g["tb"], predictor=g["pred"],
            app_features=g["feats"], n_devices=n_devices,
            device_classes=classes, **kw, **extra))
    return out


def test_stream_2000_jobs_record_identical_to_reference():
    r, p = _stream_pair("min-energy", queue_aware=False,
                        virtual_pacing=False)
    assert len(p.records) == 2000
    assert [_fields(x) for x in p.records] == \
        [_fields(x) for x in r.records]
    assert p.total_energy == r.total_energy and p.misses == r.misses


def test_stream_heterogeneous_pool_record_identical_to_reference():
    pool = ("v5p", "v5p", "v5e", "v5e", "v5e", "v5e", "v5lite", "v5lite")
    r, p = _stream_pair("risk-aware", pool=pool)
    assert [_fields(x) for x in p.records] == \
        [_fields(x) for x in r.records]
    assert {x.device_class for x in p.records} > {"v5e"}


@pytest.mark.parametrize("policy", ["d-dvfs", "oracle"])
def test_batched_decisions_equal_scalar(policy):
    f = fixture()["port"]
    pool = [P.V5P_CLASS, P.V5E_CLASS, P.V5E_CLASS, P.V5LITE_CLASS]
    runs = []
    for bd in (False, True):
        jobs = P.stream_workload(f["apps"], f["tb"], n_jobs=400, seed=2,
                                 n_devices=len(pool))
        runs.append(P.run_schedule(
            jobs, policy, f["tb"], predictor=f["pred"],
            app_features=f["feats"], device_classes=pool, batch_decide=bd,
            device=CPU))
    assert runs[0].records == runs[1].records


def test_tables_built_once_per_app():
    f = fixture()["port"]
    svc = P.PredictionService(f["tb"].dvfs, f["pred"], f["feats"],
                              testbed=f["tb"], device=CPU)
    jobs = P.stream_workload(f["apps"], f["tb"], n_jobs=300, seed=3,
                             n_devices=4)
    P.run_schedule(jobs, "min-energy", f["tb"], service=svc, n_devices=4,
                   device=CPU)
    assert svc.stats.table_builds == len(P_APPS)
    assert svc.stats.prefetched_tables == len(P_APPS)
