"""Module-by-module parity of the PyTorch port with the JAX reference, on CPU.

Same inputs (numpy seeds) through ``repro`` and ``repro_torch``:

* the host-numpy substrate (testbed, features, dataset, workloads) and the
  GBDT fit are *exactly* equal — same code, same RNG streams;
* GBDT predictions are equal bit for bit: both are fp64 and the port sums
  trees in numpy's pairwise order (``repro_torch.kernels.ref.
  pairwise_program``), so predictor outputs, service tables and point
  predictions are compared exactly;
* k-means labels are equal and centers/SSE agree to 1e-5: both Lloyd
  sweeps run in float32 (the reference's because JAX runs without x64),
  with different reduction orders.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

import repro.core as R
from repro.configs.paper_suite import PAPER_APPS as R_APPS
from repro.core.gbdt import GBDTParams as RGBDTParams
from repro.core.kmeans import KMeans as RKMeans, choose_k_elbow as r_elbow
from repro_torch import core as P
from repro_torch.configs.paper_suite import PAPER_APPS as P_APPS
from repro_torch.convert import predictor_arrays, predictor_from_arrays
from repro_torch.core.gbdt import GBDTParams as PGBDTParams
from repro_torch.core.kmeans import KMeans as PKMeans, choose_k_elbow

F32_TOL = 1e-5       # float32 Lloyd sweeps, reduction order only
CPU = "cpu"
_G = dict(iterations=80, depth=3, learning_rate=0.15)


def _cfg(pkg_cfg, pkg_params):
    return pkg_cfg(gbdt=pkg_params(l2_leaf_reg=5.0, **_G),
                   gbdt_time=pkg_params(l2_leaf_reg=3.0, **_G))


@functools.lru_cache(maxsize=1)
def fixture():
    """The golden fixture of tests/test_golden.py, in both packages."""
    out = {}
    for name, pkg, apps, params in (("ref", R, R_APPS, RGBDTParams),
                                    ("port", P, P_APPS, PGBDTParams)):
        tb = pkg.Testbed(seed=0)
        X, yp, yt, groups = pkg.build_dataset(list(apps), tb, seed=0)
        rng = np.random.default_rng(7)
        feats = {a.name: pkg.profile_features(a, tb, rng=rng) for a in apps}
        cfg = _cfg(pkg.PredictorConfig, params)
        kw = {} if pkg is R else {"device": CPU}
        pred = pkg.EnergyTimePredictor(cfg, **kw).fit(X, yp, yt)
        out[name] = dict(tb=tb, apps=list(apps), X=X, yp=yp, yt=yt,
                         groups=groups, feats=feats, pred=pred)
    return out


def test_paper_suite_is_the_reference_suite():
    assert [vars(a) for a in P_APPS] == [vars(a) for a in R_APPS]


def test_testbed_run_and_sweep_exact():
    tr, tp = R.Testbed(seed=3), P.Testbed(seed=3)
    for ra, pa in zip(R_APPS, P_APPS):
        for rc, pc in zip(tr.dvfs.clock_list()[::7],
                          tp.dvfs.clock_list()[::7]):
            mr, mp = tr.run(ra, rc), tp.run(pa, pc)
            assert (mr.time_s, mr.power_w) == (mp.time_s, mp.power_w)
    for ra, pa in zip(R_APPS[:3], P_APPS[:3]):
        sr, sp = tr.sweep(ra), tp.sweep(pa)
        assert list(sr) == list(sp)
        assert [(m.time_s, m.power_w) for m in sr.values()] == \
            [(m.time_s, m.power_w) for m in sp.values()]


def test_device_classes_exact():
    for name, rc in R.DEVICE_CLASSES.items():
        pc = P.DEVICE_CLASSES[name]
        assert vars(rc.dvfs) == vars(pc.dvfs)
        assert (rc.perf_scale, rc.bw_scale, rc.idle_power()) == \
            (pc.perf_scale, pc.bw_scale, pc.idle_power())


def test_profile_features_and_dataset_exact():
    f = fixture()
    for name in f["ref"]["feats"]:
        np.testing.assert_array_equal(f["port"]["feats"][name],
                                      f["ref"]["feats"][name])
    for k in ("X", "yp", "yt", "groups"):
        np.testing.assert_array_equal(f["port"][k], f["ref"][k])


def _job_tuple(j):
    return (j.job_id, j.name, j.arrival, j.deadline)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_workload_exact(seed):
    f = fixture()
    r = R.make_workload(f["ref"]["apps"], f["ref"]["tb"], seed=seed)
    p = P.make_workload(f["port"]["apps"], f["port"]["tb"], seed=seed)
    assert [_job_tuple(j) for j in p] == [_job_tuple(j) for j in r]


def test_stream_workload_exact():
    f = fixture()
    kw = dict(n_jobs=500, seed=4, n_devices=3)
    r = R.stream_workload(f["ref"]["apps"], f["ref"]["tb"], **kw)
    p = P.stream_workload(f["port"]["apps"], f["port"]["tb"], **kw)
    assert [_job_tuple(j) for j in p] == [_job_tuple(j) for j in r]


def test_fit_gbdt_trees_array_equal():
    f = fixture()
    for which in ("power", "time"):
        rg = getattr(f["ref"]["pred"], which).gbdt
        pg = getattr(f["port"]["pred"], which).gbdt
        assert pg.base == rg.base
        for k in ("feats", "thresholds", "leaves", "split_gain"):
            np.testing.assert_array_equal(getattr(pg, k), getattr(rg, k))
        assert pg.thresholds.dtype == pg.leaves.dtype == np.float64
        re_, pe = (getattr(f[k]["pred"], which).enc for k in ("ref", "port"))
        assert (pe.prior_, pe.cat_cols_, pe.maps_) == \
            (re_.prior_, re_.cat_cols_, re_.maps_)


def test_predictor_outputs_match():
    f = fixture()
    X = f["ref"]["X"]
    rp, pp = f["ref"]["pred"], f["port"]["pred"]
    for fn in ("predict_power", "predict_time", "predict_energy"):
        np.testing.assert_array_equal(getattr(pp, fn)(X),
                                      getattr(rp, fn)(X))


def test_linear_baselines_exact():
    f = fixture()
    X, yp, yt = (f["ref"][k] for k in ("X", "yp", "yt"))
    for model in ("lr", "ridge", "lasso"):
        r = R.EnergyTimePredictor(R.PredictorConfig(model=model)).fit(
            X, yp, yt)
        p = P.EnergyTimePredictor(P.PredictorConfig(model=model),
                                  device=CPU).fit(X, yp, yt)
        np.testing.assert_array_equal(p.predict_power(X), r.predict_power(X))


def test_split_rmse_matches():
    f = fixture()
    X, yp, yt = (f["ref"][k] for k in ("X", "yp", "yt"))
    from repro.core.predictor import split_rmse as r_split
    r = r_split(X, yp, yt, _cfg(R.PredictorConfig, RGBDTParams))
    p = P.split_rmse(X, yp, yt, _cfg(P.PredictorConfig, PGBDTParams),
                     device=CPU)
    assert r.keys() == p.keys()
    for k in r:
        np.testing.assert_allclose(p[k], r[k], rtol=1e-9)


def test_staged_rmse_equals_reference():
    """RMSE after each boosting stage (the table-3 iteration diagnostic),
    on held-out rows, bit for bit."""
    f = fixture()
    X, yp, yt = (f["ref"][k] for k in ("X", "yp", "yt"))
    for which, y in (("power", yp), ("time", yt)):
        rt, pt = (getattr(f[k]["pred"], which) for k in ("ref", "port"))
        Xe = rt.enc.transform(X)
        np.testing.assert_array_equal(pt.enc.transform(X), Xe)
        got = pt.gbdt.staged_rmse(Xe[::3], y[::3])
        want = rt.gbdt.staged_rmse(Xe[::3], y[::3])
        assert got.shape == (pt.gbdt.feats.shape[0],)
        np.testing.assert_array_equal(got, want)


def _app_features():
    f = fixture()
    names = list(f["ref"]["feats"])
    return names, np.stack([f["ref"]["feats"][n] for n in names])


@pytest.mark.parametrize("k", [2, 3, 5])
def test_kmeans_matches(k):
    _, F = _app_features()
    r = RKMeans(k=k, random_state=0).fit(F)
    p = PKMeans(k=k, random_state=0, device=CPU).fit(F)
    np.testing.assert_array_equal(p.labels_, r.labels_)
    assert p.centers_.dtype == np.float32
    np.testing.assert_allclose(p.centers_, r.centers_, rtol=F32_TOL,
                               atol=F32_TOL)
    np.testing.assert_allclose(p.sse_, r.sse_, rtol=F32_TOL)
    np.testing.assert_array_equal(p.predict(F), r.predict(F))


def test_choose_k_elbow_matches():
    _, F = _app_features()
    assert choose_k_elbow(F, device=CPU) == r_elbow(F)


@pytest.mark.parametrize("k", [5, None])
def test_correlation_table_matches(k):
    names, F = _app_features()
    r = R.CorrelationIndex(k=k).fit(names, F)
    p = P.CorrelationIndex(k=k, device=CPU).fit(names, F)
    assert [(a, int(lab), c) for a, lab, c in p.table()] == \
        [(a, int(lab), c) for a, lab, c in r.table()]


def _services(corr: bool = False):
    f = fixture()
    kw = {}
    if corr:
        names, F = _app_features()
        kw_r = dict(corr_index=R.CorrelationIndex().fit(names, F),
                    corr_features=f["ref"]["feats"])
        kw_p = dict(corr_index=P.CorrelationIndex(device=CPU).fit(names, F),
                    corr_features=f["port"]["feats"])
    else:
        kw_r = kw_p = kw
    r = R.PredictionService(f["ref"]["tb"].dvfs, f["ref"]["pred"],
                            f["ref"]["feats"], testbed=f["ref"]["tb"],
                            use_kernel=False, **kw_r)
    p = P.PredictionService(f["port"]["tb"].dvfs, f["port"]["pred"],
                            f["port"]["feats"], testbed=f["port"]["tb"],
                            device=CPU, **kw_p)
    return r, p


def _assert_tables_close(tp, tr):
    assert [c.key() for c in tp.clocks] == [c.key() for c in tr.clocks]
    np.testing.assert_array_equal(tp.P, tr.P)
    np.testing.assert_array_equal(tp.T, tr.T)


@pytest.mark.parametrize("cls", [None, "v5p", "v5lite"])
@pytest.mark.parametrize("corr", [False, True])
def test_service_tables_lazy_and_prefetched(cls, corr):
    rs, ps = _services(corr)
    rc = None if cls is None else R.DEVICE_CLASSES[cls]
    pc = None if cls is None else P.DEVICE_CLASSES[cls]
    names = [a.name for a in R_APPS]
    lazy = {n: ps.table(n, pc) for n in names}
    _, pre = _services(corr)
    assert pre.prefetch_tables(names, (pc,)) == len({
        pre.resolve(n)[0] for n in names})
    for n in names:
        want = rs.table(n, rc)
        _assert_tables_close(lazy[n], want)
        _assert_tables_close(pre.table(n, pc), want)
        np.testing.assert_array_equal(pre.table(n, pc).P, lazy[n].P)
        assert ps.t_min(n, pc) == rs.t_min(n, rc)
        assert ps.t_dc(n, pc) == rs.t_dc(n, rc)
        tt_p, tt_r = ps.truth_table(P_APPS[0], pc), rs.truth_table(
            R_APPS[0], rc)
        np.testing.assert_array_equal(tt_p.P, tt_r.P)
        np.testing.assert_array_equal(tt_p.T, tt_r.T)
    assert ps.stats.kernel_batches == 0          # CPU: the plain version


@pytest.mark.parametrize("cls", [None, "v5p"])
def test_power_at_equals_reference(cls):
    """The power-cap view: the full ladder, and a clock subset in another
    order, read from the cached table with no predictor call."""
    rs, ps = _services()
    rc = None if cls is None else R.DEVICE_CLASSES[cls]
    pc = None if cls is None else P.DEVICE_CLASSES[cls]
    for n in ("GEMM", "SYRK"):
        np.testing.assert_array_equal(ps.power_at(n, pc), rs.power_at(n, rc))
        builds = ps.stats.table_builds
        r_clocks = rs.clocks_for(rs.register_class(rc))[::-3]
        p_clocks = ps.clocks_for(ps.register_class(pc))[::-3]
        assert [c.key() for c in p_clocks] == [c.key() for c in r_clocks]
        np.testing.assert_array_equal(ps.power_at(n, pc, p_clocks),
                                      rs.power_at(n, rc, r_clocks))
        assert ps.stats.table_builds == builds


def test_service_refuses_unported_tiers_and_unknown_apps():
    _, ps = _services()
    with pytest.raises(P.UnknownAppError, match="nearest profiled app"):
        ps.table("GEMN")
    # a cold-start tier covers only the apps registered with it
    ps.attach_synthesizer(P.ColdStartSynthesizer())
    with pytest.raises(P.UnknownAppError, match="nearest profiled app"):
        ps.table("GEMN")


def test_weight_carry_reproduces_reference_predictor():
    f = fixture()
    rp = f["ref"]["pred"]
    arrays = predictor_arrays(rp)
    pp = predictor_from_arrays(arrays, device=CPU)
    X = f["ref"]["X"]
    for fn in ("predict_power", "predict_time"):
        np.testing.assert_array_equal(getattr(pp, fn)(X),
                                      getattr(rp, fn)(X))
    again = predictor_arrays(pp)          # round trip through the port
    for which in ("power", "time"):
        for k in ("feats", "thresholds", "leaves", "split_gain"):
            np.testing.assert_array_equal(again[which][k], arrays[which][k])
    assert again["config"] == arrays["config"]
