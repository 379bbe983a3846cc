"""The port's GBDT kernel wrapper against the reference, on the CPU.

On CPU tensors ``repro_torch.kernels.ops.gbdt_predict`` runs the kernel's
plain PyTorch version (fp64, trees summed in numpy's pairwise order). It
is held

* to the reference Pallas kernel (``repro.kernels.ops.gbdt_predict``, run
  in interpret mode here as ``tests/test_kernels.py`` runs it) and to its
  jnp oracle at rtol/atol 1e-4 — the reference casts to float32;
* to the reference's numpy ``GBDTModel.predict`` bit for bit — both are
  fp64 and the plain version sums the trees in numpy's pairwise order
  (``ref.pairwise_program``), so no tolerance is needed.

The CUDA kernel itself only runs on a card: ``tests/test_torch_cuda.py``
holds it to the plain version there.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # not installed in this container — deterministic shim
    from _hypothesis_fallback import given, settings, strategies as st

from repro.core.gbdt import GBDTParams as RefParams, fit_gbdt as ref_fit
from repro.kernels import ops as jax_ops, ref as jax_ref
from repro_torch.core.gbdt import GBDTParams, fit_gbdt
from repro_torch.kernels import gbdt_predict as gp, ops, ref

REF_TOL = dict(rtol=1e-4, atol=1e-4)       # the reference computes in fp32
F64_RTOL = 1e-12                           # fp64, summation grouping only


def _ensemble(seed, n, T, depth, F):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, F)), rng.integers(0, F, size=(T, depth)),
            rng.normal(size=(T, depth)), rng.normal(size=(T, 2 ** depth)))


def _port(X, feats, thr, leaves, base=0.0, device="cpu"):
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
         for a in (X, feats.astype(np.int32), thr, leaves)]
    return ops.gbdt_predict(*t, base=base).cpu().numpy()


def _numpy_model(X, feats, thr, leaves, base):
    """The reference's numpy GBDTModel.predict on the same ensemble."""
    from repro.core.gbdt import GBDTModel
    m = GBDTModel(base=base, feats=feats.astype(np.int32), thresholds=thr,
                  leaves=leaves, split_gain=np.zeros(X.shape[1]),
                  params=RefParams())
    return m.predict(X)


@pytest.mark.parametrize("n,T,depth,F", [
    (17, 9, 2, 5),      # ragged everything
    (64, 64, 4, 23),    # production-ish (23 = DVFS feature count)
    (8, 130, 6, 8),     # deep trees, many trees
])
def test_shape_sweep_against_reference(n, T, depth, F):
    X, feats, thr, leaves = _ensemble(42, n, T, depth, F)
    got = _port(X, feats, thr, leaves, base=1.5)
    pallas = np.asarray(jax_ops.gbdt_predict(X, feats, thr, leaves,
                                             base=1.5))
    oracle = np.asarray(jax_ref.gbdt_predict_ref(
        jnp.asarray(X), jnp.asarray(feats), jnp.asarray(thr),
        jnp.asarray(leaves), base=1.5))
    np.testing.assert_allclose(got, pallas, **REF_TOL)
    np.testing.assert_allclose(got, oracle, **REF_TOL)
    np.testing.assert_array_equal(got, _numpy_model(X, feats, thr, leaves,
                                                    1.5))


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 10_000))
def test_property_random(seed):
    X, feats, thr, leaves = _ensemble(seed, 13, 7, 3, 6)
    got = _port(X, feats, thr, leaves)
    oracle = np.asarray(jax_ref.gbdt_predict_ref(
        jnp.asarray(X), jnp.asarray(feats), jnp.asarray(thr),
        jnp.asarray(leaves)))
    np.testing.assert_allclose(got, oracle, **REF_TOL)
    np.testing.assert_array_equal(got, _numpy_model(X, feats, thr, leaves,
                                                    0.0))


@pytest.mark.parametrize("T", [1, 7, 8, 9, 64, 127, 128, 129, 200, 256, 400,
                               1000, 2049])
def test_summation_order_is_numpys(T):
    rng = np.random.default_rng(T)
    c = rng.normal(size=(5, T)) * 10.0 ** rng.uniform(-6, 6, size=(5, T))
    got = (0.0 + ref._pairwise_rows(torch.from_numpy(c))).numpy()
    np.testing.assert_array_equal(got, c.sum(axis=1))
    assert sum(op for op in ref.pairwise_program(T)) == T


def test_wrapper_is_the_plain_version_on_cpu():
    X, feats, thr, leaves = _ensemble(3, 50, 40, 5, 23)
    t = [torch.from_numpy(a) for a in (X, feats.astype(np.int32), thr,
                                       leaves)]
    assert torch.equal(ops.gbdt_predict(*t, base=0.25),
                       ref.gbdt_predict_ref(*t, base=0.25))


def test_matches_numpy_model_predict_trained():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 10))
    y = np.sin(X[:, 0]) + X[:, 1] * X[:, 2]
    m_ref = ref_fit(X, y, RefParams(iterations=120, depth=4))
    m = fit_gbdt(X, y, GBDTParams(iterations=120, depth=4), device="cpu")
    np.testing.assert_array_equal(ops.gbdt_predict_model(m, X),
                                  m_ref.predict(X))
    np.testing.assert_array_equal(m.predict(X), m_ref.predict(X))


def test_inf_padded_trees_change_nothing():
    X, feats, thr, leaves = _ensemble(5, 33, 10, 4, 7)
    pad = 6
    feats_p = np.concatenate([feats, np.zeros((pad, 4), feats.dtype)])
    thr_p = np.concatenate([thr, np.full((pad, 4), np.inf)])
    leaves_p = np.concatenate([leaves, np.zeros((pad, 16))])
    padded = _port(X, feats_p, thr_p, leaves_p, base=0.5)
    # zero leaves add nothing; only the summation grouping moves
    np.testing.assert_allclose(padded, _port(X, feats, thr, leaves,
                                             base=0.5), rtol=F64_RTOL)
    np.testing.assert_array_equal(
        padded, _numpy_model(X, feats_p, thr_p, leaves_p, 0.5))


def test_empty_ensemble_and_empty_batch():
    X, feats, thr, leaves = _ensemble(6, 4, 0, 3, 5)
    np.testing.assert_array_equal(_port(X, feats, thr, leaves, base=2.0),
                                  np.full(4, 2.0))
    X, feats, thr, leaves = _ensemble(6, 0, 5, 3, 5)
    assert _port(X, feats, thr, leaves).shape == (0,)


def _good():
    X, feats, thr, leaves = _ensemble(7, 6, 4, 3, 5)
    return dict(X=torch.from_numpy(X),
                feats=torch.from_numpy(feats.astype(np.int32)),
                thresholds=torch.from_numpy(thr),
                leaves=torch.from_numpy(leaves))


@pytest.mark.parametrize("change,err,match", [
    (lambda a: a.update(X=a["X"].float()), TypeError, "X must be"),
    (lambda a: a.update(feats=a["feats"].long()), TypeError, "feats must"),
    (lambda a: a.update(thresholds=a["thresholds"].float()), TypeError,
     "thresholds must"),
    (lambda a: a.update(leaves=a["leaves"].numpy()), TypeError,
     "leaves must be a torch.Tensor"),
    (lambda a: a.update(X=a["X"][:, None]), ValueError, "2-D"),
    (lambda a: a.update(X=torch.zeros(5, 6, dtype=torch.float64).T),
     ValueError, "contiguous"),
    (lambda a: a.update(leaves=a["leaves"].to("meta")), ValueError,
     "is on meta"),
    (lambda a: a.update(X=a["X"].to("meta")), ValueError,
     "unsupported device"),
    (lambda a: a.update(thresholds=a["thresholds"][:3]), ValueError,
     "thresholds shape"),
    (lambda a: a.update(leaves=a["leaves"][:, :4].contiguous()), ValueError,
     "leaves shape"),
    (lambda a: a.update(feats=torch.zeros(4, 9, dtype=torch.int32),
                        thresholds=torch.zeros(4, 9, dtype=torch.float64),
                        leaves=torch.zeros(4, 512, dtype=torch.float64)),
     ValueError, "exceeds the kernel's maximum of 8"),
], ids=["X-dtype", "feats-dtype", "thresholds-dtype", "not-a-tensor",
        "X-ndim", "X-strided", "mixed-devices", "X-device",
        "thresholds-shape", "leaves-shape", "depth-9"])
def test_wrapper_refusals(change, err, match):
    args = _good()
    change(args)
    with pytest.raises(err, match=match):
        ops.gbdt_predict(**args)


def test_model_rejects_out_of_range_features():
    from repro_torch.core.gbdt import GBDTModel
    with pytest.raises(ValueError, match="feature indices"):
        GBDTModel(base=0.0, feats=np.full((2, 1), 3, np.int32),
                  thresholds=np.zeros((2, 1)), leaves=np.zeros((2, 2)),
                  split_gain=np.zeros(3), params=GBDTParams(), device="cpu")


def test_cpu_never_launches_the_kernel():
    before = gp.launches
    X, feats, thr, leaves = _ensemble(8, 20, 30, 4, 9)
    _port(X, feats, thr, leaves)
    m = fit_gbdt(X, X[:, 0], GBDTParams(iterations=5), device="cpu")
    m.predict(X)
    assert gp.launches == before
    if not torch.cuda.is_available():
        assert before == 0
