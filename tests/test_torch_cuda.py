"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without an NVIDIA card: a
CUDA kernel has no CPU mode. The file imports only ``torch``, ``numpy``
and ``repro_torch`` (no JAX), so it also runs where the reference is not
installed::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import gbdt_predict as gp, ops, ref

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _ensemble(seed, n, T, depth, F, device):
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(n, F)),
              rng.integers(0, F, size=(T, depth)).astype(np.int32),
              rng.normal(size=(T, depth)), rng.normal(size=(T, 2 ** depth)))
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("n,T,depth,F", [
    (17, 9, 2, 5), (64, 64, 4, 23), (8, 130, 6, 8), (768, 400, 4, 23),
    (300, 50, 8, 23), (1, 1000, 3, 23), (5, 0, 4, 23), (129, 7, 0, 3),
])
def test_kernel_equals_plain_version_bitwise(n, T, depth, F):
    dev = _card()
    args = _ensemble(9, n, T, depth, F, dev)
    before = gp.launches
    got = ops.gbdt_predict(*args, base=0.5)
    torch.cuda.synchronize()
    assert gp.launches == before + 1
    assert torch.equal(got, ref.gbdt_predict_ref(*args, base=0.5))
    cpu = ops.gbdt_predict(*[a.cpu() for a in args], base=0.5)
    assert torch.equal(got.cpu(), cpu)


def test_out_of_range_feature_poisons_the_row():
    dev = _card()
    X, feats, thr, leaves = _ensemble(1, 3, 4, 2, 5, dev)
    feats[2, 1] = 7
    got = ops.gbdt_predict(X, feats, thr, leaves)
    torch.cuda.synchronize()
    assert torch.isnan(got).all()
