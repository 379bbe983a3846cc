"""Plain versions of the port's kernels (the allclose ground truth).

:func:`gbdt_predict_ref` is the plain PyTorch version of the CUDA GBDT
kernel: the same gathers and compares in fp64, and the same summation
order — the order numpy's pairwise sum gives the reference's
``contrib.sum(axis=1)`` (:func:`pairwise_program`). So on identical inputs
the kernel, this version and the reference's numpy ``GBDTModel.predict``
agree bit for bit. The wrapper (:func:`repro_torch.kernels.ops.
gbdt_predict`) uses this version for CPU tensors.

:func:`gbdt_predict_numpy` is the host-side alternative to a launch — the
reference's numpy ``GBDTModel.predict`` formula — kept as the baseline for
the per-row crossover measurement.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["gbdt_predict_ref", "gbdt_predict_numpy", "pairwise_program"]

#: numpy's pairwise-sum block size (``PW_BLOCKSIZE``) and unroll width.
_BLOCK, _UNROLL = 128, 8


@functools.lru_cache(maxsize=None)
def pairwise_program(T: int) -> tuple[int, ...]:
    """numpy's pairwise summation of ``T`` terms as a post-order program:
    a positive entry sums the next that-many terms as one block (plain
    running sum below 8 terms, else 8 interleaved accumulators combined as
    ``((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7))`` with the remainder added
    after), and 0 replaces the top two partial sums ``a, b`` by ``a + b``.
    Blocks hold at most 128 terms; longer runs split at ``n//2`` rounded
    down to a multiple of 8, left half first — numpy's recursion."""
    if T <= _BLOCK:
        return (T,) if T else ()
    half = T // 2
    half -= half % _UNROLL
    return pairwise_program(half) + pairwise_program(T - half) + (0,)


def _pairwise_rows(c: torch.Tensor) -> torch.Tensor:
    """Row sums of ``c`` (n, L) in numpy's pairwise order."""
    n, L = c.shape
    if L < _UNROLL:
        res = torch.zeros(n, dtype=c.dtype, device=c.device)
        for i in range(L):
            res = res + c[:, i]
        return res
    if L <= _BLOCK:
        body = L - L % _UNROLL
        r = c[:, :_UNROLL].clone()
        for i in range(_UNROLL, body, _UNROLL):
            r += c[:, i:i + _UNROLL]
        res = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + (
            (r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7]))
        for i in range(body, L):
            res = res + c[:, i]
        return res
    half = L // 2
    half -= half % _UNROLL
    return _pairwise_rows(c[:, :half]) + _pairwise_rows(c[:, half:])


def gbdt_predict_ref(X: torch.Tensor, feats: torch.Tensor,
                     thresholds: torch.Tensor, leaves: torch.Tensor,
                     base: float = 0.0) -> torch.Tensor:
    """Oblivious-tree ensemble inference in torch, fp64.

    X: (n, F); feats: (T, D) integer; thresholds: (T, D); leaves:
    (T, 2**D). Returns (n,) float64 on X's device."""
    X = X.to(torch.float64)
    depth = feats.shape[1]
    gathered = X[:, feats.long()]                            # (n, T, D)
    bits = gathered > thresholds.to(torch.float64)[None]
    w = torch.tensor([1 << d for d in range(depth)], dtype=torch.int64,
                     device=X.device)
    idx = (bits.to(torch.int64) * w).sum(dim=-1)            # (n, T)
    contrib = torch.gather(
        leaves.to(torch.float64)[None].expand(X.shape[0], -1, -1), 2,
        idx[..., None])[..., 0]                             # (n, T)
    # numpy's reduction adds its pairwise sum to an initial 0.0
    return base + (0.0 + _pairwise_rows(contrib))


def gbdt_predict_numpy(X: np.ndarray, feats: np.ndarray,
                       thresholds: np.ndarray, leaves: np.ndarray,
                       base: float = 0.0) -> np.ndarray:
    """The reference's host numpy ensemble prediction (the formula of
    ``repro.core.gbdt.GBDTModel.predict``)."""
    X = np.asarray(X, dtype=np.float64)
    depth = feats.shape[1]
    bits = X[:, feats] > thresholds[None, :, :]
    leaf_idx = bits @ (1 << np.arange(depth)).astype(np.int64)
    contrib = np.take_along_axis(
        np.broadcast_to(leaves[None], (X.shape[0],) + leaves.shape),
        leaf_idx[:, :, None], axis=2)[..., 0]
    return base + contrib.sum(axis=1)
