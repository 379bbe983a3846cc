"""Public wrappers around the port's kernels.

:func:`gbdt_predict` keeps the reference wrapper's API
(``repro/kernels/ops.py``: ``gbdt_predict(X, feats, thresholds, leaves,
base)`` and ``gbdt_predict_model(model, X)``) but takes torch tensors and
computes in fp64. It checks every argument and raises on what the kernel
does not take. A CUDA tensor launches the hand-written kernel
(:mod:`repro_torch.kernels.gbdt_predict`) or raises — there is no fallback.
A CPU tensor takes the kernel's plain version
(:func:`repro_torch.kernels.ref.gbdt_predict_ref`), which agrees with the
kernel bit for bit. Ragged ``n`` and ``T`` are handled inside the kernel:
nothing is padded here.
"""
from __future__ import annotations

import numpy as np
import torch

from . import gbdt_predict as _gp
from .ref import gbdt_predict_ref

__all__ = ["gbdt_predict", "gbdt_predict_model"]


def _check(name: str, t, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got "
                        f"{type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, X is on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def gbdt_predict(X: torch.Tensor, feats: torch.Tensor,
                 thresholds: torch.Tensor, leaves: torch.Tensor,
                 base: float = 0.0) -> torch.Tensor:
    """Oblivious-tree ensemble inference in GBDTModel layout.

    X (n, F) float64; feats (T, D) int32 with every index in ``[0, F)``;
    thresholds (T, D) float64; leaves (T, 2**D) float64; all contiguous
    and on one device, ``D <= 8``. Returns (n,) float64 on that device.
    On CUDA a feature index outside ``[0, F)`` yields NaN for the row (the
    kernel never reads out of bounds); on the CPU it raises."""
    if not isinstance(X, torch.Tensor):
        raise TypeError(f"X must be a torch.Tensor, got {type(X).__name__}")
    dev = X.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    _check("X", X, torch.float64, 2, dev)
    _check("feats", feats, torch.int32, 2, dev)
    _check("thresholds", thresholds, torch.float64, 2, dev)
    _check("leaves", leaves, torch.float64, 2, dev)
    T, depth = feats.shape
    if depth > _gp.MAX_DEPTH:
        raise ValueError(f"tree depth {depth} exceeds the kernel's maximum "
                         f"of {_gp.MAX_DEPTH}")
    if tuple(thresholds.shape) != (T, depth):
        raise ValueError(f"thresholds shape {tuple(thresholds.shape)} != "
                         f"feats shape {(T, depth)}")
    if tuple(leaves.shape) != (T, 1 << depth):
        raise ValueError(f"leaves shape {tuple(leaves.shape)} != "
                         f"{(T, 1 << depth)} for depth {depth}")
    if dev.type == "cpu":
        return gbdt_predict_ref(X, feats, thresholds, leaves, base)
    out = torch.empty(X.shape[0], dtype=torch.float64, device=dev)
    if X.shape[0] == 0:
        return out
    if X.shape[1] == 0:
        raise ValueError("X has no features")
    _gp.launch(X, feats, thresholds, leaves, float(base), out)
    return out


def gbdt_predict_model(model, X) -> np.ndarray:
    """Run a fitted :class:`repro_torch.core.gbdt.GBDTModel` over ``X``
    (numpy or tensor) on the model's device: one host→device copy, one
    launch, one copy back. Returns a float64 numpy array."""
    feats, thresholds, leaves = model.device_tables()
    if not isinstance(X, torch.Tensor):
        X = torch.from_numpy(np.ascontiguousarray(X, dtype=np.float64))
    Xt = X.to(device=feats.device, dtype=torch.float64).contiguous()
    return gbdt_predict(Xt, feats, thresholds, leaves,
                        model.base).cpu().numpy()
