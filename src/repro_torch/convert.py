"""Carry a fitted predictor's weights between packages as plain arrays.

:func:`predictor_arrays` reads the parameters of any fitted
``EnergyTimePredictor`` — the reference's or the port's — by attribute,
without importing either package's predictor module, into plain Python and
numpy values. :func:`predictor_from_arrays` builds the port's
:class:`~repro_torch.core.predictor.EnergyTimePredictor` from them on a
given device. Together they feed one fitted model to both packages (the
parity tests) or move a fitted model from one device to another.

Per regressor (``"power"``, ``"time"``) the arrays are the GBDT's ``base``,
``feats``, ``thresholds``, ``leaves`` and ``split_gain`` and the ordered
target encoder's ``prior_``, ``cat_cols_`` and ``maps_``; ``"config"``
holds the ``PredictorConfig`` fields, with each ``GBDTParams`` as a dict.
Only GBDT-family predictors (``catboost``, ``xgboost``) carry over.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.gbdt import GBDTModel, GBDTParams, OrderedTargetEncoder
from .core.predictor import EnergyTimePredictor, PredictorConfig
from .device import DEFAULT_DEVICE

__all__ = ["predictor_arrays", "predictor_from_arrays"]

_GBDT_FIELDS = ("gbdt", "gbdt_time")


def _regressor_arrays(target) -> dict:
    g = target.gbdt
    if g is None:
        raise ValueError("only GBDT-family predictors carry over "
                         f"(this {target.which!r} regressor has no GBDT)")
    out = {"base": float(g.base),
           "feats": np.array(g.feats, dtype=np.int32),
           "thresholds": np.array(g.thresholds, dtype=np.float64),
           "leaves": np.array(g.leaves, dtype=np.float64),
           "split_gain": np.array(g.split_gain, dtype=np.float64),
           "encoder": None}
    if target.enc is not None:
        e = target.enc
        out["encoder"] = {
            "prior_weight": float(e.prior_weight),
            "random_state": e.random_state,
            "prior_": float(e.prior_),
            "cat_cols_": tuple(int(c) for c in e.cat_cols_),
            "maps_": [{float(k): float(v) for k, v in m.items()}
                      for m in e.maps_],
        }
    return out


def predictor_arrays(predictor) -> dict:
    """Plain arrays of a fitted GBDT-family predictor (either package)."""
    cfg = predictor.cfg
    config = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)}
    for name in _GBDT_FIELDS:
        config[name] = {f.name: getattr(config[name], f.name)
                        for f in dataclasses.fields(config[name])}
    return {"config": config,
            "power": _regressor_arrays(predictor.power),
            "time": _regressor_arrays(predictor.time)}


def predictor_from_arrays(arrays: dict,
                          device: "str | torch.device" = DEFAULT_DEVICE
                          ) -> EnergyTimePredictor:
    """The port's predictor, rebuilt from :func:`predictor_arrays` output
    with its ensembles on ``device``."""
    config = dict(arrays["config"])
    for name in _GBDT_FIELDS:
        config[name] = GBDTParams(**config[name])
    cfg = PredictorConfig(**config)
    pred = EnergyTimePredictor(cfg, device=device)
    for which in ("power", "time"):
        a = arrays[which]
        target = getattr(pred, which)
        params = cfg.gbdt_time if which == "time" else cfg.gbdt
        target.gbdt = GBDTModel(
            base=a["base"], feats=a["feats"], thresholds=a["thresholds"],
            leaves=a["leaves"], split_gain=a["split_gain"], params=params,
            device=pred.device)
        enc = a["encoder"]
        if enc is not None:
            e = OrderedTargetEncoder(prior_weight=enc["prior_weight"],
                                     random_state=enc["random_state"])
            e.prior_ = enc["prior_"]
            e.cat_cols_ = tuple(enc["cat_cols_"])
            e.maps_ = [dict(m) for m in enc["maps_"]]
            target.enc = e
    return pred
