"""Carry weights between packages (and devices) as plain arrays.

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

:func:`model_from_arrays` builds the port's model module from the
reference's parameter tree as numpy arrays (nested dicts, the repeated
layers stacked on a leading axis, any float dtype, cast to
``cfg.param_dtype``); :func:`model_arrays` is its inverse and returns fp32
arrays (numpy has no bf16; the cast is exact). Both packages keep a
projection as ``(in, out)``, so every leaf is a plain copy: the tree path
``layers/attn/wq`` of layer 3 is the parameter ``layers.3.attn.wq``. Every
stacked subtree — ``layers``, and by family ``dense_layers``,
``enc_layers`` and ``dec_layers`` — is unstacked the same way.

:func:`opt_state_from_arrays` does the same for the reference's optimizer
state (``AdamWState(step, m, v)`` as numpy, ``QuantState`` leaves of an
int8 state included), giving the port's :class:`~repro_torch.optim.adamw.
AdamWState`, keyed by parameter name, so a reference run continues in the
port; :func:`opt_state_arrays` is its inverse.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.gbdt import GBDTModel, GBDTParams, OrderedTargetEncoder
from .core.predictor import EnergyTimePredictor, PredictorConfig
from .device import DEFAULT_DEVICE, resolve_device
from .models import model as model_lib
from .optim import adamw

__all__ = ["model_arrays", "model_from_arrays", "opt_state_arrays",
           "opt_state_from_arrays", "predictor_arrays",
           "predictor_from_arrays"]

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


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            yield from _flatten(val, path + ".")
        else:
            yield path, val


def _stacks(module) -> dict:
    """The module's stacked layer lists (``nn.ModuleList`` attributes) by
    name."""
    return {name: child for name, child in module.named_children()
            if isinstance(child, torch.nn.ModuleList)}


def _tensor(arr) -> torch.Tensor:
    """A numpy array as a tensor; a bfloat16 (ml_dtypes) array keeps its
    bits."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.tensor(arr)


def _unstacked(tree, depth: dict):
    """(parameter name, leaf) for every leaf of a reference-layout tree,
    each stacked subtree's leaves split into one per layer."""
    for path, arr in _flatten(tree):
        stack, _, rest = path.partition(".")
        if stack not in depth:
            yield path, arr
            continue
        n = len(arr.q if isinstance(arr, tuple) else arr)
        if n != depth[stack]:
            raise ValueError(f"{path}: {n} stacked layers, the model has "
                             f"{depth[stack]} in {stack}")
        for i in range(n):
            leaf = (type(arr)(*(a[i] for a in arr))
                    if isinstance(arr, tuple) else arr[i])
            yield f"{stack}.{i}.{rest}", leaf


@torch.no_grad()
def model_from_arrays(cfg, arrays: dict, device=DEFAULT_DEVICE):
    """The port's model for ``cfg`` on ``device``, with every parameter
    copied from ``arrays`` (the reference's parameter tree as numpy)."""
    dev = resolve_device(device)
    module = model_lib._family_module(cfg).LM(cfg, dev)
    params = dict(module.named_parameters())
    depth = {name: len(stack) for name, stack in _stacks(module).items()}
    filled = set()

    def put(name, arr):
        if name not in params:
            raise KeyError(f"no parameter {name!r} in the {cfg.family} model")
        p = params[name]
        t = _tensor(arr)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: array shape {tuple(t.shape)} != "
                             f"parameter shape {tuple(p.shape)}")
        p.copy_(t.to(device=dev, dtype=p.dtype))
        filled.add(name)

    for name, arr in _unstacked(arrays, depth):
        put(name, arr)
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"arrays give no value for {missing}")
    return module


def _stacked(named: dict, stacks) -> dict:
    """The reference's tree of ``named`` values (arrays, or tuples of
    arrays such as ``QuantState``) by parameter name: nested dicts, each
    stacked subtree's layers stacked on a leading axis."""
    tree: dict = {}
    for name, val in named.items():
        parts = name.split(".")
        if parts[0] in stacks:
            node = tree.setdefault(parts[0], {})
            for key in parts[2:-1]:
                node = node.setdefault(key, {})
            node.setdefault(parts[-1], []).append(val)
        else:
            node = tree
            for key in parts[:-1]:
                node = node.setdefault(key, {})
            node[parts[-1]] = val

    def stack(v):
        if isinstance(v, dict):
            return {k: stack(x) for k, x in v.items()}
        if not isinstance(v, list):
            return v
        if isinstance(v[0], tuple):
            return type(v[0])(*(np.stack(a) for a in zip(*v)))
        return np.stack(v)
    return stack(tree)


def model_arrays(module) -> dict:
    """The parameter tree of a port model as fp32 numpy arrays, each
    stacked subtree's layers stacked on a leading axis (the reference's
    layout)."""
    return _stacked({name: p.detach().float().cpu().numpy()
                     for name, p in module.named_parameters()},
                    _stacks(module))


def _field(state, name):
    return state[name] if isinstance(state, dict) else getattr(state, name)


def opt_state_from_arrays(module, state, device=None) -> adamw.AdamWState:
    """The port's optimizer state for ``module`` (its parameters' names and
    shapes; on the module's device unless ``device``) from the reference's
    ``AdamWState`` with numpy leaves (``jax.tree.map(np.asarray,
    state)``), or a dict with its ``step``, ``m`` and ``v``. ``m`` leaves
    are fp32 arrays or ``QuantState``-like ``(q, scale)`` pairs, ``v``
    leaves fp32 or bf16; every value is copied bit for bit."""
    params = dict(module.named_parameters())
    dev = (resolve_device(device) if device is not None else
           next(iter(params.values())).device)
    depth = {name: len(stack) for name, stack in _stacks(module).items()}

    def side(tree, what):
        out = {}
        for name, leaf in _unstacked(tree, depth):
            if name not in params:
                raise KeyError(f"{what}: no parameter {name!r} in the "
                               f"{module.cfg.family} model")
            shape = tuple(params[name].shape)
            if isinstance(leaf, tuple):
                q, scale = (_tensor(a).to(dev) for a in leaf)
                want = (shape, shape[:-1] + (shape[-1] // adamw.BLOCK,))
                got = (tuple(q.shape), tuple(scale.shape))
                val = adamw.QuantState(q=q, scale=scale)
            else:
                val = _tensor(leaf).to(dev)
                want, got = shape, tuple(val.shape)
            if got != want:
                raise ValueError(f"{what}.{name}: shape {got} != {want}")
            out[name] = val
        missing = sorted(set(params) - set(out))
        if missing:
            raise KeyError(f"{what} gives no value for {missing}")
        return out

    step = torch.tensor(int(np.asarray(_field(state, "step"))),
                        dtype=torch.int32, device=dev)
    return adamw.AdamWState(step=step, m=side(_field(state, "m"), "m"),
                            v=side(_field(state, "v"), "v"))


def opt_state_arrays(module, state: adamw.AdamWState) -> dict:
    """The port's optimizer state in the reference's layout: ``{"step",
    "m", "v"}`` with ``m`` and ``v`` trees like :func:`model_arrays`'s;
    ``QuantState`` leaves keep int8 ``q`` and fp32 ``scale``, bf16 leaves
    come back as fp32 (the cast is exact)."""
    def host(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    def side(values):
        return _stacked({n: type(v)(*(host(a) for a in v))
                         if isinstance(v, tuple) else host(v)
                         for n, v in values.items()}, _stacks(module))
    return {"step": np.asarray(int(state.step), dtype=np.int32),
            "m": side(state.m), "v": side(state.v)}
