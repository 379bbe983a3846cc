"""AdamW with int8 blockwise first-moment storage.

The port of the reference's ``repro/optim/adamw.py``. ``state_dtype="int8"``
stores the first moment ``m`` as int8 with one absmax scale per block of
128 elements along the last axis, and the second moment ``v`` as bfloat16:
about 3 bytes a parameter for (m, v) instead of 8. ``m`` is zero-mean and
takes linear int8 quantization; ``v`` spans many orders of magnitude, and
bf16's 8 exponent bits keep its relative error uniform. A tensor whose last
axis is not a multiple of 128 (norms, biases, odd widths) keeps fp32 state.
The re-quantization error feeds into the next step, as in 8-bit Adam.

Parameters are the model's ``nn.Module`` (or a dict of tensors by name) and
are updated in place under ``torch.no_grad()``. The state is keyed by
parameter name and is updated in place too, so a checkpoint restored into
it (:func:`repro_torch.ckpt.checkpoint.restore_into`) is the live state.
``lr``, the bias corrections and every update run in fp32 as the
reference's do, so the same grads give the same update. The reference
scans its stacked layer leaves slice by slice to bound the fp32
temporaries; the port's layers are separate parameters already, and
quantization blocks run along the last axis, so ``q`` and ``scale`` equal
the reference's slice for slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Union

import torch
from torch import nn

from ..models.common import P

__all__ = ["AdamWConfig", "AdamWState", "BLOCK", "QuantState", "init",
           "lr_at", "global_norm", "quantizable", "state_specs", "update"]

BLOCK = 128


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"       # float32 | int8
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


# ---------------------------------------------------------------------- #
#  int8 blockwise quantization (last-axis blocks, shape-preserving)
# ---------------------------------------------------------------------- #
class QuantState(NamedTuple):
    q: torch.Tensor       # int8, the param's shape
    scale: torch.Tensor   # fp32, shape (..., last_dim // BLOCK)


def quantizable(shape) -> bool:
    return len(shape) >= 1 and shape[-1] % BLOCK == 0 and shape[-1] >= BLOCK


def _whole_blocks(x: torch.Tensor) -> torch.Tensor:
    """``x``, with its last dim gathered over the mesh axes that split it
    where a shard would not hold whole 128-blocks (a DTensor only; e.g.
    Kimi-K2's d_model 7168 = 56 blocks over 16 ``data`` ranks). The
    reference's spec leaves such a scale unsharded there too."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    last = x.dim() - 1
    on_last = [i for i, p in enumerate(x.placements)
               if isinstance(p, Shard) and p.dim == last]
    n = 1
    for i in on_last:
        n *= x.device_mesh.size(i)
    if (x.shape[-1] // BLOCK) % n == 0:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if i in on_last else p
        for i, p in enumerate(x.placements)])


def _quantize(x: torch.Tensor) -> QuantState:
    x = _whole_blocks(x)
    nb = x.shape[-1] // BLOCK
    blocks = x.reshape(*x.shape[:-1], nb, BLOCK)
    scale = blocks.abs().amax(dim=-1) / 127.0                 # (..., nb)
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale[..., None]), -127, 127)
    return QuantState(q=q.reshape(x.shape).to(torch.int8),
                      scale=scale.float())


def _dequantize(s: QuantState) -> torch.Tensor:
    shape = s.q.shape
    nb = shape[-1] // BLOCK
    blocks = _whole_blocks(s.q).reshape(*shape[:-1], nb, BLOCK).float()
    return (blocks * s.scale[..., None]).reshape(shape)


def _encode(x: torch.Tensor, dtype: str, which: str = "m"):
    if dtype == "int8" and quantizable(x.shape):
        if which == "m":
            return _quantize(x)
        return x.to(torch.bfloat16)    # v: exponent format, see the docstring
    return x.float()


def _decode(s) -> torch.Tensor:
    if isinstance(s, QuantState):
        return _dequantize(s)
    return s.float()


def _laid_out_as(g, p):
    """``g`` in the layout of its parameter ``p``. Under a mesh a
    gradient may come as a partial sum over some axes; it is reduced
    once here (an all-reduce, or a reduce-scatter onto ``p``'s shards),
    not again at each use in the update."""
    from torch.distributed.tensor import DTensor
    if isinstance(g, DTensor) and isinstance(p, DTensor) and \
            tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _assign(dst, src) -> None:
    """Write a new state value into the live one, in place."""
    if isinstance(dst, QuantState):
        dst.q.copy_(src.q)
        dst.scale.copy_(src.scale)
    else:
        dst.copy_(src)


# ---------------------------------------------------------------------- #
class AdamWState(NamedTuple):
    step: torch.Tensor                 # int32 scalar on the params' device
    m: dict                            # name -> fp32 tensor | QuantState
    v: dict                            # name -> fp32 | bf16 tensor


Params = Union[nn.Module, dict]


def _named(params: Params) -> dict:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def init(params: Params, cfg: AdamWConfig) -> AdamWState:
    """Zero moments for every parameter, on its device."""
    named = _named(params)
    if not named:
        raise ValueError("no parameters to optimize")
    dev = next(iter(named.values())).device

    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m={n: _encode(zeros(p), cfg.state_dtype, "m")
           for n, p in named.items()},
        v={n: _encode(zeros(p), cfg.state_dtype, "v")
           for n, p in named.items()})


def state_specs(param_specs: dict, param_shapes: dict,
                cfg: AdamWConfig) -> AdamWState:
    """The state's spec tree mirroring the parameters' (both keyed by
    parameter name): an int8 ``QuantState`` takes the parameter's spec on
    ``q`` and on ``scale`` alike, as the reference's; the dry run's
    ``sanitize_spec`` then drops what does not divide ``scale``'s last
    dim."""
    def one_m(name):
        spec = param_specs[name]
        if cfg.state_dtype == "int8" and quantizable(
                tuple(param_shapes[name])):
            return QuantState(q=spec, scale=spec)
        return spec
    return AdamWState(step=P(), m={n: one_m(n) for n in param_specs},
                      v=dict(param_specs))


def lr_at(step, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; fp32, in the
    reference's order of operations."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp_max(step.float() / float(max(cfg.warmup_steps, 1)),
                           1.0)
    prog = torch.clamp((step - cfg.warmup_steps).float()
                       / float(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(grads: dict) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares."""
    leaves = [torch.sum(torch.square(g.float())) for g in grads.values()]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


@torch.no_grad()
def update(params: Params, grads: dict, state: AdamWState,
           cfg: AdamWConfig) -> dict:
    """One AdamW step: ``params`` and ``state`` are updated in place.
    ``grads`` maps each parameter name to its gradient (any float dtype).
    Returns the metrics ``{"grad_norm", "lr"}`` as fp32 scalars on the
    device."""
    named = _named(params)
    if set(grads) != set(named):
        raise KeyError(f"grads and params differ: "
                       f"{sorted(set(grads) ^ set(named))}")
    grads = {n: _laid_out_as(grads[n], p) for n, p in named.items()}
    state.step.add_(1)
    step_f = state.step.float()
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.grad_clip / (gnorm + 1e-12), 1.0)
    lr = lr_at(state.step, cfg)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=step_f.device), step_f)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=step_f.device), step_f)
    for name, p in named.items():
        g = grads[name].float() * scale
        m = cfg.b1 * _decode(state.m[name]) + (1 - cfg.b1) * g
        v = cfg.b2 * _decode(state.v[name]) + (1 - cfg.b2) * g * g
        mh = m / b1c
        vh = v / b2c
        pf = p.float()
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * pf
        p.copy_((pf - lr * delta).to(p.dtype))
        _assign(state.m[name], _encode(m, cfg.state_dtype, "m"))
        _assign(state.v[name], _encode(v, cfg.state_dtype, "v"))
    return {"grad_norm": gnorm, "lr": lr}
