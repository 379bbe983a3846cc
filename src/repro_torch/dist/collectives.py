"""Compressed cross-pod collectives with error feedback.

Gradient reduction over the slow pod axis is bandwidth-bound;
int8-quantizing the addends cuts bytes 4x. Plain quantization biases the
update, so the per-leaf quantization residual is carried forward (error
feedback): each round quantizes ``g + err`` and keeps the new residual
locally. The residual is bounded by half the quantization scale, so the
compressed mean converges to the exact mean over rounds.

The port of the reference's ``repro/dist/collectives.py``: the reference
psums the *dequantized* values, and so does this, with an all-reduce over
a ``torch.distributed`` process group (or one dim of a ``DeviceMesh``).
The residual is computed on the rank alone, so it equals the reference's
bit for bit.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["compressed_psum", "init_error"]


def _tree_map(fn, *trees):
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _process_group(group):
    """A process group from a group, a 1-D ``DeviceMesh``, or a
    ``(DeviceMesh, dim name)`` pair."""
    if isinstance(group, tuple):
        mesh, dim = group
        return mesh.get_group(dim)
    if hasattr(group, "get_group"):
        return group.get_group()
    return group


def _full(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=like.dtype, device=like.device)


def init_error(tree):
    """Zero-initialized error-feedback residuals matching ``tree``."""
    return _tree_map(torch.zeros_like, tree)


def compressed_psum(tree, group, err_tree):
    """Mean-reduce ``tree`` (nested dicts / lists of tensors, each rank's
    own) over ``group`` via int8 quantization. Returns ``(mean_tree,
    new_err_tree)``. Scale is per-leaf symmetric max-abs / 127."""
    pg = _process_group(group)
    n = dist.get_world_size(pg)

    def one(g, err):
        # divisors are tensors on g's device: CUDA divides by a host
        # scalar as a product with its reciprocal, which rounds otherwise
        g = g + err
        scale = g.abs().max() / _full(127.0, g) + 1e-12
        q = torch.round(g / scale).clamp_(-127, 127).to(torch.int8)
        deq = q.to(g.dtype).mul_(scale)
        new_err = g.sub_(deq)
        dist.all_reduce(deq, group=pg)
        return deq.div_(_full(float(n), g)), new_err

    done = []
    index = _tree_map(lambda g, e: done.append(one(g, e)) or len(done) - 1,
                      tree, err_tree)
    return (_tree_map(lambda i: done[i][0], index),
            _tree_map(lambda i: done[i][1], index))
