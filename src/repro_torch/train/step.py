"""Training step: loss, gradient, optimizer update, microbatching.

The port of the reference's ``repro/train/step.py``. The train step is
what the DVFS scheduler dispatches as one ``<arch>:train_step`` run
(:mod:`repro_torch.core.model_apps`).

The model runs on the differentiable ``impl="xla"`` route, as the
reference's train step runs under its configs' default ``attn_impl``:
plain attention (:func:`repro_torch.models.attention._plain_gqa`) and the
plain Mamba recurrences. The attention and scan kernels have no backward
(nor have the reference's Pallas kernels), so a config that asks for
``attn_impl="flash"`` cannot train and :func:`make_train_step` refuses it.
The parameters must require grad (``model.init(..., trainable=True)`` or
``params.requires_grad_(True)``); they and the optimizer state are updated
in place.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..models import model as model_lib
from ..models.common import (FSDP, TP, P, current_mesh, mesh_axes,
                             shard_map, split_spec)
from ..optim import adamw

__all__ = ["cross_entropy", "loss_fn", "make_train_step"]

_ACCUM = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cross_entropy(logits, labels, mask: Optional[torch.Tensor] = None):
    """logits fp32 (B, S, V); labels integer (B, S); mask optional (B, S).
    The mean over (masked) positions of ``logsumexp - picked logit``. The
    reference picks the label's logit with a one-hot compare-and-sum (for
    a vocabulary sharded over tensor parallelism); a gather picks the same
    value. Under a mesh (vocab-parallel logits) both are reductions over
    the vocab shards: a max, a sum of exponentials and the one-hot sum,
    each a small all-reduce, in place of gathering the logits."""
    if current_mesh() is None:
        logz = torch.logsumexp(logits, dim=-1)
        picked = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        logz, picked = _vocab_parallel_terms(logits, labels)
    ll = picked - logz
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)


def _vocab_parallel_terms(logits, labels):
    """(logsumexp, the label's logit) of vocab-parallel logits: each rank
    reduces its vocab shard, the max is all-reduced (without gradient),
    and the sums of exponentials and of the one-hot picks are summed over
    the shards."""
    mesh = current_mesh()
    B, S, V = logits.shape
    dp = split_spec(P(("pod", FSDP)), (B,), mesh)[0]
    vspec = split_spec(P(dp, None, TP), (B, S, V), mesh)
    group = mesh.get_group(TP) if vspec[2] else None
    # a shard of ceil(V / n) columns a rank, the last shorter where n
    # does not divide V (Whisper's 51 866)
    V_chunk = -(-V // (mesh_axes(mesh)[TP] if group is not None else 1))
    v0 = mesh.get_local_rank(TP) * V_chunk if group is not None else 0

    def local(lg, lab):
        V_loc = lg.shape[-1]
        m = lg.amax(dim=-1, keepdim=True).detach()
        if group is not None:
            from torch.distributed import _functional_collectives as funcol
            m = funcol.all_reduce(m, "max", group)
        sumexp = torch.exp(lg - m).sum(dim=-1)
        vocab = torch.arange(v0, v0 + V_loc, device=lg.device)
        picked = torch.where(lab.long()[..., None] == vocab, lg,
                             0.0).sum(dim=-1)
        return sumexp, picked, m[..., 0]

    rows = P(dp, None)
    part = (TP,) if group is not None else ()
    sumexp, picked, m = shard_map(local, mesh, [vspec, rows],
                                  [rows, rows, rows],
                                  out_partial=(part, part))(logits, labels)
    return torch.log(sumexp) + m, picked


def loss_fn(params, batch: dict, cfg, aux_weight: float = 0.01,
            device=DEFAULT_DEVICE):
    """batch: dict(tokens (B, S_text), labels (B, S_text), [modality
    stubs]). Returns (loss, {"ce", "aux"}): the cross entropy plus
    ``aux_weight`` times the MoE load-balance loss. VLM: the vision
    positions carry no labels, so that prefix of the logits is dropped."""
    dev = resolve_device(device)
    extra = {k: v for k, v in batch.items() if k not in ("tokens", "labels")}
    logits, aux = model_lib.forward(cfg, params, batch["tokens"], extra,
                                    device=dev, impl="xla")
    labels = torch.as_tensor(batch["labels"], device=dev)
    logits = logits[:, -labels.shape[1]:]
    loss = cross_entropy(logits, labels)
    return loss + aux_weight * aux, {"ce": loss, "aux": aux}


def _grads_of(params, batch, cfg, dev):
    named = dict(params.named_parameters())
    frozen = sorted(n for n, p in named.items() if not p.requires_grad)
    if frozen:
        raise ValueError(
            f"{len(frozen)} parameters do not require grad (first: "
            f"{frozen[0]!r}); train a model made with model.init(..., "
            "trainable=True) or call params.requires_grad_(True)")
    loss, aux = loss_fn(params, batch, cfg, device=dev)
    grads = dict(zip(named, torch.autograd.grad(loss,
                                                list(named.values()))))
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def make_train_step(cfg, opt_cfg: adamw.AdamWConfig, microbatches: int = 1,
                    device=DEFAULT_DEVICE):
    """Build the train step ``(params, opt_state, batch) → (params,
    opt_state, metrics)``: the gradient of :func:`loss_fn`, then one AdamW
    update of ``params`` and ``opt_state`` in place (both are returned).
    ``metrics``: ``loss``, ``ce``, ``aux``, ``grad_norm`` and ``lr`` as
    fp32 scalars on the device.

    ``microbatches > 1`` splits the batch rows into that many sequential
    microbatches and accumulates their gradients in
    ``cfg.grad_accum_dtype`` before dividing by the count, as the
    reference; its ``ce`` is then the mean loss and its ``aux`` zero."""
    if cfg.attn_impl == "flash":
        raise ValueError(
            f"{cfg.name}: attn_impl='flash' cannot train; the attention and "
            "scan kernels (ops.flash_attention, ops.mamba_scan) are "
            "forward-only. Train with attn_impl='xla'")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    dev = resolve_device(device)
    accum_dt = _ACCUM[cfg.grad_accum_dtype]

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, aux, grads = _grads_of(params, batch, cfg, dev)
        else:
            B = len(batch["tokens"])
            if B % microbatches:
                raise ValueError(f"batch of {B} rows does not split into "
                                 f"{microbatches} microbatches")
            b = B // microbatches
            grads = {n: torch.zeros(p.shape, dtype=accum_dt, device=dev)
                     for n, p in params.named_parameters()}
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(microbatches):
                mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                l_i, _, g = _grads_of(params, mb, cfg, dev)
                for n, acc in grads.items():
                    acc.add_(g[n].to(accum_dt))
                loss = loss + l_i
                del g
            grads = {n: g / microbatches for n, g in grads.items()}
            loss = loss / microbatches
            aux = {"ce": loss,
                   "aux": torch.zeros((), dtype=torch.float32, device=dev)}
        metrics = adamw.update(params, grads, opt_state, opt_cfg)
        return params, opt_state, dict(metrics, loss=loss, **aux)

    return train_step
