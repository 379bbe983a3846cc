"""Mixture-of-Experts layer with capacity-based gather/scatter dispatch.

The reference's ``moe`` and its expert-parallel ``moe_sharded`` (the
path under a mesh): routing, a stable sort by expert id and the capacity
assignment happen per batch row; each
expert runs its SwiGLU FFN over its ``C`` slots only; the outputs are
combined back in token order, weighted by the renormalised router
probabilities; a Switch-style load-balance loss comes back beside them.

Two points keep the port equal to the reference:

* An assignment past its expert's capacity is dropped. The reference
  points it at the expert's last slot with a zeroed value and *adds*; here
  it goes to a spare slot that is cut off, so a kept token is never
  overwritten.
* Each token's ``k`` weighted outputs are summed in ascending expert id,
  one add at a time in the activation dtype, which is the order the
  reference's scatter-add applies them. No atomics: an unordered add would
  change bf16 bits at ``k = 8``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from . import common
from .common import FSDP, TP, P, dense_init, dtype_of, param
from .mlp import MLP, mlp, spec_mlp


class MoE(nn.Module):
    """``router`` (D, E) fp32; ``w_gate``/``w_up`` (E, D, F), ``w_down``
    (E, F, D); with shared experts, ``shared`` (a SwiGLU MLP of width
    ``F * n_shared_experts``)."""

    def __init__(self, cfg, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        D, E, Fh = cfg.d_model, cfg.n_experts, cfg.resolved_moe_d_ff
        self.router = param((D, E), torch.float32, device)
        self.w_gate = param((E, D, Fh), dt, device)
        self.w_up = param((E, D, Fh), dt, device)
        self.w_down = param((E, Fh, D), dt, device)
        self.shared = (MLP(cfg, device, d_ff=Fh * cfg.n_shared_experts)
                       if cfg.n_shared_experts else None)

    @torch.no_grad()
    def reset_parameters(self, generator):
        self.router.copy_(dense_init(generator, self.router.shape,
                                     torch.float32, self.router.device))
        # the reference's fan-in: the leading dim (E) for w_gate and w_up;
        # drawn one expert at a time, so no fp32 copy of a whole stack
        E = self.w_gate.shape[0]
        for w, fan_in in ((self.w_gate, E), (self.w_up, E),
                          (self.w_down, self.w_down.shape[1])):
            for e in range(E):
                w[e].copy_(dense_init(generator, w.shape[1:], w.dtype,
                                      w.device, fan_in=fan_in))
        if self.shared is not None:
            self.shared.reset_parameters(generator)


def spec_moe(cfg):
    if cfg.n_experts % 16 == 0:  # expert-parallel
        w, wd = P(TP, FSDP, None), P(TP, None, FSDP)
    else:                        # per-expert tensor-parallel
        w, wd = P(None, FSDP, TP), P(None, TP, FSDP)
    p = {"router": P(FSDP, None), "w_gate": w, "w_up": w, "w_down": wd}
    if cfg.n_shared_experts:
        p["shared"] = spec_mlp()
    return p


def capacity(cfg, S: int) -> int:
    """Slots per expert and batch row: ``ceil(S k cf / E)`` within
    ``[1, S k]``."""
    k = cfg.top_k
    C = int(math.ceil(S * k * cfg.capacity_factor / cfg.n_experts))
    return max(min(C, S * k), 1)


def _routed(x, router, w_gate, w_up, w_down, cfg, e0: int = 0,
            E_loc: int = None):
    """The routed experts ``e0 .. e0+E_loc-1`` (default: all of them) on
    x (B, S, D): (their weighted outputs (B, S, D), router probs, top-k
    ids). An assignment to another expert, or past its expert's capacity,
    lands in the spare slot and adds an exact zero."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    E_loc = E if E_loc is None else E_loc
    C = capacity(cfg, S)
    T = S * k

    logits = x.float() @ router                            # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)            # (B, S, k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    # ---- per-row capacity assignment (stable sort by expert id) -------- #
    flat_e = top_i.reshape(B, T)
    is_local = (flat_e >= e0) & (flat_e < e0 + E_loc)
    sort_key = torch.where(is_local, flat_e - e0, E_loc)   # others last
    sorted_e, order = torch.sort(sort_key, dim=1, stable=True)
    sorted_tok = order // k                                # (B, T)
    seg_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(T, device=x.device)[None, :] - seg_start
    keep = (pos_in_e < C) & (sorted_e < E_loc)
    spare = E_loc * C                                      # cut off below
    dest = torch.where(keep, sorted_e * C + pos_in_e, spare)

    # ---- dispatch: each kept assignment's token into its slot ---------- #
    slot_tok = torch.full((B, E_loc * C + 1), S, dtype=torch.long,
                          device=x.device)                 # S: a zero row
    slot_tok.scatter_(1, dest, sorted_tok)                 # kept: unique
    x_pad = torch.cat([x, x.new_zeros(B, 1, D)], dim=1)
    xe = torch.gather(x_pad, 1,
                      slot_tok[:, :E_loc * C, None].expand(-1, -1, D))
    xe = xe.reshape(B, E_loc, C, D).transpose(0, 1).reshape(E_loc, B * C, D)

    # ---- expert FFN over the slots (active FLOPs only) ------------------ #
    g = torch.bmm(xe, w_gate.to(x.dtype))
    u = torch.bmm(xe, w_up.to(x.dtype))
    ye = torch.bmm(F.silu(g) * u, w_down.to(x.dtype))      # (E_loc, B*C, D)
    ye = ye.reshape(E_loc, B, C, D).transpose(0, 1).reshape(B, E_loc * C, D)

    # ---- combine: k weighted outputs per token, ascending expert id ----- #
    ye = torch.cat([ye, ye.new_zeros(B, 1, D)], dim=1)     # + a zero slot
    unsort = torch.argsort(order, dim=1)                   # back to (s, j)
    tok_dest = torch.gather(dest, 1, unsort).reshape(B, S, k)
    tok_keep = torch.gather(keep, 1, unsort).reshape(B, S, k)
    w = (top_p * tok_keep).to(x.dtype)                     # (B, S, k)
    by_expert = torch.argsort(top_i, dim=-1)
    tok_dest = torch.gather(tok_dest, 2, by_expert)
    w = torch.gather(w, 2, by_expert)
    out = None
    for j in range(k):
        c = torch.gather(ye, 1, tok_dest[:, :, j, None].expand(-1, -1, D))
        c = c * w[:, :, j, None]
        out = c if out is None else out + c
    return out, probs, top_i


def _aux(probs, top_i, E):
    """Switch-style load-balance loss."""
    me = probs.mean(dim=(0, 1))                            # (E,)
    ce = F.one_hot(top_i[..., 0], E).float().mean(dim=(0, 1))
    return E * (me * ce).sum()


def moe_sharded(p: MoE, x, cfg):
    """Expert-parallel MoE on the current mesh (the production path under
    a mesh), as the reference's ``shard_map`` version.

    Layout: tokens batch-sharded over (pod, data) and replicated over
    ``model``; experts sharded over ``model`` (``E_loc = E / TP`` a rank)
    when ``E`` divides, else every expert on every rank with its FFN dim
    sharded over ``model`` (Mixtral: 8 experts). Each rank

      1. routes its local tokens (router replicated),
      2. keeps the assignments to its local experts and capacity-gathers
         them,
      3. gets its experts' weights whole over ``data`` (the FSDP
         all-gather: the weights enter the local body unsharded on
         ``data``),
      4. runs the expert FFN and the shared expert's ``model`` shard,
      5. combines locally in ascending expert id (no atomics),
    and one all-reduce over ``model`` sums the partial outputs; ``aux``
    is averaged over the batch axes. When the batch does not divide the
    (pod, data) product (batch 1) it runs replicated over them. On one
    rank this is :func:`moe` bit for bit."""
    mesh = common.current_mesh()
    axes = common.mesh_axes(mesh)
    dp = ()
    for cand in (("pod", "data"), ("data",), ("pod",)):
        if all(a in axes for a in cand):
            if x.shape[0] % math.prod(axes[a] for a in cand) == 0:
                dp = cand
                break
    E = cfg.n_experts
    tp = axes[TP]
    e_sharded = E % tp == 0
    E_loc = E // tp if e_sharded else E
    e0 = mesh.get_local_rank(TP) * E_loc if e_sharded else 0

    def local(x_loc, router, wg, wu, wd, *shared_w):
        out, probs, top_i = _routed(x_loc, router, wg, wu, wd, cfg, e0,
                                    E_loc)
        if shared_w:
            sg, su, sd = shared_w  # F over model: partial after w_down
            h = F.silu(x_loc @ sg.to(x_loc.dtype)) * (x_loc @ su.to(
                x_loc.dtype))
            out = out + h @ sd.to(x_loc.dtype)
        # every model rank routes the same tokens: a 1/tp share of the
        # loss each, so its gradient is not counted once per rank
        return out, _aux(probs, top_i, E) / tp

    bspec = P(dp if dp else None, None, None)
    if e_sharded:
        w_specs = [P(TP, None, None)] * 3
    else:
        w_specs = [P(None, None, TP), P(None, None, TP), P(None, TP, None)]
    in_specs = [bspec, P(None, None)] + w_specs
    args = [x, p.router, p.w_gate, p.w_up, p.w_down]
    if p.shared is not None:
        in_specs += [P(None, TP), P(None, TP), P(TP, None)]
        args += [p.shared.w_gate, p.shared.w_up, p.shared.w_down]
    fn = common.shard_map(local, mesh, in_specs, (bspec, P()),
                          out_partial=((TP,), (TP,) + dp))
    out, aux = fn(*args)
    return out, aux / math.prod(axes[a] for a in dp)


def moe(p: MoE, x, cfg):
    """x: (B, S, D) → (out (B, S, D), aux_loss fp32 scalar). Under a mesh
    with a ``model`` axis that divides the experts or their FFN dim, the
    expert-parallel :func:`moe_sharded`."""
    axes = common.mesh_axes(common.current_mesh())
    if TP in axes and (cfg.n_experts % axes[TP] == 0
                       or cfg.resolved_moe_d_ff % axes[TP] == 0):
        return moe_sharded(p, x, cfg)
    out, probs, top_i = _routed(x, p.router, p.w_gate, p.w_up, p.w_down,
                                cfg)
    if p.shared is not None:
        out = out + mlp(p.shared, x)
    return out, _aux(probs, top_i, cfg.n_experts)
