"""Mixture-of-Experts layer with capacity-based gather/scatter dispatch.

The reference's unsharded ``moe`` (its expert-parallel ``moe_sharded``
belongs to the distribution work, ROADMAP §1 item 14): routing, a stable
sort by expert id and the capacity assignment happen per batch row; each
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

from .common import dense_init, dtype_of, param
from .mlp import MLP, mlp


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


def capacity(cfg, S: int) -> int:
    """Slots per expert and batch row: ``ceil(S k cf / E)`` within
    ``[1, S k]``."""
    k = cfg.top_k
    C = int(math.ceil(S * k * cfg.capacity_factor / cfg.n_experts))
    return max(min(C, S * k), 1)


def moe(p: MoE, x, cfg):
    """x: (B, S, D) → (out (B, S, D), aux_loss fp32 scalar)."""
    B, S, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = capacity(cfg, S)
    T = S * k

    logits = x.float() @ p.router                          # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)            # (B, S, k)
    top_p = top_p / top_p.sum(dim=-1, keepdim=True)

    # ---- per-row capacity assignment (stable sort by expert id) -------- #
    flat_e = top_i.reshape(B, T)
    sorted_e, order = torch.sort(flat_e, dim=1, stable=True)
    sorted_tok = order // k                                # (B, T)
    seg_start = torch.searchsorted(sorted_e, sorted_e, side="left")
    pos_in_e = torch.arange(T, device=x.device)[None, :] - seg_start
    keep = pos_in_e < C
    spare = E * C                                          # cut off below
    dest = torch.where(keep, sorted_e * C + pos_in_e, spare)

    # ---- dispatch: each kept assignment's token into its slot ---------- #
    slot_tok = torch.full((B, E * C + 1), S, dtype=torch.long,
                          device=x.device)                 # S: a zero row
    slot_tok.scatter_(1, dest, sorted_tok)                 # kept: unique
    x_pad = torch.cat([x, x.new_zeros(B, 1, D)], dim=1)
    xe = torch.gather(x_pad, 1, slot_tok[:, :E * C, None].expand(-1, -1, D))
    xe = xe.reshape(B, E, C, D).transpose(0, 1).reshape(E, B * C, D)

    # ---- expert FFN over the slots (active FLOPs only) ------------------ #
    g = torch.bmm(xe, p.w_gate.to(x.dtype))
    u = torch.bmm(xe, p.w_up.to(x.dtype))
    ye = torch.bmm(F.silu(g) * u, p.w_down.to(x.dtype))    # (E, B*C, D)
    ye = ye.reshape(E, B, C, D).transpose(0, 1).reshape(B, E * C, D)

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

    if p.shared is not None:
        out = out + mlp(p.shared, x)

    # ---- Switch-style load-balance aux loss ------------------------------ #
    me = probs.mean(dim=(0, 1))                            # (E,)
    ce = F.one_hot(top_i[..., 0], E).float().mean(dim=(0, 1))
    aux = E * (me * ce).sum()
    return out, aux
