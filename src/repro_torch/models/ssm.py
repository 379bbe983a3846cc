"""Mamba SSM blocks: Mamba-1 (falcon-mamba-7b) and Mamba-2 (zamba2-7b).

Mamba-1 recurrence (diagonal A, per-channel state):
    h_t = exp(dt_t ⊙ A) ⊙ h_{t-1} + (dt_t ⊙ B_t) ⊗ x_t
    y_t = C_t · h_t + D ⊙ x_t
Mamba-2 (scalar A per head, outer-product state update):
    h_t = exp(dt_t A_h) h_{t-1} + dt_t · x_t ⊗ B_t ;  y_t = h_t C_t + D_h x_t

A prompt (``state is None`` and L > 1) takes one of two routes, chosen by
the ``impl`` argument alone. ``"flash"`` (serving's route, the default)
runs a scan kernel: Mamba-1 its fp32 inputs through
:func:`repro_torch.kernels.ops.mamba_scan`, as the reference's
``attn_impl="flash"`` route does; Mamba-2 (the reference runs its plain
recurrence there) every head and group of B and C in one call of
:func:`repro_torch.kernels.ops.mamba2_scan`, x, B and C in the activation
dtype as the in-projection left them. The kernels are forward-only.
``"xla"`` (training's route) runs the plain recurrences
:func:`mamba1_scan` and :func:`mamba2_scan`, differentiable, over
rematerialised 256-step chunks as the reference's ``_chunked_scan``.
A Mamba-2 decode step (a state and one token) off a mesh runs
:func:`repro_torch.kernels.ops.mamba2_state_step`, which updates the
conv and SSM state in place: on the card K5, on the CPU its plain
version, the former step's arithmetic. Mamba-1 decode steps, and Mamba-2
ones under a mesh, run the plain recurrences; they stream their inputs in
the activation dtype, as the reference's do.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import obs
from ..kernels import ops as kops
from .common import (FSDP, TP, P, check_impl, current_mesh, dense_init,
                     dtype_of, matmul, param, residual, rms_norm, shard_map,
                     split_last, split_spec)


def _dt_rank(cfg) -> int:
    return max(cfg.d_model // 16, 1)


class Mamba1(nn.Module):
    """Parameters named as the reference's: ``in_proj``, ``conv_w``,
    ``conv_b``, ``x_proj``, ``dt_proj``, ``dt_bias``, ``A_log``, ``D``,
    ``out_proj``. ``dt_bias``, ``A_log`` and ``D`` are fp32 always."""

    def __init__(self, cfg, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        D, Di, N, K = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
        R = _dt_rank(cfg)
        f32 = torch.float32
        self.in_proj = param((D, 2 * Di), dt, device)
        self.conv_w = param((Di, K), dt, device)
        self.conv_b = param((Di,), dt, device)
        self.x_proj = param((Di, R + 2 * N), dt, device)
        self.dt_proj = param((R, Di), dt, device)
        self.dt_bias = param((Di,), f32, device)
        self.A_log = param((Di, N), f32, device)
        self.D = param((Di,), f32, device)
        self.out_proj = param((Di, D), dt, device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        for w in (self.in_proj, self.x_proj, self.dt_proj, self.out_proj):
            w.copy_(dense_init(generator, w.shape, w.dtype, w.device))
        self.conv_w.copy_(dense_init(generator, self.conv_w.shape,
                                     self.conv_w.dtype, self.conv_w.device,
                                     fan_in=self.conv_w.shape[1]))
        self.conv_b.zero_()
        Di, N = self.A_log.shape
        dev = self.A_log.device
        # dt = exp(U(log 1e-3, log 1e-1)) clipped at 1e-4, stored as the
        # inverse softplus; A = -(1..N) per channel, stored as log(1..N)
        lo, hi = math.log(1e-3), math.log(1e-1)
        r = torch.rand((Di,), generator=generator, device=dev)
        dt0 = torch.exp(lo + (hi - lo) * r).clamp_min(1e-4)
        self.dt_bias.copy_(torch.log(torch.expm1(dt0)))
        self.A_log.copy_(torch.log(torch.arange(
            1, N + 1, dtype=torch.float32, device=dev)).expand(Di, N))
        self.D.fill_(1.0)


# ---------------------------------------------------------------------- #
#  Depthwise causal conv1d
# ---------------------------------------------------------------------- #
def spec_mamba(cfg):
    if cfg.mamba_version == 1:
        return {"in_proj": P(FSDP, TP), "conv_w": P(TP, None),
                "conv_b": P(TP), "x_proj": P(TP, None),
                "dt_proj": P(None, TP), "dt_bias": P(TP),
                "A_log": P(TP, None), "D": P(TP), "out_proj": P(TP, FSDP)}
    return {"in_proj": P(FSDP, TP), "conv_w": P(TP, None), "conv_b": P(TP),
            "A_log": P(None), "dt_bias": P(None), "D": P(None),
            "norm_w": P(TP), "out_proj": P(TP, FSDP)}


def causal_conv1d(x, w, b, state=None):
    """x: (B, L, C); w: (C, K); optional state: (B, K-1, C) prior context.
    Returns (y (B, L, C), new_state (B, K-1, C))."""
    B, L, C = x.shape
    K = w.shape[1]
    # zeros laid out as x (under a mesh a DTensor's shard: a tensor of
    # the global shape would be held whole on every rank)
    if state is None:
        state = torch.zeros_like(x[:, :1]).expand(B, K - 1, C)
    xp = torch.cat([state, x], dim=1)                      # (B, L+K-1, C)
    y = torch.zeros_like(x)
    for i in range(K):  # K is small (4): unrolled shifted adds
        y = y + xp[:, i:i + L, :] * w[:, i].to(x.dtype)
    new_state = xp[:, L:, :] if K > 1 else state
    return y + b.to(x.dtype), new_state


# ---------------------------------------------------------------------- #
#  Mamba-1
# ---------------------------------------------------------------------- #
def _chunked_scan(run, h0, L: int, chunk: int = 256):
    """``run(h, lo, hi) -> (h, ys)`` over the steps ``[lo, hi)``, as the
    reference's ``_chunked_scan``: with ``L`` a multiple of ``chunk`` and
    longer than one, each chunk is rematerialised (the backward keeps only
    the ``L / chunk`` boundary states, not the state at every step, and
    recomputes inside the chunk); otherwise one plain pass."""
    if L % chunk or L <= chunk:
        return run(h0, 0, L)
    h, ys = h0, []
    for lo in range(0, L, chunk):
        h, y = checkpoint(run, h, lo, lo + chunk, use_reentrant=False)
        ys.append(y)
    return h, torch.cat(ys, dim=1)


_STAND_IN: list = []


@contextlib.contextmanager
def scan_stand_in():
    """Within the block a prompt's recurrence (:func:`mamba1_scan` or
    :func:`mamba2_scan` over more than one step, with no initial state)
    is :func:`_scan_stand_in`, not the scan. The dry run
    (:mod:`repro_torch.launch.dryrun`) sets it: it traces for costs, and
    a step loop would cost its trace minutes a layer. Its memory figures
    for the SSM families are then those of the stand-in."""
    _STAND_IN.append(True)
    try:
        yield
    finally:
        _STAND_IN.pop()


def _stand_in(u, h0) -> bool:
    return bool(_STAND_IN) and h0 is None and u.shape[1] > 1


def _scan_stand_in(u, dt, A, Bm, Cm, D):
    """The dry run's stand-in for a prompt's recurrence: outputs of the
    scan's shapes, layouts and dtypes made by a few elementwise ops that
    read every input, so the backward reaches each projection. A step
    loop would cost the trace minutes a layer; the reference's cost
    analysis counts a scan body once, and both dry runs add the
    recurrence's modelled cost
    (:func:`repro_torch.roofline.analysis.ssm_scan_correction`)."""
    bc = (Bm.float() * Cm.float()).sum(dim=-1, keepdim=True)     # (B, L, 1)
    if u.dim() == 4:                                             # Mamba-2
        y = u.float() * (dt.float() * A + D)[..., None] + bc[..., None]
        h = u[:, -1, :, :, None].float() * Bm[:, -1, None, None, :].float()
    else:
        y = u.float() * (dt.float() * A.mean(dim=-1) + D) + bc
        h = torch.exp(A)[None] * (u[:, -1, :, None].float()
                                  * Bm[:, -1, None, :].float())
    return y, h


def mamba1_scan(u, dt, A, Bm, Cm, D, h0=None):
    """Sequential selective scan (the training and decode route).

    u: (B, L, Di); dt: (B, L, Di); A: (Di, N); Bm/Cm: (B, L, N); D: (Di,);
    h0: (B, Di, N) or None. The inputs stream in u's dtype and are upcast
    per step; the state and the arithmetic are fp32 and each step's y is
    rounded to u's dtype, as the reference's. Returns (y (B, L, Di) fp32,
    h_last (B, Di, N) fp32)."""
    Bsz, L, Di = u.shape
    N = A.shape[1]
    if _stand_in(u, h0):
        return _scan_stand_in(u, dt, A, Bm, Cm, D)
    h = (torch.zeros((Bsz, Di, N), dtype=torch.float32, device=u.device)
         if h0 is None else h0)
    dt_s, B_s, C_s = (t.to(u.dtype) for t in (dt, Bm, Cm))

    def run(h, lo, hi):
        ys = []
        for t in range(lo, hi):
            u_t, dt_t, B_t, C_t = (a[:, t].float()
                                   for a in (u, dt_s, B_s, C_s))
            dA = torch.exp(dt_t[..., None] * A[None])           # (B, Di, N)
            dBu = (dt_t * u_t)[..., None] * B_t[:, None, :]     # (B, Di, N)
            h = dA * h + dBu
            ys.append(torch.einsum("bdn,bn->bd", h, C_t).to(u.dtype))
        return h, torch.stack(ys, dim=1)

    h, ys = _chunked_scan(run, h, L)
    y = ys.float() + u.float() * D[None, None, :]
    return y, h


def _unit_rms(x, eps):
    """``x`` over its last dim to unit RMS, with no weight: computed in
    fp32 and rounded back to x's dtype, as transformers' ``rms_forward``
    (FalconMamba's mixer norms), in a ``norm`` span. ``F.rms_norm``
    upcasts a bf16 input to fp32 itself and is one fused launch on the
    card; the fp32 steps spelled out take seven, and three norms a layer
    would then be a third of a prefill's launches."""
    with obs.span("norm"):
        return F.rms_norm(x, (x.shape[-1],), eps=eps)


def mamba1_block(p: Mamba1, x, cfg, state=None, impl: str = "flash"):
    """x: (B, L, D). state: None, or dict(conv, ssm) for decode; a prompt
    takes the route ``impl`` names. Returns (out, new_state), as one
    ``mamba`` span (:mod:`repro_torch.obs`) holding a ``mamba.scan``
    span around the scan.

    With ``cfg.mixer_rms_eps`` set (FalconMamba), dt's ranks, B and C
    are each normed to unit RMS (:func:`_unit_rms`) after ``x_proj``,
    before ``dt_proj`` and the scan, on every route."""
    check_impl(impl)
    with obs.span("mamba"):
        L = x.shape[1]
        Di, N = cfg.d_inner, cfg.ssm_state
        R = _dt_rank(cfg)
        xz = matmul(x, p.in_proj.to(x.dtype))
        xs, z = split_last(xz, (Di, Di))
        conv_state = state["conv"] if state is not None else None
        xs, new_conv = causal_conv1d(xs, p.conv_w, p.conv_b, conv_state)
        xs = F.silu(xs)
        proj = matmul(xs, p.x_proj.to(xs.dtype))
        dt_raw, Bm, Cm = proj[..., :R], proj[..., R:R + N], proj[..., R + N:]
        if cfg.mixer_rms_eps is not None:
            dt_raw, Bm, Cm = (_unit_rms(t, cfg.mixer_rms_eps)
                              for t in (dt_raw, Bm, Cm))
        dt = matmul(dt_raw, p.dt_proj.to(xs.dtype))
        dt = F.softplus(dt.float() + p.dt_bias[None, None, :])
        A = -torch.exp(p.A_log)
        with obs.span("mamba.scan"):
            if impl == "flash" and state is None and L > 1:
                # B and C are column slices of one projection: made
                # contiguous
                y, h_last = kops.mamba_scan(xs.float(), dt, A,
                                            Bm.float().contiguous(),
                                            Cm.float().contiguous(), p.D)
            else:
                h0 = state["ssm"] if state is not None else None
                y, h_last = mamba1_scan(xs, dt, A, Bm, Cm, p.D, h0)
        y = y.to(x.dtype) * F.silu(z)
        return (residual(matmul(y, p.out_proj.to(x.dtype))),
                {"conv": new_conv, "ssm": h_last})


# ---------------------------------------------------------------------- #
#  Mamba-2 (SSD, scalar A per head)
# ---------------------------------------------------------------------- #
class Mamba2(nn.Module):
    """Parameters named as the reference's: ``in_proj`` (D, 2Di+2GN+H:
    z, x, B and C of each of the G = ``cfg.mamba_ngroups`` groups, dt),
    ``conv_w``/``conv_b`` over the Di+2GN conv channels, ``A_log``,
    ``dt_bias``, ``D`` (one per head, fp32 always), ``norm_w`` and
    ``out_proj``."""

    def __init__(self, cfg, device):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        D, Di, K = cfg.d_model, cfg.d_inner, cfg.ssm_conv
        N = cfg.mamba_ngroups * cfg.ssm_state
        H = Di // cfg.ssm_head_dim
        if H % cfg.mamba_ngroups:
            raise ValueError(f"{H} Mamba-2 heads do not split into "
                             f"mamba_ngroups={cfg.mamba_ngroups} groups")
        f32 = torch.float32
        self.in_proj = param((D, 2 * Di + 2 * N + H), dt, device)
        self.conv_w = param((Di + 2 * N, K), dt, device)
        self.conv_b = param((Di + 2 * N,), dt, device)
        self.A_log = param((H,), f32, device)
        self.dt_bias = param((H,), f32, device)
        self.D = param((H,), f32, device)
        self.norm_w = param((Di,), dt, device)
        self.out_proj = param((Di, D), dt, device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        for w in (self.in_proj, self.out_proj):
            w.copy_(dense_init(generator, w.shape, w.dtype, w.device))
        self.conv_w.copy_(dense_init(generator, self.conv_w.shape,
                                     self.conv_w.dtype, self.conv_w.device,
                                     fan_in=self.conv_w.shape[1]))
        self.conv_b.zero_()
        H = self.A_log.shape[0]
        self.A_log.copy_(torch.log(torch.linspace(
            1.0, 16.0, H, dtype=torch.float32, device=self.A_log.device)))
        self.dt_bias.zero_()
        self.D.fill_(1.0)
        self.norm_w.fill_(1.0)


def mamba2_scan(u, dt, A, Bm, Cm, D, h0=None):
    """Sequential Mamba-2 scan (the training route, a decode step's
    under a mesh, and the reference's recurrence). u: (B, L, H, Pd); dt:
    (B, L, H); A, D: (H,); Bm/Cm: (B, L, N), or (B, L, G, N) for G
    groups (head j reads group ``j // (H / G)``); h0: (B, H, Pd, N) or
    None. The inputs stream in u's dtype and are upcast per step; each
    step's ``h·C`` is rounded to u's dtype. Returns (y (B, L, H, Pd)
    fp32, h_last (B, H, Pd, N) fp32)."""
    Bsz, L, H, Pd = u.shape
    N = Bm.shape[-1]
    if _stand_in(u, h0):
        return _scan_stand_in(u, dt, A, Bm, Cm, D)
    h = (torch.zeros((Bsz, H, Pd, N), dtype=torch.float32, device=u.device)
         if h0 is None else h0)
    dt_s, B_s, C_s = (t.to(u.dtype) for t in (dt, Bm, Cm))
    grouped = Bm.dim() == 4
    rep = H // Bm.shape[2] if grouped else 1

    def run(h, lo, hi):
        ys = []
        for t in range(lo, hi):
            u_t, dt_t, B_t, C_t = (a[:, t].float()
                                   for a in (u, dt_s, B_s, C_s))
            dA = torch.exp(dt_t * A[None])                       # (B, H)
            if grouped:
                # each head's group: (B, G, N) -> (B, H, N)
                B_t = B_t.repeat_interleave(rep, dim=1)[:, :, None]
                C_t = C_t.repeat_interleave(rep, dim=1)
                out = "bhpn,bhn->bhp"
            else:
                B_t = B_t[:, None, None, :]
                out = "bhpn,bn->bhp"
            dBu = (dt_t[..., None] * u_t)[..., None] * B_t
            h = dA[..., None, None] * h + dBu
            ys.append(torch.einsum(out, h, C_t).to(u.dtype))
        return h, torch.stack(ys, dim=1)

    h, ys = _chunked_scan(run, h, L)
    y = ys.float() + u.float() * D[None, None, :, None]
    return y, h


def uses_state_step_kernel(state) -> bool:
    """Whether a Mamba-2 decode step over ``state`` (a layer's SSM state,
    or a stack of them) launches K5 (:func:`mamba2_block`'s decode route
    on the card): a plain CUDA tensor (not a DTensor) and no mesh."""
    return (type(state) is torch.Tensor and state.is_cuda
            and current_mesh() is None)


def mamba2_block(p: Mamba2, x, cfg, state=None, impl: str = "flash"):
    """x: (B, L, D). state: None, or dict(conv, ssm) for decode (conv in
    the cache's dtype); a prompt takes the route ``impl`` names. Returns
    (out, new_state), as one ``mamba`` span (:mod:`repro_torch.obs`)
    holding a ``mamba.scan`` span around the scan.

    A decode step (a state and L == 1) off a mesh goes through
    :func:`repro_torch.kernels.ops.mamba2_state_step` (conv window, SiLU,
    dt and the recurrence in one call, K5 on the card), which writes the
    new conv and SSM state into ``state``'s tensors: ``new_state`` is
    ``state`` itself. Under a mesh a decode step runs the plain
    recurrence and returns new tensors.

    On the ``"flash"`` route a prompt goes through the Mamba-2 scan
    kernel (:func:`repro_torch.kernels.ops.mamba2_scan`), one launch for
    every head and group: dt rounded to the activation dtype (the
    reference casts it to u's dtype before its scan), one decay a head
    and step, y returned in the activation dtype. On the card each such
    scan's launch counts one ``mamba.scan_kernel`` (:mod:`repro_torch.obs`).
    One rounding differs from the reference's recurrence: it rounds each
    step's ``h·C`` to u's dtype before adding ``D⊙u``, the kernel adds
    them in fp32. At fp32 that is no difference; in bf16 it stays inside
    the output's last rounding (one ulp).

    Under a mesh whose ``model`` axis divides the heads, everything from
    the second split to the gated norm runs on each rank's heads
    (:func:`_mamba2_sharded`).

    With ``cfg.mamba_ngroups`` G > 1, B and C are (B, L, G, N): head j
    reads group ``j // (H / G)``, and the gated norm normalises each
    group's Di / G channels apart. No mesh takes G > 1."""
    check_impl(impl)
    with obs.span("mamba"):
        Di, G = cfg.d_inner, cfg.mamba_ngroups
        N = G * cfg.ssm_state
        H = Di // cfg.ssm_head_dim
        proj = matmul(x, p.in_proj.to(x.dtype))
        z, xBC, dt_raw = split_last(proj, (Di, Di + 2 * N, H))
        mesh = current_mesh()
        if state is not None and x.shape[1] == 1 and mesh is None:
            with obs.span("mamba.scan"):
                y = kops.mamba2_state_step(
                    xBC, dt_raw, p.conv_w.to(x.dtype), p.conv_b.to(x.dtype),
                    p.dt_bias, p.A_log, p.D, state["conv"], state["ssm"])
            y = _gated_norm(y, z, p.norm_w, G, cfg.norm_eps, rms_norm)
            return residual(matmul(y, p.out_proj.to(x.dtype))), state
        conv_state = (state["conv"].to(x.dtype) if state is not None
                      else None)
        xBC, new_conv = causal_conv1d(xBC, p.conv_w, p.conv_b, conv_state)
        xBC = F.silu(xBC)
        xs, Bm, Cm = split_last(xBC, (Di, N, N))
        if G > 1:
            Bm = Bm.unflatten(-1, (G, cfg.ssm_state))
            Cm = Cm.unflatten(-1, (G, cfg.ssm_state))
        h0 = state["ssm"] if state is not None else None
        if mesh is not None and G > 1:
            raise ValueError(f"mamba_ngroups={G}: no mesh takes grouped "
                             "B and C")
        if mesh is not None and TP in mesh.mesh_dim_names and \
                H % mesh.size(list(mesh.mesh_dim_names).index(TP)) == 0:
            y, h_last = _mamba2_sharded(p, xs, Bm, Cm, dt_raw, z, h0, cfg,
                                        impl, x.dtype, mesh)
        else:
            y, h_last = _mamba2_core(xs, Bm, Cm, dt_raw, z, p.dt_bias,
                                     p.A_log, p.D, p.norm_w, h0, cfg, impl,
                                     x.dtype, rms_norm)
        return (residual(matmul(y, p.out_proj.to(x.dtype))),
                {"conv": new_conv, "ssm": h_last})


def _mamba2_core(xs, Bm, Cm, dt_raw, z, dt_bias, A_log, D, norm_w, h0, cfg,
                 impl, dtype, norm):
    """The Mamba-2 block from its split projections to the gated norm, on
    plain tensors: all the heads, or a rank's heads (``xs``, ``dt_raw``,
    ``z`` and the per-head parameters cut to them; ``norm`` then sums
    over the ranks). Returns (y (B, L, Di) in ``dtype``, h_last)."""
    B, L, Di = xs.shape
    N = Bm.shape[-1]
    Pd = cfg.ssm_head_dim
    H = Di // Pd
    dt = F.softplus(dt_raw.float() + dt_bias[None, None])   # (B, L, H)
    A = -torch.exp(A_log)
    with obs.span("mamba.scan"):
        if impl == "flash" and h0 is None and L > 1:
            # the kernel reads the projection's column views as they are;
            # a mesh's local shards may come with other strides
            x, Bg, Cg = (t if t.stride(-1) == 1 else t.contiguous()
                         for t in (xs, Bm, Cm))
            if Bm.dim() == 3:
                Bg, Cg = Bg[:, :, None], Cg[:, :, None]
            y, h_last = kops.mamba2_scan(x.unflatten(-1, (H, Pd)),
                                         dt.contiguous(), A, Bg, Cg, D)
        else:
            y, h_last = mamba2_scan(xs.reshape(B, L, H, Pd), dt, A, Bm, Cm,
                                    D, h0)
    G = Bm.shape[2] if Bm.dim() == 4 else 1
    return _gated_norm(y.reshape(B, L, Di).to(dtype), z, norm_w, G,
                       cfg.norm_eps, norm), h_last


def _gated_norm(y, z, norm_w, G: int, eps, norm):
    """The mixer's gate and gated norm: ``y · silu(z)`` normed by
    ``norm``, each group's Di / G channels apart where G > 1."""
    y = y * F.silu(z)
    if G == 1:
        return norm(y, norm_w, eps)
    Di = y.shape[-1]
    return norm(y.unflatten(-1, (G, Di // G)), norm_w.view(G, Di // G),
                eps).flatten(-2)


def _mamba2_sharded(p: Mamba2, xs, Bm, Cm, dt_raw, z, h0, cfg, impl,
                    dtype, mesh):
    """:func:`_mamba2_core` under a mesh, on each ``model`` rank's heads
    (a shard of Di and of H, as the partitioner keeps them): B and C are
    gathered whole, the scan and the gate run locally, and the gated
    norm sums its squares on the local shard and all-reduces one value a
    row over ``model``. (On DTensors each of these ops' backward gathered
    its Di-split operands over ``model``: Zamba2 train_4k moved 3.3x the
    reference's collective bytes.) ``impl`` picks each rank's route as
    with no mesh: ``"flash"`` runs the scan kernel on its heads."""
    B, L = xs.shape[:2]
    Di = xs.shape[-1]
    group = mesh.get_group(TP)
    dp = split_spec(P(("pod", FSDP)), (B,), mesh)[0]
    cols, whole, heads = P(dp, None, TP), P(dp, None, None), P(TP)
    state = P(dp, TP, None, None)

    def norm(y, w, eps):
        yf = y.float()
        var = _PSum.apply((yf * yf).sum(dim=-1, keepdim=True), group) / Di
        return (yf * torch.rsqrt(var + eps) * w.float()).to(y.dtype)

    def local(xs, Bm, Cm, dt_raw, z, dt_bias, A_log, D, norm_w, *h0):
        return _mamba2_core(xs, Bm, Cm, dt_raw, z, dt_bias, A_log, D,
                            norm_w, h0[0] if h0 else None, cfg, impl,
                            dtype, norm)

    args = [xs, Bm, Cm, dt_raw, z, p.dt_bias, p.A_log, p.D, p.norm_w]
    specs = [cols, whole, whole, cols, cols, heads, heads, heads, heads]
    if h0 is not None:
        args.append(h0)
        specs.append(state)
    return shard_map(local, mesh, specs, [cols, state])(*args)


class _PSum(torch.autograd.Function):
    """An all-reduce (sum) over ``group`` whose gradient is the
    all-reduce of the gradients: the sum feeds every rank's result."""

    @staticmethod
    def forward(ctx, x, group):
        from torch.distributed import _functional_collectives as funcol
        ctx.group = group
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(g, "sum",
                                                    ctx.group)), None
