"""GQA attention with RoPE, optional QKV bias, sliding window, KV cache.

Layouts, as the reference's:
  q:  (B, S, Hq, hd)    k/v: (B, S, Hkv, hd)
  KV cache (decode): k/v (B, Hkv, S_max, hd), written in place at ``pos``.

Full-sequence attention (causal self-attention, the bidirectional encoder
and cross-attention over an encoder's states) takes one of two routes,
chosen by the ``impl`` argument alone:

* ``"flash"`` (the default, and serving's route): the flash kernel
  (:func:`repro_torch.kernels.ops.flash_attention`), with the reference's
  ``attn_impl="flash"`` semantics, except that ``causal=False`` is
  honoured (the reference's flash route ignores its ``mask`` and turns a
  bidirectional encoder causal). The kernel is forward-only: an input that
  requires grad raises.
* ``"xla"`` (training's route): the reference's differentiable plain path,
  :func:`_plain_gqa` as its ``_sdpa`` with the causal (and windowed)
  (Sq, Sk) mask, no mask for the encoder (the reference's all-true mask)
  and for cross-attention, and :func:`_sdpa_chunked` for a causal
  sequence of at least 8192 positions in whole 2048-position chunks.

Single-token decode (:func:`attention_decode`) of bf16 activations over
a plain bf16 CUDA cache with no mesh launches the decode-attention kernel
(:func:`repro_torch.kernels.ops.decode_attention`), which reads the live
slots only (:func:`uses_decode_kernel`, the one place the route is
chosen); elsewhere (fp32, the CPU, a mesh) it is the plain path with the
decode mask, as in the reference.

Under a mesh the plain path runs on local shards in one of two layouts.
Key-parallel (the default, and decode's): q whole on every ``model``
rank, k and v split over ``model`` on their rows (projected on those
rows only where the KV heads do not divide ``model``, unevenly where the
rows do not: Whisper's 1500 frames), partial outputs summed.
Query-parallel, where the query heads do not divide ``model`` and the
sequence does (SmolLM-360M's 15 heads on 16): q split on its rows, k and
v gathered, nothing summed (:func:`_queries_split`).
"""
from __future__ import annotations

import torch
from torch import nn

from .. import obs
from ..kernels import ops as kops
from ..kernels.decode_attention import is_ring, live_range
from ..kernels.ref import gqa_ref as _gqa, grouped_scores
from .common import (FSDP, TP, P, apply_rope, assign, check_impl,
                     current_mesh, dense_init, dtype_of, matmul,
                     maybe_shard, param, residual, shard_map, split_spec)


class Attention(nn.Module):
    """``wq`` (Din, Hq*hd), ``wk``/``wv`` (Din, Hkv*hd), ``wo`` (Hq*hd,
    D), and with ``cfg.qkv_bias`` the biases ``bq``, ``bk``, ``bv``; the
    input width ``Din`` is ``d_in`` (Zamba2's shared block reads 2D), by
    default D."""

    def __init__(self, cfg, device, d_in=None):
        super().__init__()
        dt = dtype_of(cfg.param_dtype)
        D, hd = cfg.d_model, cfg.resolved_head_dim
        Din = d_in or D
        Hq, Hkv = cfg.n_heads, cfg.n_kv_heads
        self.wq = param((Din, Hq * hd), dt, device)
        self.wk = param((Din, Hkv * hd), dt, device)
        self.wv = param((Din, Hkv * hd), dt, device)
        self.wo = param((Hq * hd, D), dt, device)
        if cfg.qkv_bias:
            self.bq = param((Hq * hd,), dt, device)
            self.bk = param((Hkv * hd,), dt, device)
            self.bv = param((Hkv * hd,), dt, device)

    @torch.no_grad()
    def reset_parameters(self, generator):
        for name, w in self.named_parameters():
            if name.startswith("b"):
                w.zero_()
            else:
                w.copy_(dense_init(generator, w.shape, w.dtype, w.device))


def init_attention(cfg, generator, device):
    a = Attention(cfg, device)
    a.reset_parameters(generator)
    return a


def spec_attention(cfg):
    kv_tp = TP if cfg.n_kv_heads % 16 == 0 else None
    p = {"wq": P(FSDP, TP), "wk": P(FSDP, kv_tp), "wv": P(FSDP, kv_tp),
         "wo": P(TP, FSDP)}
    if cfg.qkv_bias:
        p["bq"] = P(TP)
        p["bk"] = P(kv_tp)
        p["bv"] = P(kv_tp)
    return p


def _heads(t, H: int, hd: int, seq=None):
    """(B, S, H*hd) → (B, S, H, hd). Under a mesh the projection's
    ``model`` shards are gathered first: the head count need not divide
    the ``model`` axis (15 heads on 16), and the key-parallel attention
    wants q whole on every ``model`` rank. ``seq``: the sequence's
    ``model`` split to keep or take (k and v's, :func:`_keys_split`; q's,
    :func:`_queries_split`, moved from its columns by one all-to-all)."""
    t = maybe_shard(t, P(("pod", FSDP), seq, None))
    return t.reshape(t.shape[0], t.shape[1], H, hd)


def _keys_split(p: Attention, S: int):
    """``TP`` when k and v are to be projected on each ``model`` rank's
    key rows only: under a mesh whose ``model`` axis the KV heads do not
    divide (``wk`` whole over it, 5 heads on 16), for a sequence of more
    than one row, split unevenly where ``model`` does not divide it
    (Whisper's 1500 frames, 94 rows a rank). The key-parallel attention
    reads just those rows, and the partitioner projects no more for the
    reference, whose attention constrains k and v to that split
    (SmolLM-360M train_4k: 16x the K/V products otherwise). Else
    ``None``."""
    mesh = current_mesh()
    from torch.distributed.tensor import DTensor, Replicate
    if mesh is None or TP not in mesh.mesh_dim_names or S <= 1 or \
            not isinstance(p.wk, DTensor):
        return None
    if p.wk.placements[list(mesh.mesh_dim_names).index(TP)] != Replicate():
        return None
    return split_spec(P(None, TP), (1, S), mesh)[1]


def _queries_split(cfg, S: int, impl: str):
    """``TP`` when full-sequence attention is to run query-parallel
    under a mesh: each ``model`` rank attends its own rows of queries
    over every key (k and v gathered), in place of the key-parallel
    route's partial outputs all-reduced over ``model``, which is the
    reference partitioner's choice where the query heads do not divide
    ``model`` and the sequence does (SmolLM-360M's 15 heads on 16). Not
    for the kernel's route, nor for the query-chunked one (its chunks
    slice the rows). Else ``None``."""
    mesh = current_mesh()
    if mesh is None or TP not in mesh.mesh_dim_names or S <= 1 or \
            impl == "flash":
        return None
    tp = mesh.size(list(mesh.mesh_dim_names).index(TP))
    if cfg.n_heads % tp == 0 or S % tp:
        return None
    return TP


def _project_qkv(p: Attention, x, cfg, positions, rows=None):
    """q, k, v of x; ``rows`` (:func:`_queries_split`): q's sequence
    split over ``model``."""
    with obs.span("attention.project"):
        B, S, _ = x.shape
        hd = cfg.resolved_head_dim
        seq = _keys_split(p, S)
        q = matmul(x, p.wq.to(x.dtype))
        k = matmul(x, p.wk.to(x.dtype), split_seq=seq is not None)
        v = matmul(x, p.wv.to(x.dtype), split_seq=seq is not None)
        if cfg.qkv_bias:
            q = q + p.bq.to(x.dtype)
            k = k + p.bk.to(x.dtype)
            v = v + p.bv.to(x.dtype)
        q = _heads(q, cfg.n_heads, hd, rows)
        k = _heads(k, cfg.n_kv_heads, hd, seq)
        v = _heads(v, cfg.n_kv_heads, hd, seq)
        if positions is not None:
            q = apply_rope(q, positions, cfg.rope_theta, cfg.query_scale)
            k = apply_rope(k, positions, cfg.rope_theta)
        return q, k, v


def causal_mask(Sq: int, Sk: int, window=None, offset: int = 0,
                device=None):
    """(1, Sq, Sk) boolean: query i attends key j iff j <= i + offset, and
    within the sliding window when set."""
    qi = torch.arange(Sq, device=device)[:, None] + offset
    kj = torch.arange(Sk, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m = m & (kj > qi - window)
    return m[None]


def attention(p: Attention, x, cfg, positions=None, causal: bool = True,
              impl: str = "flash"):
    """Full-sequence self-attention (prefill and training; the encoder with
    ``causal=False``), RoPE at ``positions`` (default ``0 .. S-1``, for
    the encoder too, as the reference), through the kernel or the plain
    path as ``impl`` says. Returns (out, (k, v)) with k, v in
    (B, S, Hkv, hd)."""
    check_impl(impl)
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    chunked = causal and S >= 8192 and S % 2048 == 0
    rows = None if chunked else _queries_split(cfg, S, impl)
    q, k, v = _project_qkv(p, x, cfg, positions, rows)
    with obs.span("attention.attend"):
        if impl == "flash":
            out = kops.flash_attention(q, k, v, causal=causal,
                                       window=cfg.sliding_window)
            out = out.reshape(B, S, cfg.n_heads * cfg.resolved_head_dim)
        elif chunked:
            out = _sdpa_chunked(q, k, v, cfg)
        else:
            mask = (causal_mask(S, S, cfg.sliding_window,
                                device=x.device)[0] if causal else None)
            out = _plain_gqa(q, k.transpose(1, 2), v.transpose(1, 2), mask,
                             rows)
    with obs.span("attention.out"):
        return residual(matmul(_heads_split(out, rows),
                               p.wo.to(x.dtype))), (k, v)


def _heads_split(out, rows):
    """The query-parallel route's output (rows split over ``model``) laid
    out for the row-parallel ``wo``: split on its last dim instead, one
    all-to-all over ``model``. Else ``out`` as it is."""
    if rows is None:
        return out
    return maybe_shard(out, P(("pod", FSDP), None, TP))


def _sdpa_chunked(q, k, v, cfg, chunk: int = 2048):
    """Causal attention one block of ``chunk`` queries at a time, as the
    reference's ``_sdpa_chunked``: the live scores are (B, Hq, chunk, Sk)
    in place of (B, Hq, S, Sk); the sliding window is honoured in each
    block's mask. Returns (B, S, Hq*hd)."""
    S = q.shape[1]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    outs = []
    for c0 in range(0, S, chunk):
        mask = causal_mask(chunk, S, cfg.sliding_window, offset=c0,
                           device=q.device)[0]
        outs.append(_plain_gqa(q[:, c0:c0 + chunk], kt, vt, mask))
    return torch.cat(outs, dim=1)


def _project_cross(p: Attention, x, source, cfg, rows=None):
    """q from x, k/v from ``source`` (B, Sk, D): no RoPE and no bias, as
    the reference's ``encdec._cross_attention``; under a mesh k and v on
    each ``model`` rank's rows of ``source`` (:func:`_keys_split`)."""
    hd = cfg.resolved_head_dim
    src = source.to(x.dtype)
    seq = _keys_split(p, src.shape[1])
    q = _heads(matmul(x, p.wq.to(x.dtype)), cfg.n_heads, hd, rows)
    k = _heads(matmul(src, p.wk.to(x.dtype), split_seq=seq is not None),
               cfg.n_kv_heads, hd, seq)
    v = _heads(matmul(src, p.wv.to(x.dtype), split_seq=seq is not None),
               cfg.n_kv_heads, hd, seq)
    if current_mesh() is not None:
        # their grads come back transposed; DTensor's view of a reshape's
        # grad fails on a non-contiguous shard
        k, v = _ContiguousGrad.apply(k), _ContiguousGrad.apply(v)
    return q, k, v


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def cross_attention(p: Attention, x, source, cfg, impl: str = "flash"):
    """Every query of x over every row of ``source`` (the decoder's prompt
    over the encoder's states), non-causal: the flash kernel, or with
    ``impl="xla"`` the plain path with no mask, as the reference's
    ``encdec._cross_attention``."""
    check_impl(impl)
    B, S, _ = x.shape
    rows = _queries_split(cfg, S, impl)
    q, k, v = _project_cross(p, x, source, cfg, rows)
    if impl == "flash":
        out = kops.flash_attention(q, k, v, causal=False)
        out = out.reshape(B, S, cfg.n_heads * cfg.resolved_head_dim)
    else:
        out = _plain_gqa(q, k.transpose(1, 2), v.transpose(1, 2),
                         rows=rows)
    return residual(matmul(_heads_split(out, rows), p.wo.to(x.dtype)))


def cross_attention_decode(p: Attention, x, source, cfg):
    """:func:`cross_attention` for one new token (x: (B, 1, D)), in plain
    torch (:func:`_plain_gqa`)."""
    q, k, v = _project_cross(p, x, source, cfg)
    out = _plain_gqa(q, k.transpose(1, 2), v.transpose(1, 2))
    return residual(matmul(out, p.wo.to(x.dtype)))


def _plain_gqa(q, k, v, valid=None, rows=None):
    """q (B, S, Hq, hd) over k/v (B, Hkv, Sk, hd), as the reference's
    ``_sdpa``: products of the q-dtype values summed in fp32 (its einsums
    with preferred_element_type=float32), probabilities rounded to q's
    dtype. ``valid`` masks keys: (Sk,) for every query alike, or (S, Sk)
    per query. Returns (B, S, Hq*hd) in q's dtype. Under a mesh,
    query-parallel where ``rows`` (:func:`_queries_split`) splits q's
    rows over ``model``, else key-parallel."""
    if current_mesh() is not None:
        if rows is not None:
            return _query_parallel_gqa(q, k, v, valid)
        return _key_parallel_gqa(q, k, v, valid)
    return _gqa(q, k, v, valid)


def _query_parallel_gqa(q, k, v, valid=None):
    """:func:`_plain_gqa` under a mesh with q's rows split over ``model``:
    k and v are gathered whole over ``model`` and each rank attends its
    queries over every key, the meshless arithmetic on its rows; the
    output keeps q's row split, and nothing is summed over ``model``."""
    B, S, Hq, hd = q.shape
    mesh = current_mesh()
    dp = split_spec(P(("pod", FSDP)), (B,), mesh)[0]
    whole = P(dp, None, None, None)
    args = [q, k, v]
    in_specs = [P(dp, TP, None, None), whole, whole]
    if valid is not None:
        args.append(valid)
        in_specs.append(P(TP, None) if valid.dim() == 2 else P(None))
    (out,) = shard_map(lambda *a: (_gqa(*a),), mesh, in_specs,
                       [P(dp, TP, None)],
                       out_shapes=[(B, S, Hq * hd)])(*args)
    return out


def _key_parallel_gqa(q, k, v, valid=None):
    """:func:`_plain_gqa` under a mesh, with the reference's key-sequence
    parallelism: q is whole on every ``model`` rank, k and v are sharded
    over ``model`` on the key dim (no config's kv-head count divides 16),
    and each rank runs the attention over its keys: the softmax max is
    all-reduced (a max, without gradient), and the unnormalised output and
    the denominator are summed over the key shards (all-reduces), in place
    of gathering the scores. The same function; the rounding of its last
    steps differs from the meshless path's."""
    B, S, Hq, hd = q.shape
    K = k.shape[1]
    G = Hq // K
    mesh = current_mesh()
    dp = split_spec(P(("pod", FSDP)), (B,), mesh)[0]
    rows = P(dp, None, None, None)
    keys = split_spec(P(dp, None, TP, None), tuple(k.shape), mesh)
    group = mesh.get_group(TP) if keys[2] else None

    def local(q, k, v, *mask):
        s = grouped_scores(q, k, *mask)
        m = s.amax(dim=-1, keepdim=True).detach()
        if group is not None:
            from torch.distributed import _functional_collectives as funcol
            m = funcol.all_reduce(m, "max", group)
        e = torch.exp(s - m)
        o = e.to(q.dtype).float() @ v.to(q.dtype).float()
        return o, e.sum(dim=-1, keepdim=True)

    args, in_specs = [q, k, v], [P(dp, None, None, None), keys, keys]
    if valid is not None:
        args.append(valid)
        in_specs.append(P(*([None] * (valid.dim() - 1)), keys[2]))
    part = (TP,) if group is not None else ()
    o, den = shard_map(local, mesh, in_specs, [rows, rows],
                       out_partial=(part, part))(*args)
    out = (o / den).to(q.dtype).reshape(B, K, G, S, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq * hd)


def attention_decode(p: Attention, x, cache_k, cache_v, pos, cfg):
    """Single-token decode with a KV cache.

    x: (B, 1, D); cache_k/v: (B, Hkv, S_max, hd), written in place at the
    slot of ``pos`` (the same position for every sequence). With a sliding
    window and a window-sized cache the slots form a ring. Returns
    (out (B, 1, D), cache_k, cache_v).

    ``pos`` is a Python int, or a 0-d int64 tensor on x's device: then
    the positions, the cache slot (``index_copy_``) and the attention
    read the tensor, so that a CUDA graph captured around the step
    (:func:`repro_torch.train.serve.make_serve_step`) takes each replay's
    position from it. The products, dtypes and mask are the int route's.

    The attention goes through the decode-attention kernel where
    :func:`uses_decode_kernel` says so, else through :func:`_plain_gqa`
    with :func:`decode_mask`. With an int ``pos`` this counts
    (:func:`count_positions`); with a tensor it counts nothing (reading it
    would wait for the device), and the caller counts."""
    B = x.shape[0]
    on_device = isinstance(pos, torch.Tensor)
    if on_device:
        positions = pos.view(1, 1).expand(B, 1)
    else:
        positions = torch.full((B, 1), pos, dtype=torch.int64,
                               device=x.device)
    q, k, v = _project_qkv(p, x, cfg, positions)
    S_max = cache_k.shape[2]
    write_idx = pos % S_max if is_ring(S_max, cfg.sliding_window) else pos
    with obs.span("attention.cache_write"):
        if on_device:
            idx = write_idx.view(1)
            cache_k.index_copy_(2, idx, k.transpose(1, 2).to(cache_k.dtype))
            cache_v.index_copy_(2, idx, v.transpose(1, 2).to(cache_v.dtype))
        else:
            slot = (slice(None), slice(None), write_idx)
            assign(cache_k, slot, k[:, 0].to(cache_k.dtype))
            assign(cache_v, slot, v[:, 0].to(cache_v.dtype))
    kernel = uses_decode_kernel(cache_k, q.dtype)
    if obs.on and not on_device:
        count_positions(B, S_max, pos, cfg.sliding_window, kernel=kernel)
    with obs.span("attention.attend"):
        if kernel:
            out = kops.decode_attention(q, cache_k, cache_v, pos,
                                        cfg.sliding_window)
        else:
            out = _plain_gqa(q, cache_k, cache_v,
                             decode_mask(pos, S_max, cfg.sliding_window,
                                         x.device))
    with obs.span("attention.out"):
        return residual(matmul(out, p.wo.to(x.dtype))), cache_k, cache_v


def uses_decode_kernel(cache, dtype: torch.dtype) -> bool:
    """Whether :func:`attention_decode` over ``cache`` (a layer's, or a
    stack of them) with activations of ``dtype`` launches the
    decode-attention kernel: bf16 on both (the kernel's one dtype; an
    fp32 step takes the plain path, the reference's arithmetic), and the
    cache on the card (:func:`_on_card`)."""
    return cache.dtype == dtype == torch.bfloat16 and _on_card(cache)


def _on_card(cache) -> bool:
    """A plain CUDA tensor (not a DTensor) and no mesh."""
    return (type(cache) is torch.Tensor and cache.is_cuda
            and current_mesh() is None)


def decode_mask(pos, S_max: int, window=None, device=None):
    """(S_max,) boolean: the cache slots a decode step at ``pos`` (an int
    or a 0-d tensor) attends; :func:`live_range` in a mask."""
    kj = torch.arange(S_max, device=device)
    if is_ring(S_max, window):
        # warmup, then all slots live
        return (kj <= pos) | (pos >= S_max)
    valid = kj <= pos
    if window is not None:
        valid = valid & (kj > pos - window)
    return valid


def count_positions(B: int, S_max: int, pos: int, window=None,
                    layers: int = 1, kernel: bool = False) -> None:
    """Count ``layers`` decode attentions of ``B`` sequences over ``S_max``
    cache slots at position ``pos``: ``attention.positions_attended``
    (the slots read, a sequence each: every slot on the plain path, the
    live ones through the kernel) and ``attention.positions_live`` (those
    the mask keeps, :func:`live_range`); through the kernel
    (``kernel``), ``attention.decode_kernel`` (one an attention)."""
    lo, hi = live_range(pos, S_max, window)
    live = layers * B * (hi - lo)
    obs.count("attention.positions_attended",
              live if kernel else layers * B * S_max)
    obs.count("attention.positions_live", live)
    if kernel:
        obs.count("attention.decode_kernel", layers)
