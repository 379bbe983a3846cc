"""Plain versions of the port's kernels (the allclose ground truth).

:func:`gbdt_predict_ref` is the plain PyTorch version of the CUDA GBDT
kernel: the same gathers and compares in fp64, and the same summation
order — the order numpy's pairwise sum gives the reference's
``contrib.sum(axis=1)`` (:func:`pairwise_program`). So on identical inputs
the kernel, this version and the reference's numpy ``GBDTModel.predict``
agree bit for bit. The wrapper (:func:`repro_torch.kernels.ops.
gbdt_predict`) uses this version for CPU tensors.

:func:`gbdt_predict_numpy` is the host-side alternative to a launch — the
reference's numpy ``GBDTModel.predict`` formula — kept as the baseline for
the per-row crossover measurement.

:func:`flash_attention_ref` and :func:`mamba_scan_ref` are the plain
versions of the CUDA attention and selective-scan kernels, the same math
in fp32 written as whole-tensor torch ops. Their summation orders differ
from the kernels', so the two agree to a tolerance, not bit for bit.
:func:`mamba2_scan_ref` is the Mamba-2 scan kernel's plain version: the
Mamba-1 scan of each B/C group's channels, each head's dt, A and D
repeated over its channels.

:func:`gqa_ref` is the model's plain attention over a key mask (the
reference's ``_sdpa``), and with the decode mask the plain version of the
decode-attention kernel (:mod:`repro_torch.kernels.decode_attention`);
its scores are :func:`grouped_scores`, which the mesh's key-parallel
attention (``models/attention.py``) computes on each rank's keys too.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["LaneSchedule", "NEG_INF", "flash_attention_ref",
           "gbdt_predict_numpy", "gbdt_predict_ref", "gqa_ref",
           "grouped_scores", "lane_schedule", "lane_sum", "mamba2_scan_ref",
           "mamba_scan_ref", "pairwise_program"]

#: The reference's mask value: large and negative, finite in fp32 and bf16.
NEG_INF = -2.0 ** 30
#: numpy's pairwise-sum block size (``PW_BLOCKSIZE``) and unroll width.
_BLOCK, _UNROLL = 128, 8


@functools.lru_cache(maxsize=None)
def pairwise_program(T: int) -> tuple[int, ...]:
    """numpy's pairwise summation of ``T`` terms as a post-order program:
    a positive entry sums the next that-many terms as one block (plain
    running sum below 8 terms, else 8 interleaved accumulators combined as
    ``((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7))`` with the remainder added
    after), and 0 replaces the top two partial sums ``a, b`` by ``a + b``.
    Blocks hold at most 128 terms; longer runs split at ``n//2`` rounded
    down to a multiple of 8, left half first — numpy's recursion."""
    if T <= _BLOCK:
        return (T,) if T else ()
    half = T // 2
    half -= half % _UNROLL
    return pairwise_program(half) + pairwise_program(T - half) + (0,)


class LaneSchedule(NamedTuple):
    """numpy's pairwise order for ``T`` terms cut into independent chains,
    as the CUDA GBDT kernel sums them (:func:`lane_schedule`)."""
    #: (first term, length) of each pairwise block, in order
    blocks: tuple[tuple[int, int], ...]
    #: the combine program over slots: slot ``len(blocks) + k`` is
    #: ``slot[a] + slot[b]`` for the k-th pair ``(a, b)``; slots
    #: ``0 .. len(blocks) - 1`` are the block sums; the last slot is the
    #: total
    pairs: tuple[tuple[int, int], ...]
    #: independent running sums: 8 per block when T >= 8 (chain j of a
    #: block takes its terms j, j + 8, ... of the 8-accumulator body), else
    #: one chain over all T terms (or none when T = 0)
    chains: int


@functools.lru_cache(maxsize=None)
def lane_schedule(T: int) -> LaneSchedule:
    """Cut :func:`pairwise_program` into chains. Every block of a program
    for ``T >= 8`` terms holds at least 8, so it is 8 interleaved chains
    plus ``L % 8`` remainder terms added in order after combining them;
    below 8 terms the program is one block summed by one running chain."""
    blocks, pairs, stack, start = [], [], [], 0
    prog = pairwise_program(T)
    n_blocks = sum(1 for op in prog if op)
    for op in prog:
        if op:
            stack.append(len(blocks))
            blocks.append((start, op))
            start += op
        else:
            b, a = stack.pop(), stack.pop()
            stack.append(n_blocks + len(pairs))
            pairs.append((a, b))
    chains = 8 * n_blocks if T >= _UNROLL else min(T, 1)
    return LaneSchedule(tuple(blocks), tuple(pairs), chains)


def lane_sum(c: torch.Tensor, sched: LaneSchedule) -> torch.Tensor:
    """Row sums of ``c`` (n, T) computed as the CUDA kernel computes them
    from ``sched``: each chain summed on its own (from -0.0, the additive
    identity, in an 8-chain block; from 0.0 in the single chain below 8
    terms, as numpy starts), each block's 8 chains combined by xor-shuffles
    over lanes 1, 2 and 4 apart, its remainder terms added in order, then
    the pair program over the block sums, and numpy's initial 0.0. Equals
    ``c.sum(axis=1)`` in numpy bit for bit; the CPU tests hold it there."""
    n, T = c.shape
    zero = torch.zeros(n, dtype=c.dtype, device=c.device)
    if sched.chains == 0:
        return 0.0 + zero
    if sched.chains == 1:
        acc = zero
        for t in range(T):
            acc = acc + c[:, t]
        return 0.0 + acc
    slots = []
    for start, L in sched.blocks:
        body = L - L % _UNROLL
        acc = torch.full((n, _UNROLL), -0.0, dtype=c.dtype, device=c.device)
        for k in range(start, start + body, _UNROLL):
            acc = acc + c[:, k:k + _UNROLL]
        for width in (1, 2, 4):      # lane j takes lane j ^ width's sum
            acc = acc + acc[:, torch.arange(_UNROLL) ^ width]
        res = acc[:, 0]
        for t in range(start + body, start + L):
            res = res + c[:, t]
        slots.append(res)
    for a, b in sched.pairs:
        slots.append(slots[a] + slots[b])
    return 0.0 + slots[-1]


def _pairwise_rows(c: torch.Tensor) -> torch.Tensor:
    """Row sums of ``c`` (n, L) in numpy's pairwise order."""
    n, L = c.shape
    if L < _UNROLL:
        res = torch.zeros(n, dtype=c.dtype, device=c.device)
        for i in range(L):
            res = res + c[:, i]
        return res
    if L <= _BLOCK:
        body = L - L % _UNROLL
        r = c[:, :_UNROLL].clone()
        for i in range(_UNROLL, body, _UNROLL):
            r += c[:, i:i + _UNROLL]
        res = ((r[:, 0] + r[:, 1]) + (r[:, 2] + r[:, 3])) + (
            (r[:, 4] + r[:, 5]) + (r[:, 6] + r[:, 7]))
        for i in range(body, L):
            res = res + c[:, i]
        return res
    half = L // 2
    half -= half % _UNROLL
    return _pairwise_rows(c[:, :half]) + _pairwise_rows(c[:, half:])


def gbdt_predict_ref(X: torch.Tensor, feats: torch.Tensor,
                     thresholds: torch.Tensor, leaves: torch.Tensor,
                     base: float = 0.0) -> torch.Tensor:
    """Oblivious-tree ensemble inference in torch, fp64.

    X: (n, F); feats: (T, D) integer; thresholds: (T, D); leaves:
    (T, 2**D). Returns (n,) float64 on X's device."""
    X = X.to(torch.float64)
    depth = feats.shape[1]
    gathered = X[:, feats.long()]                            # (n, T, D)
    bits = gathered > thresholds.to(torch.float64)[None]
    w = torch.tensor([1 << d for d in range(depth)], dtype=torch.int64,
                     device=X.device)
    idx = (bits.to(torch.int64) * w).sum(dim=-1)            # (n, T)
    contrib = torch.gather(
        leaves.to(torch.float64)[None].expand(X.shape[0], -1, -1), 2,
        idx[..., None])[..., 0]                             # (n, T)
    # numpy's reduction adds its pairwise sum to an initial 0.0
    return base + (0.0 + _pairwise_rows(contrib))


def gbdt_predict_numpy(X: np.ndarray, feats: np.ndarray,
                       thresholds: np.ndarray, leaves: np.ndarray,
                       base: float = 0.0) -> np.ndarray:
    """The reference's host numpy ensemble prediction (the formula of
    ``repro.core.gbdt.GBDTModel.predict``)."""
    X = np.asarray(X, dtype=np.float64)
    depth = feats.shape[1]
    bits = X[:, feats] > thresholds[None, :, :]
    leaf_idx = bits @ (1 << np.arange(depth)).astype(np.int64)
    contrib = np.take_along_axis(
        np.broadcast_to(leaves[None], (X.shape[0],) + leaves.shape),
        leaf_idx[:, :, None], axis=2)[..., 0]
    return base + contrib.sum(axis=1)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window=None) -> torch.Tensor:
    """Causal / sliding-window GQA attention with the flash kernel's
    arithmetic, in fp32. q: (B, Hq, Sq, hd); k/v: (B, Hkv, Sk, hd).
    Returns (B, Hq, Sq, hd) in q's dtype.

    Head h attends kv head ``h // (Hq // Hkv)``. Queries are right-aligned
    (row i sits at position ``i + Sk - Sq``). Masked scores take
    :data:`NEG_INF`, masked probabilities are zeroed and the denominator is
    clamped at 1e-30, so a row with no live key comes out 0 — where such a
    row exists this differs from a plain softmax, as the reference kernel
    does; elsewhere it is the softmax."""
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.float().reshape(B, Hkv, G, Sq, hd)
    kf = k.float()[:, :, None]
    vf = v.float()[:, :, None]
    s = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(hd))  # (B,K,G,Sq,Sk)
    qi = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    kj = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kj <= qi)
    if window is not None:
        mask = mask & (kj > qi - window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.where(mask, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = (p @ vf) / l
    return out.reshape(B, Hq, Sq, hd).to(q.dtype)


def grouped_scores(q, k, valid=None):
    """The fp32 scores of q (B, S, Hq, hd) over k (B, Hkv, Sk, hd), a KV
    head's G query heads and S rows as one (G*S, hd) block: (B, Hkv,
    G*S, Sk), products of the q-dtype values summed in fp32, divided by
    sqrt(hd); where ``valid`` ((Sk,), or (S, Sk) per query) is false,
    :data:`NEG_INF`."""
    B, S, Hq, hd = q.shape
    K, Sk = k.shape[1], k.shape[2]
    G = Hq // K
    qg = q.reshape(B, S, K, G, hd).permute(0, 2, 3, 1, 4).reshape(
        B, K, G * S, hd).float()
    scores = (qg @ k.to(q.dtype).float().transpose(-1, -2)) / math.sqrt(hd)
    if valid is not None:
        scores = torch.where(valid, scores.view(B, K, G, S, Sk),
                             NEG_INF).view(B, K, G * S, Sk)
    return scores


def gqa_ref(q, k, v, valid=None):
    """q (B, S, Hq, hd) over k/v (B, Hkv, Sk, hd), as the reference's
    ``_sdpa``: products of the q-dtype values summed in fp32 (its einsums
    with preferred_element_type=float32), probabilities rounded to q's
    dtype. ``valid`` masks keys: (Sk,) for every query alike, or (S, Sk)
    per query. Returns (B, S, Hq*hd) in q's dtype."""
    B, S, Hq, hd = q.shape
    K = k.shape[1]
    G = Hq // K
    vf = v.to(q.dtype).float()
    scores = grouped_scores(q, k, valid)                     # (B,K,G*S,Sk)
    probs = torch.softmax(scores, dim=-1).to(q.dtype).float()
    out = (probs @ vf).to(q.dtype).reshape(B, K, G, S, hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, Hq * hd)


def mamba_scan_ref(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                   h0: "torch.Tensor | None" = None):
    """Sequential Mamba-1 selective scan in fp32.

    u/dt: (B, L, Di); A: (Di, N); Bm/Cm: (B, L, N); D: (Di,); h0:
    (B, Di, N) or None (zeros). Returns (y (B, L, Di), h_last (B, Di, N)),
    both fp32."""
    Bsz, L, Di = u.shape
    N = A.shape[1]
    uf, dtf, Bf, Cf = (t.float() for t in (u, dt, Bm, Cm))
    Af = A.float()
    h = (torch.zeros((Bsz, Di, N), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    ys = []
    for t in range(L):
        dA = torch.exp(dtf[:, t, :, None] * Af[None])
        dBu = (dtf[:, t] * uf[:, t])[..., None] * Bf[:, t, None, :]
        h = dA * h + dBu
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]))
    y = torch.stack(ys, dim=1) + uf * D.float()[None, None, :]
    return y, h


def mamba2_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                    Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor,
                    scan=mamba_scan_ref):
    """A Mamba-2 prompt's scan from a zero state, as Mamba-1 scans of its
    ``H * P`` channels: dt rounded to x's dtype (as the reference casts it
    to u's dtype) and, like A and D, repeated over each head's P channels,
    every state row the head's A; one ``scan`` (a Mamba-1 scan with
    :func:`mamba_scan_ref`'s arguments) a group, over the channels of the
    group's heads with its own B and C, on fp32 contiguous copies.

    x: (B, L, H, P); dt: (B, L, H) fp32; A, D: (H,) fp32; Bm, Cm:
    (B, L, G, N), head j reading group ``j // (H / G)``. Returns (y
    (B, L, H, P) in x's dtype, h_last (B, H, P, N) fp32)."""
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Di = H * P
    xs = x.flatten(2)
    dt_c = dt.to(x.dtype).float().repeat_interleave(P, dim=-1)
    A_c = A.repeat_interleave(P)[:, None].expand(Di, N).contiguous()
    D_c = D.repeat_interleave(P)
    c = Di // G
    ys, hs = [], []
    for g in range(G):
        ch = slice(g * c, (g + 1) * c)
        y, h = scan(xs[..., ch].float().contiguous(),
                    dt_c[..., ch].contiguous(), A_c[ch].contiguous(),
                    Bm[:, :, g].float().contiguous(),
                    Cm[:, :, g].float().contiguous(), D_c[ch].contiguous())
        ys.append(y)
        hs.append(h)
    y = torch.cat(ys, dim=-1).reshape(B, L, H, P).to(x.dtype)
    return y, torch.cat(hs, dim=1).reshape(B, H, P, N)
