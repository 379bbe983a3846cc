"""Public wrappers around the port's kernels.

Each wrapper keeps the reference wrapper's API (``repro/kernels/ops.py``)
but takes torch tensors. It checks every argument and raises on what the
kernel does not take. A CUDA tensor launches the hand-written kernel or
raises — there is no fallback. A CPU tensor takes the kernel's plain
version (:mod:`repro_torch.kernels.ref`). Ragged sizes are handled inside
the kernels: nothing is padded here.

* :func:`gbdt_predict` (and :func:`gbdt_predict_model`) computes in fp64;
  kernel and plain version agree bit for bit.
* :func:`flash_attention` takes the model layout ``(B, S, H, hd)``, which
  the kernels read in place, in fp32 or bf16; the launch takes the
  tensor-core (``wgmma``) or the SIMT route, as
  :func:`repro_torch.kernels.flash_attention.route` chooses.
* :func:`mamba_scan` takes fp32 inputs and returns ``(y, h_last)``, the
  final state written by the kernel from the state it carries.
* :func:`mamba2_scan` takes a Mamba-2 prompt's x, B and C in the
  activation dtype (fp32 or bf16) as strided views of the in-projection,
  its dt, A and D per head, and scans every head and B/C group in one
  launch; y in the activation dtype, ``h_last`` in fp32. Its
  plain version runs :func:`mamba_scan` once a group
  (:func:`repro_torch.kernels.ref.mamba2_scan_ref`).
* :func:`mamba2_state_step` takes one decode token of a Mamba-2 mixer:
  its projection's xBC and dt columns (strided views), the conv weights,
  dt's bias, A and D, and the layer's conv and fp32 SSM state, which it
  updates in place; y in the activation dtype. Its plain version is the
  mixer's former decode step through the model's plain functions
  (:func:`repro_torch.kernels.mamba2_step.plain`).
* :func:`decode_attention` takes one new token's q in the model layout
  and a layer's KV cache as ``attention_decode`` holds it, in bf16 alone
  (the served dtype; an fp32 decode takes the model's plain path), and
  attends the decode mask's live slots only; ``pos`` may be a 0-d int64
  tensor on the card, which the kernel reads there.

The attention and scan kernels are forward-only, like the reference's: an
input that requires grad raises rather than being silently detached.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from . import decode_attention as _da
from . import flash_attention as _fa
from . import gbdt_predict as _gp
from . import mamba2_scan as _m2
from . import mamba2_step as _m5
from . import mamba_scan as _ms
from .ref import (flash_attention_ref, gbdt_predict_ref, mamba2_scan_ref,
                  mamba_scan_ref)

__all__ = ["decode_attention", "flash_attention", "gbdt_predict",
           "gbdt_predict_model", "mamba2_scan", "mamba2_state_step",
           "mamba_scan"]


def _check(name: str, t, dtype: torch.dtype, ndim: int,
           device: torch.device, anchor: str = "X",
           contiguous: bool = True) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got "
                        f"{type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, {anchor} is on {device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _device_of(name: str, t) -> torch.device:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got "
                        f"{type(t).__name__}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device


def _forward_only(**tensors) -> None:
    for name, t in tensors.items():
        if t.requires_grad:
            raise ValueError(
                f"{name} requires grad: the kernel is forward-only (no "
                "backward exists); run under torch.no_grad() or detach")


def _positive(**dims) -> None:
    for name, n in dims.items():
        if n < 1:
            raise ValueError(f"{name} must be >= 1, got {n}")


def gbdt_predict(X: torch.Tensor, feats: torch.Tensor,
                 thresholds: torch.Tensor, leaves: torch.Tensor,
                 base: float = 0.0) -> torch.Tensor:
    """Oblivious-tree ensemble inference in GBDTModel layout.

    X (n, F) float64; feats (T, D) int32 with every index in ``[0, F)``;
    thresholds (T, D) float64; leaves (T, 2**D) float64; all contiguous
    and on one device, ``D <= 8``. Returns (n,) float64 on that device.
    On CUDA a feature index outside ``[0, F)`` yields NaN for the row (the
    kernel never reads out of bounds); on the CPU it raises."""
    dev = _device_of("X", X)
    _check("X", X, torch.float64, 2, dev)
    _check("feats", feats, torch.int32, 2, dev)
    _check("thresholds", thresholds, torch.float64, 2, dev)
    _check("leaves", leaves, torch.float64, 2, dev)
    T, depth = feats.shape
    if depth > _gp.MAX_DEPTH:
        raise ValueError(f"tree depth {depth} exceeds the kernel's maximum "
                         f"of {_gp.MAX_DEPTH}")
    if tuple(thresholds.shape) != (T, depth):
        raise ValueError(f"thresholds shape {tuple(thresholds.shape)} != "
                         f"feats shape {(T, depth)}")
    if tuple(leaves.shape) != (T, 1 << depth):
        raise ValueError(f"leaves shape {tuple(leaves.shape)} != "
                         f"{(T, 1 << depth)} for depth {depth}")
    if dev.type == "cpu":
        return gbdt_predict_ref(X, feats, thresholds, leaves, base)
    out = torch.empty(X.shape[0], dtype=torch.float64, device=dev)
    if X.shape[0] == 0:
        return out
    if X.shape[1] == 0:
        raise ValueError("X has no features")
    _gp.launch(X, feats, thresholds, leaves, float(base), out)
    return out


def gbdt_predict_model(model, X) -> np.ndarray:
    """Run a fitted :class:`repro_torch.core.gbdt.GBDTModel` over ``X``
    (numpy or tensor) on the model's device: one host→device copy, one
    launch, one copy back. Returns a float64 numpy array."""
    feats, thresholds, leaves = model.device_tables()
    if not isinstance(X, torch.Tensor):
        X = torch.from_numpy(np.ascontiguousarray(X, dtype=np.float64))
    Xt = X.to(device=feats.device, dtype=torch.float64).contiguous()
    return gbdt_predict(Xt, feats, thresholds, leaves,
                        model.base).cpu().numpy()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window=None) -> torch.Tensor:
    """Causal / sliding-window GQA flash attention in the model layout.

    q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd); one dtype (float32 or
    bfloat16), one device, contiguous; ``Hq % Hkv == 0``, ``hd`` at most
    256 in bf16 and 128 in fp32
    (:func:`repro_torch.kernels.flash_attention.max_head_dim`);
    ``window`` None or a positive int. Queries are right-aligned at
    position ``i + Sk - Sq``; a row with no live key gives 0. Returns
    (B, Sq, Hq, hd) in q's dtype."""
    dev = _device_of("q", q)
    dtype = q.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be torch.float32 or torch.bfloat16, got "
                        f"{dtype}")
    _check("q", q, dtype, 4, dev, anchor="q")
    _check("k", k, dtype, 4, dev, anchor="q")
    _check("v", v, dtype, 4, dev, anchor="q")
    _forward_only(q=q, k=k, v=v)
    B, Sq, Hq, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"v shape {tuple(v.shape)} != k shape "
                         f"{tuple(k.shape)}")
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k shape {tuple(k.shape)} does not match q shape "
                         f"{tuple(q.shape)} in batch or head dim")
    _positive(B=B, Sq=Sq, Sk=Sk, Hq=Hq, Hkv=Hkv, hd=hd)
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads are not a multiple of {Hkv} "
                         "kv heads")
    if hd > _fa.max_head_dim(dtype):
        raise ValueError(f"head dim {hd} exceeds the kernel's maximum of "
                         f"{_fa.max_head_dim(dtype)} in {dtype}")
    if window is not None and (isinstance(window, bool)
                               or not isinstance(window, int) or window < 1):
        raise ValueError(f"window must be None or a positive int, got "
                         f"{window!r}")
    if dev.type == "cpu":
        out = flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                  v.transpose(1, 2), causal=causal,
                                  window=window)
        return out.transpose(1, 2).contiguous()
    out = torch.empty_like(q)
    _fa.launch(q, k, v, out, bool(causal), window)
    return out


def mamba_scan(u: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor):
    """Mamba-1 selective scan from a zero state.

    u, dt: (B, L, Di); A: (Di, N); Bm, Cm: (B, L, N); D: (Di,); all
    float32, on one device, contiguous; ``N <= 64``. Returns (y (B, L, Di),
    h_last (B, Di, N)), both float32."""
    dev = _device_of("u", u)
    f32 = torch.float32
    _check("u", u, f32, 3, dev, anchor="u")
    _check("dt", dt, f32, 3, dev, anchor="u")
    _check("A", A, f32, 2, dev, anchor="u")
    _check("Bm", Bm, f32, 3, dev, anchor="u")
    _check("Cm", Cm, f32, 3, dev, anchor="u")
    _check("D", D, f32, 1, dev, anchor="u")
    _forward_only(u=u, dt=dt, A=A, Bm=Bm, Cm=Cm, D=D)
    B, L, Di = u.shape
    N = A.shape[1]
    for name, t, want in (("dt", dt, (B, L, Di)), ("A", A, (Di, N)),
                          ("Bm", Bm, (B, L, N)), ("Cm", Cm, (B, L, N)),
                          ("D", D, (Di,))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {want}")
    _positive(B=B, L=L, Di=Di, N=N)
    if N > _ms.MAX_STATE:
        raise ValueError(f"state size {N} exceeds the kernel's maximum of "
                         f"{_ms.MAX_STATE}")
    if dev.type == "cpu":
        return mamba_scan_ref(u, dt, A, Bm, Cm, D)
    y = torch.empty_like(u)
    h_last = torch.empty((B, Di, N), dtype=f32, device=dev)
    _ms.launch(u, dt, A, Bm, Cm, D, y, h_last)
    return y, h_last


def mamba2_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, D: torch.Tensor):
    """A Mamba-2 prompt's selective scan from a zero state, every head and
    B/C group at once.

    x: (B, L, H, P); Bm, Cm: (B, L, G, N), head j reading group
    ``j // (H / G)``; all three in one dtype, float32 or bfloat16, each
    with its last two dims contiguous (strided views of one projection
    are taken as they are); dt: (B, L, H) float32, rounded to x's dtype
    before use; A, D: (H,) float32; dt, A and D contiguous; all on one
    device; ``H % G == 0``, ``N <= 64``. Returns (y (B, L, H, P) in x's
    dtype, one rounding of the fp32 sum; h_last (B, H, P, N) float32). On
    the CPU the plain version runs :func:`mamba_scan` once a group."""
    dev = _device_of("x", x)
    dtype = x.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be torch.float32 or torch.bfloat16, got "
                        f"{dtype}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        _check(name, t, dtype, 4, dev, anchor="x", contiguous=False)
    _check("dt", dt, torch.float32, 3, dev, anchor="x")
    _check("A", A, torch.float32, 1, dev, anchor="x")
    _check("D", D, torch.float32, 1, dev, anchor="x")
    _forward_only(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, D=D)
    B, L, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    for name, t, want in (("dt", dt, (B, L, H)), ("A", A, (H,)),
                          ("D", D, (H,)), ("Bm", Bm, (B, L, G, N)),
                          ("Cm", Cm, (B, L, G, N))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {want}")
    _positive(B=B, L=L, H=H, P=P, G=G, N=N)
    if H % G:
        raise ValueError(f"{H} heads do not split into {G} groups of B "
                         "and C")
    if N > _m2.MAX_STATE:
        raise ValueError(f"state size {N} exceeds the kernel's maximum of "
                         f"{_m2.MAX_STATE}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if not t[0, 0].is_contiguous():
            raise ValueError(f"{name}'s last two dims must be contiguous")
    if dev.type == "cpu":
        return mamba2_scan_ref(x, dt, A, Bm, Cm, D, scan=mamba_scan)
    y = torch.empty((B, L, H, P), dtype=dtype, device=dev)
    h_last = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    _m2.launch(x, dt, A, Bm, Cm, D, y, h_last)
    return y, h_last


def mamba2_state_step(xBC: torch.Tensor, dt_raw: torch.Tensor,
                      conv_w: torch.Tensor, conv_b: torch.Tensor,
                      dt_bias: torch.Tensor, A_log: torch.Tensor,
                      D: torch.Tensor, conv_state: torch.Tensor,
                      ssm_state: torch.Tensor) -> torch.Tensor:
    """One decode token of a Mamba-2 mixer, every sequence, head and B/C
    group at once, the layer's conv and SSM state updated in place.

    xBC: (B, 1, H P + 2 G N), the conv's input channels (x of every head,
    then B and C of every group), and dt_raw: (B, 1, H), each in the
    activation dtype (float32 or bfloat16) with its last dim contiguous
    (strided views of one projection are taken as they are); conv_w
    (C, K) and conv_b (C,) in that dtype, contiguous, ``K <=``
    :data:`~repro_torch.kernels.mamba2_step.MAX_CONV`; dt_bias, A_log, D
    (H,) float32; conv_state (B, K - 1, C) float32 or bfloat16 and
    ssm_state (B, H, P, N) float32, contiguous, each written in place;
    all on one device; G, from the widths, divides H; ``N <= 64``. Head j
    reads group ``j // (H / G)``. dt is ``softplus(dt_raw + dt_bias)``
    rounded to the activation dtype, the decay ``exp(dt -exp(A_log))``.
    Returns y (B, 1, H P) in the activation dtype: each ``h·C`` rounded to
    it, then ``+ D x`` in fp32, rounded. On the card the conv window sums
    its taps in fp32 and rounds once; the plain version
    (:func:`repro_torch.kernels.mamba2_step.plain`, on the CPU) rounds as
    the former step did."""
    dev = _device_of("xBC", xBC)
    dtype = xBC.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"xBC must be torch.float32 or torch.bfloat16, got "
                        f"{dtype}")
    if conv_state.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv_state must be torch.float32 or "
                        f"torch.bfloat16, got {conv_state.dtype}")
    f32 = torch.float32
    _check("xBC", xBC, dtype, 3, dev, anchor="xBC", contiguous=False)
    _check("dt_raw", dt_raw, dtype, 3, dev, anchor="xBC", contiguous=False)
    _check("conv_w", conv_w, dtype, 2, dev, anchor="xBC")
    _check("conv_b", conv_b, dtype, 1, dev, anchor="xBC")
    for name, t in (("dt_bias", dt_bias), ("A_log", A_log), ("D", D)):
        _check(name, t, f32, 1, dev, anchor="xBC")
    _check("conv_state", conv_state, conv_state.dtype, 3, dev, anchor="xBC")
    _check("ssm_state", ssm_state, f32, 4, dev, anchor="xBC")
    _forward_only(xBC=xBC, dt_raw=dt_raw, conv_w=conv_w, conv_b=conv_b,
                  dt_bias=dt_bias, A_log=A_log, D=D, conv_state=conv_state,
                  ssm_state=ssm_state)
    B, one, C = xBC.shape
    H, P, N = ssm_state.shape[1:]
    K = conv_w.shape[1]
    if one != 1:
        raise ValueError(f"xBC must hold one token, (B, 1, C), got shape "
                         f"{tuple(xBC.shape)}")
    _positive(B=B, H=H, P=P, N=N, K=K)
    G = (C - H * P) // (2 * N)
    if G < 1 or C != H * P + 2 * G * N:
        raise ValueError(f"xBC's {C} channels are not the {H * P} of x and "
                         f"B and C of one or more groups of {N} states")
    for name, t, want in (("dt_raw", dt_raw, (B, 1, H)),
                          ("conv_w", conv_w, (C, K)), ("conv_b", conv_b, (C,)),
                          ("dt_bias", dt_bias, (H,)), ("A_log", A_log, (H,)),
                          ("D", D, (H,)),
                          ("conv_state", conv_state, (B, K - 1, C)),
                          ("ssm_state", ssm_state, (B, H, P, N))):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {want}")
    if H % G:
        raise ValueError(f"{H} heads do not split into {G} groups of B "
                         "and C")
    if N > _m5.MAX_STATE:
        raise ValueError(f"state size {N} exceeds the kernel's maximum of "
                         f"{_m5.MAX_STATE}")
    if K > _m5.MAX_CONV:
        raise ValueError(f"conv width {K} exceeds the kernel's maximum of "
                         f"{_m5.MAX_CONV}")
    for name, t in (("xBC", xBC), ("dt_raw", dt_raw)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    if dev.type == "cpu":
        return _m5.plain(xBC, dt_raw, conv_w, conv_b, dt_bias, A_log, D,
                         conv_state, ssm_state)
    act = torch.empty((B, C), dtype=dtype, device=dev)
    y = torch.empty((B, 1, H * P), dtype=dtype, device=dev)
    _m5.launch(xBC, dt_raw, conv_w, conv_b, dt_bias, A_log, D, conv_state,
               ssm_state, act, y)
    return y


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos, window=None) -> torch.Tensor:
    """One new token's GQA attention over a layer's KV cache.

    q: (B, 1, Hq, hd); k, v: the cache, (B, Hkv, S_max, hd); bfloat16
    alone (anything else raises ``TypeError``, on the CPU too, so that
    the plain version keeps the kernel's contract), on one device,
    contiguous, each starting on a 16-byte boundary; ``Hq % Hkv == 0``
    with at most :data:`~repro_torch.kernels.decode_attention.MAX_GROUP`
    query heads a KV head; ``hd`` a multiple of 16 up to 256. ``pos``:
    the position being decoded, an int in ``[0, S_max)`` (any int >= 0 on
    a ring), or a 0-d int64 tensor on q's device, which the kernel reads
    there (a CUDA graph's position buffer). ``window``: None or a
    positive int; a cache of at most ``window`` slots is a ring. Attends
    the slots of :func:`repro_torch.kernels.decode_attention.live_range`
    with the plain path's numerics. Returns (B, 1, Hq*hd) in bfloat16."""
    dev = _device_of("q", q)
    dtype = torch.bfloat16
    _check("q", q, dtype, 4, dev, anchor="q")
    _check("k", k, dtype, 4, dev, anchor="q")
    _check("v", v, dtype, 4, dev, anchor="q")
    _forward_only(q=q, k=k, v=v)
    B, one, Hq, hd = q.shape
    Hkv, S_max = k.shape[1], k.shape[2]
    if one != 1:
        raise ValueError(f"q must hold one token, (B, 1, Hq, hd), got shape "
                         f"{tuple(q.shape)}")
    if tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"v shape {tuple(v.shape)} != k shape "
                         f"{tuple(k.shape)}")
    if k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k shape {tuple(k.shape)} does not match q shape "
                         f"{tuple(q.shape)} in batch or head dim")
    _positive(B=B, Hq=Hq, Hkv=Hkv, S_max=S_max)
    if Hq % Hkv:
        raise ValueError(f"{Hq} query heads are not a multiple of {Hkv} "
                         "kv heads")
    if Hq // Hkv > _da.MAX_GROUP:
        raise ValueError(f"{Hq // Hkv} query heads a kv head: the kernel "
                         f"takes at most {_da.MAX_GROUP}")
    if hd % 16 or not 16 <= hd <= _da.MAX_HEAD_DIM:
        raise ValueError(f"head dim {hd} is not a multiple of 16 in [16, "
                         f"{_da.MAX_HEAD_DIM}]")
    if window is not None and (isinstance(window, bool)
                               or not isinstance(window, int) or window < 1):
        raise ValueError(f"window must be None or a positive int, got "
                         f"{window!r}")
    if isinstance(pos, torch.Tensor):
        if pos.dim() != 0 or pos.dtype != torch.int64 or pos.device != dev:
            raise ValueError(f"a tensor pos must be 0-d int64 on {dev}, got "
                             f"{pos.dtype} of shape {tuple(pos.shape)} on "
                             f"{pos.device}")
    elif isinstance(pos, bool) or not isinstance(pos, numbers.Integral) or \
            pos < 0 or (pos >= S_max and not _da.is_ring(S_max, window)):
        raise ValueError(f"pos must be an int in [0, {S_max}) (any int >= 0 "
                         f"on a ring), got {pos!r}")
    else:
        pos = int(pos)
    if dev.type == "cpu":
        return _da.plain(q, k, v, pos, window)
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")
    out = torch.empty((B, 1, Hq * hd), dtype=dtype, device=dev)
    _da.launch(q, k, v, pos, window, out)
    return out
