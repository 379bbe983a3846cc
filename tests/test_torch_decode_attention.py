"""The decode-attention kernel (K4, ``kernels/decode_attention.py``),
which takes bf16 alone, and its route in ``attention_decode``
(``attention.uses_decode_kernel``).

On the CPU: the live range the kernel computes is the decode mask for
every position of causal, windowed and ring caches; the wrapper's plain
version equals ``_gqa`` over that mask bit for bit, up to G 8; a bf16
``attention_decode`` with its cache put on the card (forced on the CPU,
where the wrapper runs the plain version) takes the kernel route and
gives the plain route's output bit for bit, and an fp32 one takes the
plain route there (``_plain_gqa`` over the decode mask; the kernel is
never called); the counters of both routes, through ``attention_decode``
and ``count_decode_step``; the tolerance (``tolerance()``) holding for
the kernel's order of the fp32 sums and failing for faults of one slot
or one 16-row step; what the wrapper refuses, fp32 among it. On the card
(``cuda`` marker, skipped without one; no JAX is imported here)::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_decode_attention.py

the kernel against the plain version at ``tolerance()`` over head dims
64-256, G 1-8, positions at both ends and in the middle, windows and
rings; the two serving cells' shapes, where faults planted in the
kernel's arguments or in the mask fail the same check; caches of 131072
slots, whose scores leave shared memory; the int and tensor ``pos`` and
two calls bit for bit; what the wrapper refuses there.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.configs.base import reduce_for_smoke, with_port_fields
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn, model

#: (S_max, window): a causal cache, a window narrower than the cache, a
#: window-sized ring and a ring narrower than its window
CACHES = [(16, None), (16, 4), (8, 8), (8, 32)]


def _ring(S_max, window):
    return window is not None and S_max <= window


def _positions(S_max, window):
    """Every position a decode step over the cache can be at."""
    return range(3 * S_max if _ring(S_max, window) else S_max)


@pytest.fixture(autouse=True)
def _obs_off():
    obs.disable()
    obs.drain()
    yield
    obs.disable()
    obs.drain()


@pytest.mark.parametrize("S_max,window", CACHES)
def test_live_range_is_the_decode_mask(S_max, window):
    kj = torch.arange(S_max)
    for pos in _positions(S_max, window):
        lo, hi = da.live_range(pos, S_max, window)
        want = (kj >= lo) & (kj < hi)
        assert torch.equal(attn.decode_mask(pos, S_max, window), want), pos
        assert torch.equal(attn.decode_mask(torch.tensor(pos), S_max,
                                            window), want), pos
        assert hi - lo == int(want.sum())


def _inputs(B, Hq, Hkv, hd, S_max, dtype, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, 1, Hq, hd), generator=g)
    k, v = (torch.randn((B, Hkv, S_max, hd), generator=g) for _ in range(2))
    return [t.to(dtype).to(device) for t in (q, k, v)]


@pytest.mark.parametrize("Hq,Hkv", [(4, 4), (8, 2), (6, 2), (16, 2)])
@pytest.mark.parametrize("S_max,window", CACHES)
def test_plain_version_is_gqa_over_the_mask_bitwise(S_max, window, Hq, Hkv):
    dtype = torch.bfloat16
    q, k, v = _inputs(2, Hq, Hkv, 32, S_max, dtype)
    for pos in (0, S_max // 2, S_max - 1, S_max + 3):
        if pos >= S_max and not _ring(S_max, window):
            continue
        want = attn._gqa(q, k, v, attn.decode_mask(pos, S_max, window))
        for p in (pos, torch.tensor(pos)):
            got = ops.decode_attention(q, k, v, p, window)
            assert got.shape == (2, 1, Hq * 32) and got.dtype == dtype
            assert torch.equal(got, want), (pos, p)


def _cfg(window=None, dtype="float32"):
    return dataclasses.replace(reduce_for_smoke(get_config(
        "mistral-nemo-12b")), sliding_window=window, param_dtype=dtype,
        activation_dtype=dtype)


def _on_card(monkeypatch):
    """Every cache counts as on the card with no mesh: the route is then
    the dtypes' alone (``uses_decode_kernel``)."""
    monkeypatch.setattr(attn, "_on_card", lambda cache: True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S_max,window", CACHES)
def test_attention_decode_on_the_kernel_route(monkeypatch, S_max, window,
                                              dtype):
    """``attention_decode`` with its cache taken to be on the card against
    the plain route as the CPU runs it: the same output and cache bit for
    bit, for int and tensor ``pos``. bf16 takes the kernel (whose wrapper
    runs the plain version on the CPU): the int route counts the live
    slots as attended and one kernel attention. fp32 takes the plain
    route even so: ``_plain_gqa`` over the decode mask, the kernel never
    called, every slot counted as attended."""
    cfg = _cfg(window, dtype)
    p = attn.init_attention(cfg, torch.Generator().manual_seed(0), "cpu")
    dt = p.wq.dtype
    g = torch.Generator().manual_seed(1)
    B = 2
    x = torch.randn((B, 1, cfg.d_model), generator=g).to(dt)
    shape = (B, cfg.n_kv_heads, S_max, cfg.resolved_head_dim)
    ck, cv = (torch.randn(shape, generator=g).to(dt) for _ in range(2))
    kernel = dtype == "bfloat16"
    plain = attn._plain_gqa
    for pos in (0, S_max - 1, 2 * S_max + 1):
        if pos >= S_max and not _ring(S_max, window):
            continue
        want = attn.attention_decode(p, x, ck.clone(), cv.clone(), pos, cfg)
        _on_card(monkeypatch)
        masks = []
        if not kernel:
            def refuse(*args, **kw):
                raise AssertionError("an fp32 step called the kernel")

            def spy(q, k, v, valid=None, rows=None):
                masks.append(valid)
                return plain(q, k, v, valid, rows)
            monkeypatch.setattr(attn.kops, "decode_attention", refuse)
            monkeypatch.setattr(attn, "_plain_gqa", spy)
        obs.enable()
        for at in (pos, torch.tensor(pos)):
            got = attn.attention_decode(p, x, ck.clone(), cv.clone(), at,
                                        cfg)
            for u, w in zip(got, want):
                assert torch.equal(u, w)
        obs.disable()
        monkeypatch.undo()
        lo, hi = da.live_range(pos, S_max, window)
        if kernel:
            assert obs.drain().counts == {
                "attention.positions_attended": B * (hi - lo),
                "attention.positions_live": B * (hi - lo),
                "attention.decode_kernel": 1}
        else:
            mask = attn.decode_mask(pos, S_max, window)
            assert len(masks) == 2 and all(torch.equal(m, mask)
                                           for m in masks)
            assert obs.drain().counts == {
                "attention.positions_attended": B * S_max,
                "attention.positions_live": B * (hi - lo)}


def _hybrid(dtype="float32"):
    cfg = dataclasses.replace(reduce_for_smoke(get_config("zamba2-7b")),
                              param_dtype=dtype, activation_dtype=dtype)
    return with_port_fields(
        cfg, n_layers=7, hidden_act="gelu", mamba_ngroups=2,
        shared_block="zamba2", num_mem_blocks=2, adapter_rank=4,
        hybrid_layer_ids=(1, 4, 5), tie_embeddings=True,
        hybrid_attn_period=0)


@pytest.mark.parametrize("kernel", [False, True])
@pytest.mark.parametrize("family", ["dense", "hybrid"])
def test_count_decode_step_counts_the_route_it_is_given(monkeypatch, family,
                                                        kernel):
    """``count_decode_step`` on each route against what the eager
    int-``pos`` steps count there (the kernel route: a bf16 model with
    its cache taken to be on the card): every slot attended on the plain
    route, the live ones through the kernel, and one
    ``attention.decode_kernel`` an attention layer."""
    dtype = "bfloat16" if kernel else "float32"
    cfg = _cfg(dtype=dtype) if family == "dense" else _hybrid(dtype)
    params = model.init(cfg, device="cpu")
    S, max_seq = 5, 16
    tokens = torch.randint(0, cfg.vocab_size, (2, S),
                           generator=torch.Generator().manual_seed(2))
    _, cache = model.prefill(cfg, params, tokens, max_seq, device="cpu")
    if kernel:
        _on_card(monkeypatch)
    layers = (len(cfg.hybrid_layer_ids) if family == "hybrid"
              else cfg.n_layers)
    obs.enable()
    model.count_decode_step(cfg, cache, S)
    counted = obs.drain().counts
    tok = torch.zeros((2, 1), dtype=torch.long)
    model.decode_step(cfg, params, cache, tok, S, device="cpu")
    obs.disable()
    stepped = obs.drain().counts
    assert counted == stepped
    live = layers * 2 * (S + 1)
    assert counted["attention.positions_live"] == live
    assert counted["attention.positions_attended"] == (
        live if kernel else layers * 2 * max_seq)
    assert counted.get("attention.decode_kernel") == (layers if kernel
                                                      else None)


def _worst(got, want, atol, rtol) -> float:
    """The largest ``|got - want| / (atol + rtol |want|)``: above 1, the
    check fails."""
    want = want.double()
    err = (got.double() - want).abs()
    ratio = err / (atol + rtol * want.abs())
    return float(torch.where(err == 0, 0.0, ratio).max())


def _split_order(q, k, v, pos, window, splits):
    """The kernel's function with its order of the fp32 sums, on the CPU:
    the live range in ``splits`` equal slices as the cluster splits it,
    each slice's scores and sum of exps, the slices' maxima, sums and
    partial p.V combined in rank order."""
    B, _, Hq, hd = q.shape
    Hkv, S_max = k.shape[1], k.shape[2]
    lo, hi = da.live_range(pos, S_max, window)
    n = hi - lo
    share = -(-n // splits)
    bounds = [(lo + min(r * share, n), lo + min((r + 1) * share, n))
              for r in range(splits)]
    bounds = [(a, b) for a, b in bounds if b > a]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd).float()
    scale = float(np.float32(1.0) / np.float32(math.sqrt(hd)))
    scores = [(qg @ k[:, :, a:b].float().transpose(-1, -2)) * scale
              for a, b in bounds]
    m = torch.stack([s.amax(-1) for s in scores]).amax(0)[..., None]
    exps = [torch.exp(s - m) for s in scores]
    total = exps[0].sum(-1, keepdim=True)
    for e in exps[1:]:
        total = total + e.sum(-1, keepdim=True)
    out = 0
    for e, (a, b) in zip(exps, bounds):
        p = (e / total).to(q.dtype).float()
        out = out + p @ v[:, :, a:b].float()
    return out.to(q.dtype).reshape(B, 1, Hq * hd)


#: (B, Hq, Hkv, hd, pos, window) over 2048 bf16 slots: the decode cells'
#: layers (Mistral-NeMo-12B's, Zamba2-7B's) at a smaller batch, at
#: decode-b32's mid-batch position; Mistral-NeMo's under a window
ORDER_SHAPES = {"mistral-nemo-12b": (4, 32, 8, 128, 1279, None),
                "zamba2-7b": (2, 32, 32, 224, 1279, None),
                "mistral-nemo-12b-window": (4, 32, 8, 128, 1279, 1000)}


@pytest.mark.parametrize("splits", [2, 3, 8])
@pytest.mark.parametrize("shape", sorted(ORDER_SHAPES))
def test_tolerance_holds_for_the_kernels_order_of_sums(shape, splits):
    """The bound covers another order of the same sums: the cluster's
    slices, combined in rank order, against the plain version."""
    B, Hq, Hkv, hd, pos, window = ORDER_SHAPES[shape]
    q, k, v = _inputs(B, Hq, Hkv, hd, 2048, torch.bfloat16, seed=hd + B)
    want = da.plain(q, k, v, pos, window)
    got = _split_order(q, k, v, pos, window, splits)
    atol, rtol = da.tolerance(q, k, v, pos, window)
    assert _worst(got, want, atol, rtol) <= 1.0


def _faults(lo, hi, S_max, splits=2):
    """Masks of a kernel that got its live range ``[lo, hi)`` wrong by one
    slot or one 16-row step: name -> (S_max,) boolean."""
    share = -(-(hi - lo) // splits)
    edge = lo + share                        # a slice's first slot
    out = {"slot at pos dropped": (lo, hi - 1),
           "first live slot dropped": (lo + 1, hi)}
    if hi < S_max:
        out["slot past pos added"] = (lo, hi + 1)
    if lo > 0:
        out["slot before the window added"] = (lo - 1, hi)
    kj = torch.arange(S_max)
    masks = {name: (kj >= a) & (kj < b) for name, (a, b) in out.items()}
    live = (kj >= lo) & (kj < hi)
    masks["a slice's first slot dropped"] = live & (kj != edge)
    masks["a 16-row step skipped"] = live & ((kj < edge) | (kj >= edge + 16))
    return masks


@pytest.mark.parametrize("shape", sorted(ORDER_SHAPES))
def test_tolerance_fails_faults_of_one_slot(shape):
    """A kernel that drops or adds one slot (at ``pos``, at the window's
    edge, at a slice's boundary) or skips a 16-row step fails the check
    at the decode cells' layers: stand-ins, the plain version over the
    faulty mask."""
    B, Hq, Hkv, hd, pos, window = ORDER_SHAPES[shape]
    q, k, v = _inputs(B, Hq, Hkv, hd, 2048, torch.bfloat16, seed=hd + B)
    want = da.plain(q, k, v, pos, window)
    atol, rtol = da.tolerance(q, k, v, pos, window)
    lo, hi = da.live_range(pos, 2048, window)
    for name, mask in _faults(lo, hi, 2048).items():
        got = ref.gqa_ref(q, k, v, mask)
        assert _worst(got, want, atol, rtol) > 1.0, name


def _refusals(device):
    q, k, v = _inputs(2, 4, 2, 32, 16, torch.bfloat16, device)
    bad = {
        "dtype": ((q, k.float(), v.float(), 3), TypeError, "bfloat16"),
        "fp32": ((q.float(), k.float(), v.float(), 3), TypeError,
                 "bfloat16"),
        "two tokens": ((q.expand(2, 2, 4, 32).contiguous(), k, v, 3),
                       ValueError, "one token"),
        "non-contiguous": ((q, k.transpose(2, 3), v, 3), ValueError,
                           "contiguous"),
        "head dim": ((q[..., :24].contiguous(), k[..., :24].contiguous(),
                      v[..., :24].contiguous(), 3), ValueError, "multiple"),
        "heads": ((torch.cat([q, q[:, :, :1]], 2), k, v, 3), ValueError,
                  "multiple"),
        "group above 8": ((q.repeat(1, 1, 5, 1), k, v, 3), ValueError,
                          "at most 8"),
        "v shape": ((q, k, v[:, :, :8].contiguous(), 3), ValueError,
                    "v shape"),
        "pos past the cache": ((q, k, v, 16), ValueError, "pos"),
        "negative pos": ((q, k, v, -1), ValueError, "pos"),
        "int32 pos": ((q, k, v, torch.tensor(3, dtype=torch.int32,
                                              device=device)),
                      ValueError, "0-d int64"),
    }
    big = _inputs(1, 2, 2, 272, 4, torch.bfloat16, device)
    bad["head dim above 256"] = ((*big, 1), ValueError, "multiple")
    return bad, (q, k, v)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    bad, (q, k, v) = _refusals("cpu")
    for name, (args, exc, match) in bad.items():
        with pytest.raises(exc, match=match):
            ops.decode_attention(*args)
    with pytest.raises(ValueError, match="window"):
        ops.decode_attention(q, k, v, 3, window=0)
    with pytest.raises(ValueError, match="requires grad"):
        ops.decode_attention(q.clone().requires_grad_(), k, v, 3)


# ---------------------------------------------------------------------- #
#  On the card
# ---------------------------------------------------------------------- #
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _check(got, want, q, k, v, pos, window, what):
    atol, rtol = da.tolerance(q, k, v, pos, window)
    worst = _worst(got, want, atol, rtol)
    assert worst <= 1.0, f"{what}: |err| / bound up to {worst}"
    return worst


def _cases(S_max, window):
    """(pos, what) at both ends and in the middle; past the wrap on a
    ring."""
    out = [0, S_max // 2 - 1, S_max - 1]
    if _ring(S_max, window):
        out += [S_max, 2 * S_max + 5]
    return out


#: (hd, Hq, Hkv, B): every head dim 64-256 and every G of the families
#: (1, 3, 4, 5, 6, 8), both batch sizes; the smallest head dim
CARD_SHAPES = [(64, 20, 20, 1), (80, 40, 8, 32), (112, 64, 8, 1),
               (128, 48, 8, 32), (224, 32, 32, 32), (256, 24, 8, 1),
               (64, 15, 5, 32), (128, 32, 8, 1), (16, 4, 2, 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("S_max,window", [(512, None), (512, 100),
                                          (256, 256), (192, 4096)])
@pytest.mark.parametrize("hd,Hq,Hkv,B", CARD_SHAPES)
def test_kernel_matches_plain_on_the_card(hd, Hq, Hkv, B, S_max, window):
    dev = _card()
    q, k, v = _inputs(B, Hq, Hkv, hd, S_max, torch.bfloat16, dev,
                      seed=hd + Hq)
    before = da.launches
    for pos in _cases(S_max, window):
        got = ops.decode_attention(q, k, v, pos, window)
        want = da.plain(q, k, v, pos, window)
        torch.cuda.synchronize()
        _check(got, want, q, k, v, pos, window, f"pos {pos}")
    assert da.launches - before == len(_cases(S_max, window))


#: the decode cells' layers: Mistral-NeMo-12B, Zamba2-7B
CELL_SHAPES = {"mistral-nemo-12b": (32, 32, 8, 128),
               "zamba2-7b": (32, 32, 32, 224)}


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 1000])
@pytest.mark.parametrize("cell", sorted(CELL_SHAPES))
def test_the_cells_shapes_on_the_card(cell, window):
    """At B 32 over a 2048-slot bf16 cache: the plain version's values
    at pos 0, 1279 and 2047; the int and tensor ``pos`` give the same
    bits, and so do two calls. At 1279 the kernel with a fault in its
    arguments (a slot dropped or added at ``pos``, the window's edge one
    off) and the plain version over a faulty mask (a slice's first slot
    dropped, a 16-row step skipped) each fail the same check."""
    dev = _card()
    B, Hq, Hkv, hd = CELL_SHAPES[cell]
    q, k, v = _inputs(B, Hq, Hkv, hd, 2048, torch.bfloat16, dev, seed=7)
    for pos in (0, 1279, 2047):
        got = ops.decode_attention(q, k, v, pos, window)
        again = ops.decode_attention(q, k, v, pos, window)
        on_card = ops.decode_attention(
            q, k, v, torch.tensor(pos, device=dev), window)
        want = da.plain(q, k, v, pos, window)
        torch.cuda.synchronize()
        _check(got, want, q, k, v, pos, window, f"{cell} pos {pos}")
        assert torch.equal(got, again) and torch.equal(got, on_card)
    pos = 1279
    want = da.plain(q, k, v, pos, window)
    atol, rtol = da.tolerance(q, k, v, pos, window)
    wrong = {"slot at pos dropped": (pos - 1, window),
             "slot past pos added": (pos + 1, window)}
    if window is not None:
        wrong["window's edge one lower"] = (pos, window + 1)
        wrong["window's edge one higher"] = (pos, window - 1)
    for name, (p, w) in wrong.items():
        got = ops.decode_attention(q, k, v, p, w)
        assert _worst(got, want, atol, rtol) > 1.0, name
    splits, _ = da._plan(B, Hkv, Hq // Hkv, 2048, hd, dev.index or 0)
    lo, hi = da.live_range(pos, 2048, window)
    for name, mask in _faults(lo, hi, 2048, max(splits, 2)).items():
        got = ref.gqa_ref(q, k, v, mask.to(dev))
        assert _worst(got, want, atol, rtol) > 1.0, name


@pytest.mark.cuda
@pytest.mark.parametrize("Hq,Hkv", [(32, 8), (64, 8)])
def test_a_long_cache_on_the_card(Hq, Hkv):
    """B 1 over 131072 slots at head dim 128, G 4 (Mistral-NeMo-12B's
    context) and G 8: the scores of even 8 slices exceed a block's shared
    memory, so they go to the scratch; the plain version's values at both
    ends and in the middle, under a window too."""
    dev = _card()
    S_max = 131072
    q, k, v = _inputs(1, Hq, Hkv, 128, S_max, torch.bfloat16, dev, seed=Hq)
    splits, scratch = da._plan(1, Hkv, Hq // Hkv, S_max, 128, dev.index or 0)
    assert scratch > 0 and 1 <= splits <= 8
    for pos, window in ((0, None), (70000, None), (S_max - 1, None),
                        (S_max - 1, 4096)):
        got = ops.decode_attention(q, k, v, pos, window)
        want = da.plain(q, k, v, pos, window)
        torch.cuda.synchronize()
        _check(got, want, q, k, v, pos, window, f"pos {pos}")
        assert torch.equal(got, ops.decode_attention(q, k, v, pos, window))


@pytest.mark.cuda
def test_the_wrapper_refuses_on_the_card():
    dev = _card()
    bad, (q, k, v) = _refusals(dev)
    for name, (args, exc, match) in bad.items():
        with pytest.raises(exc, match=match):
            ops.decode_attention(*args)
    with pytest.raises(ValueError, match="0-d int64"):
        ops.decode_attention(q, k, v, torch.tensor(3))      # on the host
    flat = torch.empty(q.numel() + 8, dtype=q.dtype, device=dev)
    unaligned = flat[1:q.numel() + 1].view(q.shape)
    with pytest.raises(ValueError, match="16-byte"):
        ops.decode_attention(unaligned, k, v, 3)
