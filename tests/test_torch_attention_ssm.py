"""The port's attention and selective-scan kernels, and the blocks that call
them, against the reference on the CPU.

On CPU tensors ``repro_torch.kernels.ops.flash_attention`` and
``ops.mamba_scan`` run the kernels' plain PyTorch versions. Inputs are made
with numpy from a seed and fed to both packages. The reference runs its
Pallas kernels in interpret mode, as ``tests/test_kernels.py`` runs them,
and its jnp oracles. Tolerances:

* fp32: 2e-5 absolute and relative — the reference's own sweep tolerance;
  both sides compute in fp32 and differ only in summation order.
* bf16 against the reference kernel: 2**-7 relative (plus 1e-6 absolute
  for values near 0) — both compute in fp32 and round once to bf16, so
  they differ by at most one bf16 ulp, which is 2**-8 to 2**-7 of |x|.
* bf16 against the oracle: 3e-2, the reference's own (its softmax rounds
  elsewhere).

The CUDA kernels themselves only run on a card: ``tests/test_torch_cuda.py``
holds them to these plain versions there.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # not installed in this container — deterministic shim
    from _hypothesis_fallback import given, settings, strategies as st

from repro.configs import get_config as ref_config
from repro.configs.base import reduce_for_smoke as ref_reduce
from repro.kernels import ops as jax_ops, ref as jax_ref
from repro.models import attention as ref_attn, mlp as ref_mlp
from repro.models import ssm as ref_ssm
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import flash_attention as fa, mamba_scan as ms
from repro_torch.kernels import mamba2_scan as m2
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn, mlp, ssm

F32 = dict(atol=2e-5, rtol=2e-5)
BF16_ULP = dict(atol=1e-6, rtol=2.0 ** -7)
BF16_ORACLE = dict(atol=3e-2, rtol=3e-2)
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, dtype=np.float32)


# ---------------------------------------------------------------------- #
#  K2: flash attention
# ---------------------------------------------------------------------- #
def _qkv(seed, B, Sq, Hq, Hkv, hd, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = Sk or Sq
    return (rng.normal(size=(B, Sq, Hq, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, Hkv, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, Hkv, hd)).astype(np.float32))


def _port_attn(q, k, v, dtype="float32", **kw):
    t = [torch.from_numpy(a).to(_DT[dtype][1]) for a in (q, k, v)]
    return ops.flash_attention(*t, **kw)


def _ref_kernel(q, k, v, dtype="float32", **kw):
    return jax_ops.flash_attention(*(jnp.asarray(a, _DT[dtype][0])
                                     for a in (q, k, v)), **kw)


def _ref_oracle(q, k, v, dtype="float32", **kw):
    q, k, v = (jnp.swapaxes(jnp.asarray(a, _DT[dtype][0]), 1, 2)
               for a in (q, k, v))
    return jnp.swapaxes(jax_ref.flash_attention_ref(q, k, v, **kw), 1, 2)


@pytest.mark.parametrize("shape", [
    # (B, S, Hq, Hkv, hd): GQA ratios and head dims of the model zoo
    (1, 32, 4, 4, 16),     # MHA
    (2, 64, 8, 2, 32),     # GQA 4:1
    (1, 128, 15, 5, 64),   # smollm ratios
    (1, 48, 6, 1, 80),     # MQA, stablelm head dim
    (2, 40, 4, 2, 128),    # ragged S
    (1, 130, 8, 2, 128),   # Mistral-NeMo's ratio and head dim, ragged S
])
def test_flash_shapes_causal(shape):
    B, S, Hq, Hkv, hd = shape
    q, k, v = _qkv(0, B, S, Hq, Hkv, hd)
    got = _np(_port_attn(q, k, v, causal=True))
    np.testing.assert_allclose(got, _np(_ref_kernel(q, k, v, causal=True)),
                               **F32)
    np.testing.assert_allclose(got, _np(_ref_oracle(q, k, v, causal=True)),
                               **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_dtypes(dtype):
    q, k, v = _qkv(1, 2, 64, 8, 4, 32)
    out = _port_attn(q, k, v, dtype, causal=True)
    assert out.dtype == _DT[dtype][1]
    tol = F32 if dtype == "float32" else BF16_ULP
    np.testing.assert_allclose(_np(out), _np(_ref_kernel(q, k, v, dtype)),
                               **tol)
    tol = F32 if dtype == "float32" else BF16_ORACLE
    np.testing.assert_allclose(_np(out), _np(_ref_oracle(q, k, v, dtype)),
                               **tol)


@pytest.mark.parametrize("window", [4, 16, 64])
def test_flash_sliding_window(window):
    q, k, v = _qkv(2, 1, 96, 4, 4, 32)
    got = _np(_port_attn(q, k, v, window=window))
    np.testing.assert_allclose(got, _np(_ref_kernel(q, k, v, window=window)),
                               **F32)
    np.testing.assert_allclose(got, _np(_ref_oracle(q, k, v, window=window)),
                               **F32)


@pytest.mark.parametrize("bq,bk", [(32, 32), (64, 128), (16, 64)])
def test_flash_matches_reference_at_every_block_size(bq, bk):
    q, k, v = _qkv(3, 1, 128, 4, 2, 32)
    np.testing.assert_allclose(_np(_port_attn(q, k, v)),
                               _np(_ref_kernel(q, k, v, bq=bq, bk=bk)),
                               **F32)


@pytest.mark.parametrize("Sq,Sk,window", [(5, 40, None), (5, 40, 8),
                                          (33, 70, 16), (1, 17, None)])
def test_flash_right_aligned_queries(Sq, Sk, window):
    """Sq < Sk: query i sits at position i + Sk - Sq, and the window is
    measured from that shifted position."""
    q, k, v = _qkv(4, 2, Sq, 4, 2, 16, Sk=Sk)
    np.testing.assert_allclose(
        _np(_port_attn(q, k, v, window=window)),
        _np(_ref_oracle(q, k, v, window=window)), **F32)


def test_flash_rows_without_a_key_are_zero():
    """Sq > Sk: the first Sq - Sk rows sit before every key. The flash
    arithmetic (masked p zeroed, l clamped at 1e-30) gives them 0; every
    other row is the oracle's softmax."""
    Sq, Sk = 24, 16
    q, k, v = _qkv(5, 1, Sq, 2, 2, 16, Sk=Sk)
    got = _np(_port_attn(q, k, v))
    assert np.all(got[:, :Sq - Sk] == 0.0)
    np.testing.assert_allclose(got[:, Sq - Sk:],
                               _np(_ref_oracle(q, k, v))[:, Sq - Sk:], **F32)


@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 1000), S=st.sampled_from([16, 33, 80]),
       ratio=st.sampled_from([1, 2, 4]))
def test_flash_property_matches_oracle(seed, S, ratio):
    q, k, v = _qkv(seed, 1, S, 2 * ratio, 2, 16)
    np.testing.assert_allclose(_np(_port_attn(q, k, v)),
                               _np(_ref_oracle(q, k, v)),
                               atol=3e-5, rtol=3e-5)


def test_flash_rows_are_convex_combinations():
    q, k, v = _qkv(6, 2, 32, 4, 4, 16)
    assert np.abs(_np(_port_attn(q, k, v))).max() <= np.abs(v).max() + 1e-5


def test_flash_wrapper_is_the_plain_version_on_cpu():
    q, k, v = (torch.from_numpy(a) for a in _qkv(7, 2, 20, 6, 2, 24))
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), window=5)
    got = ops.flash_attention(q, k, v, window=5)
    assert got.is_contiguous()
    assert torch.equal(got, want.transpose(1, 2))


# ---------------------------------------------------------------------- #
#  K3: Mamba-1 selective scan
# ---------------------------------------------------------------------- #
def _scan_inputs(seed, B, L, Di, N):
    rng = np.random.default_rng(seed)
    sp = np.log1p(np.exp(rng.normal(size=(B, L, Di))))        # softplus
    return [a.astype(np.float32) for a in (
        rng.normal(size=(B, L, Di)), sp * 0.1,
        -np.exp(rng.normal(size=(Di, N)) * 0.3),
        rng.normal(size=(B, L, N)), rng.normal(size=(B, L, N)),
        np.linspace(0.5, 1.5, Di))]


def _port_scan(args):
    return ops.mamba_scan(*(torch.from_numpy(a) for a in args))


@pytest.mark.parametrize("shape", [
    (1, 16, 8, 4), (2, 64, 32, 16), (1, 40, 24, 8),   # ragged L
    (2, 33, 20, 8),                                   # ragged L and Di
])
def test_scan_shapes(shape):
    args = _scan_inputs(0, *shape)
    y, h = _port_scan(args)
    yk, hk = jax_ops.mamba_scan(*map(jnp.asarray, args), chunk=16, bd=8)
    yo, ho = jax_ref.mamba_scan_ref(*map(jnp.asarray, args))
    for got, want in ((y, yk), (h, hk), (y, yo), (h, ho)):
        np.testing.assert_allclose(_np(got), _np(want), **F32)


@pytest.mark.parametrize("chunk,bd", [(8, 16), (64, 8), (16, 16)])
def test_scan_matches_reference_at_every_chunk(chunk, bd):
    args = _scan_inputs(1, 1, 64, 16, 8)
    y, _ = _port_scan(args)
    yk, _ = jax_ops.mamba_scan(*map(jnp.asarray, args), chunk=chunk, bd=bd)
    np.testing.assert_allclose(_np(y), _np(yk), **F32)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 1000), L=st.sampled_from([8, 24, 48]))
def test_scan_property_matches_oracle(seed, L):
    args = _scan_inputs(seed, 1, L, 8, 4)
    y, h = _port_scan(args)
    yo, ho = jax_ref.mamba_scan_ref(*map(jnp.asarray, args))
    np.testing.assert_allclose(_np(y), _np(yo), **F32)
    np.testing.assert_allclose(_np(h), _np(ho), **F32)


def test_scan_state_decays_with_negative_A():
    B, L, Di, N = 1, 64, 8, 4
    u = torch.zeros(B, L, Di)
    u[:, 0] = 1.0
    y, _ = ops.mamba_scan(u, torch.full((B, L, Di), 0.5),
                          -torch.ones(Di, N) * 2.0, torch.ones(B, L, N),
                          torch.ones(B, L, N), torch.zeros(Di))
    mags = y[0, :, 0].abs()
    assert mags[1] < mags[0] and mags[30] < 1e-3


def test_scan_h_last_hands_over_to_a_continued_scan():
    """The state after L steps, fed back as h0, continues the scan: the
    prefill → decode hand-off."""
    u, dt, A, Bm, Cm, D = (torch.from_numpy(a)
                           for a in _scan_inputs(2, 2, 30, 12, 8))
    y, _ = ref.mamba_scan_ref(u, dt, A, Bm, Cm, D)
    _, h = ops.mamba_scan(*(t[:, :20].contiguous() for t in (u, dt)), A,
                          *(t[:, :20].contiguous() for t in (Bm, Cm)), D)
    y2, _ = ref.mamba_scan_ref(u[:, 20:], dt[:, 20:], A, Bm[:, 20:],
                               Cm[:, 20:], D, h0=h)
    torch.testing.assert_close(y2, y[:, 20:], **F32)


# ---------------------------------------------------------------------- #
#  The blocks that call them, with the reference's "flash" route
# ---------------------------------------------------------------------- #
def _configs(arch):
    rcfg = dataclasses.replace(ref_reduce(ref_config(arch)),
                               attn_impl="flash")
    return rcfg, ModelConfig(**dataclasses.asdict(rcfg))


@torch.no_grad()
def _load(module, tree):
    for name, arr in tree.items():
        getattr(module, name).copy_(torch.tensor(np.asarray(arr)))
    return module


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "qwen2.5-14b",
                                  "mixtral-8x22b"])
def test_attention_matches_reference_flash_route(arch):
    """GQA; QKV bias (Qwen); sliding window 8 over 16 tokens (Mixtral)."""
    rcfg, cfg = _configs(arch)
    p = ref_attn.init_attention(jax.random.PRNGKey(0), rcfg)
    if rcfg.qkv_bias:  # nonzero biases, so the bias path shows
        p = {**p, **{b: p[b] + 0.1 for b in ("bq", "bk", "bv")}}
    x = np.random.default_rng(1).normal(size=(2, 16, rcfg.d_model)).astype(
        np.float32)
    want, (wk, wv) = ref_attn.attention(p, jnp.asarray(x), rcfg)
    mod = _load(attn.Attention(cfg, "cpu"), p)
    got, (k, v) = attn.attention(mod, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(k), _np(wk), **F32)
    np.testing.assert_allclose(_np(v), _np(wv), **F32)


@pytest.mark.parametrize("arch,S_max,pos", [
    ("mistral-nemo-12b", 16, 9),      # linear cache
    ("mixtral-8x22b", 8, 5),          # ring (window 8), warming up
    ("mixtral-8x22b", 8, 13),         # ring, wrapped
])
def test_attention_decode_matches_reference(arch, S_max, pos):
    rcfg, cfg = _configs(arch)
    p = ref_attn.init_attention(jax.random.PRNGKey(2), rcfg)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 1, rcfg.d_model)).astype(np.float32)
    shape = (2, rcfg.n_kv_heads, S_max, rcfg.resolved_head_dim)
    ck, cv = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    want, wk, wv = ref_attn.attention_decode(
        p, jnp.asarray(x), jnp.asarray(ck), jnp.asarray(cv), jnp.int32(pos),
        rcfg)
    mod = _load(attn.Attention(cfg, "cpu"), p)
    got, k, v = attn.attention_decode(mod, torch.from_numpy(x),
                                      torch.from_numpy(ck),
                                      torch.from_numpy(cv), pos, cfg)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(k), _np(wk), **F32)
    np.testing.assert_allclose(_np(v), _np(wv), **F32)


@pytest.mark.parametrize("gelu", [False, True], ids=["swiglu", "gelu"])
def test_mlp_matches_reference(gelu):
    rcfg, cfg = _configs("mistral-nemo-12b")
    p = ref_mlp.init_mlp(jax.random.PRNGKey(5), rcfg, gelu=gelu)
    x = np.random.default_rng(6).normal(size=(2, 5, rcfg.d_model)).astype(
        np.float32)
    mod = _load(mlp.MLP(cfg, "cpu", gelu=gelu), p)
    np.testing.assert_allclose(_np(mlp.mlp(mod, torch.from_numpy(x))),
                               _np(ref_mlp.mlp(p, jnp.asarray(x))),
                               atol=1e-4, rtol=1e-4)


def test_causal_mask_matches_reference():
    for args in ((6, 6, None, 0), (4, 9, 3, 5), (7, 7, 2, 0)):
        np.testing.assert_array_equal(
            attn.causal_mask(*args).numpy(),
            np.asarray(ref_attn.causal_mask(*args)))


@pytest.mark.parametrize("L", [16, 1])
def test_mamba1_block_matches_reference_flash_route(L):
    """L = 16 takes the scan kernel's route in both packages; L = 1 the
    plain recurrence."""
    rcfg, cfg = _configs("falcon-mamba-7b")
    p = ref_ssm.init_mamba(jax.random.PRNGKey(0), rcfg)
    x = np.random.default_rng(1).normal(size=(2, L, rcfg.d_model)).astype(
        np.float32)
    want, wst = ref_ssm.mamba1_block(p, jnp.asarray(x), rcfg)
    mod = _load(ssm.Mamba1(cfg, "cpu"), p)
    got, st = ssm.mamba1_block(mod, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(st["conv"]), _np(wst["conv"]), **F32)
    np.testing.assert_allclose(_np(st["ssm"]), _np(wst["ssm"]), **F32)


def test_mamba1_block_decode_step_matches_reference():
    rcfg, cfg = _configs("falcon-mamba-7b")
    p = ref_ssm.init_mamba(jax.random.PRNGKey(4), rcfg)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 1, rcfg.d_model)).astype(np.float32)
    conv = rng.normal(size=(2, rcfg.ssm_conv - 1, rcfg.d_inner)).astype(
        np.float32)
    h0 = rng.normal(size=(2, rcfg.d_inner, rcfg.ssm_state)).astype(
        np.float32)
    want, wst = ref_ssm.mamba1_block(
        p, jnp.asarray(x), rcfg,
        state={"conv": jnp.asarray(conv), "ssm": jnp.asarray(h0)})
    mod = _load(ssm.Mamba1(cfg, "cpu"), p)
    got, st = ssm.mamba1_block(
        mod, torch.from_numpy(x), cfg,
        state={"conv": torch.from_numpy(conv), "ssm": torch.from_numpy(h0)})
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(_np(st["ssm"]), _np(wst["ssm"]), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba1_scan_streams_like_the_reference(dtype):
    """The decode route streams u, dt, B, C in the activation dtype and
    rounds each step's y to it."""
    u, dt, A, Bm, Cm, D = _scan_inputs(6, 2, 12, 16, 8)
    jd, td = _DT[dtype]
    want, wh = ref_ssm.mamba1_scan(jnp.asarray(u, jd), jnp.asarray(dt),
                                   jnp.asarray(A), jnp.asarray(Bm, jd),
                                   jnp.asarray(Cm, jd), jnp.asarray(D))
    got, h = ssm.mamba1_scan(torch.from_numpy(u).to(td), torch.from_numpy(dt),
                             torch.from_numpy(A), torch.from_numpy(Bm).to(td),
                             torch.from_numpy(Cm).to(td), torch.from_numpy(D))
    tol = F32 if dtype == "float32" else BF16_ULP
    np.testing.assert_allclose(_np(got), _np(want), **tol)
    np.testing.assert_allclose(_np(h), _np(wh), **F32)


# ---------------------------------------------------------------------- #
#  The wrappers' checks (the same on every device)
# ---------------------------------------------------------------------- #
def _good_attn():
    q, k, v = _qkv(8, 1, 8, 4, 2, 16)
    return dict(q=torch.from_numpy(q), k=torch.from_numpy(k),
                v=torch.from_numpy(v))


@pytest.mark.parametrize("change,err,match", [
    (lambda a: a.update(q=a["q"].half()), TypeError, "float32 or"),
    (lambda a: a.update(k=a["k"].bfloat16()), TypeError, "k must be"),
    (lambda a: a.update(v=a["v"].numpy()), TypeError, "v must be a torch"),
    (lambda a: a.update(q=a["q"][0]), ValueError, "4-D"),
    (lambda a: a.update(q=a["q"].transpose(1, 2)), ValueError, "contiguous"),
    (lambda a: a.update(k=a["k"].to("meta")), ValueError, "is on meta"),
    (lambda a: a.update(q=a["q"].to("meta")), ValueError,
     "unsupported device"),
    (lambda a: a.update(v=a["v"][:, :4].contiguous()), ValueError,
     "v shape"),
    (lambda a: a.update(q=torch.zeros(1, 8, 3, 16)), ValueError,
     "not a multiple"),
    (lambda a: a.update(q=torch.zeros(1, 8, 4, 144),
                        k=torch.zeros(1, 8, 2, 144),
                        v=torch.zeros(1, 8, 2, 144)), ValueError,
     "exceeds the kernel's maximum of 128"),
    (lambda a: a.update(q=a["q"].requires_grad_()), ValueError,
     "forward-only"),
    (lambda a: a.update(window=0), ValueError, "positive int"),
    (lambda a: a.update(q=torch.zeros(1, 0, 4, 16)), ValueError, "Sq must"),
], ids=["q-dtype", "k-dtype", "not-a-tensor", "q-ndim", "q-strided",
        "mixed-devices", "q-device", "v-shape", "gqa-ratio", "head-dim",
        "requires-grad", "window-0", "empty"])
def test_flash_wrapper_refusals(change, err, match):
    args = _good_attn()
    change(args)
    with pytest.raises(err, match=match):
        ops.flash_attention(**args)


def _good_scan():
    names = ("u", "dt", "A", "Bm", "Cm", "D")
    return {n: torch.from_numpy(a)
            for n, a in zip(names, _scan_inputs(9, 2, 6, 8, 4))}


@pytest.mark.parametrize("change,err,match", [
    (lambda a: a.update(u=a["u"].bfloat16()), TypeError, "u must be"),
    (lambda a: a.update(D=a["D"].double()), TypeError, "D must be"),
    (lambda a: a.update(dt=a["dt"][:, :3].contiguous()), ValueError,
     "dt shape"),
    (lambda a: a.update(A=torch.zeros(8, 65), Bm=torch.zeros(2, 6, 65),
                        Cm=torch.zeros(2, 6, 65)), ValueError,
     "exceeds the kernel's maximum of 64"),
    (lambda a: a.update(Bm=a["Bm"].transpose(0, 1)), ValueError,
     "contiguous"),
    (lambda a: a.update(A=a["A"].requires_grad_()), ValueError,
     "forward-only"),
    (lambda a: a.update(u=a["u"][:, :0], dt=a["dt"][:, :0],
                        Bm=a["Bm"][:, :0], Cm=a["Cm"][:, :0]),
     ValueError, "L must"),
], ids=["u-dtype", "D-dtype", "dt-shape", "state-65", "B-strided",
        "requires-grad", "empty"])
def test_scan_wrapper_refusals(change, err, match):
    args = _good_scan()
    change(args)
    with pytest.raises(err, match=match):
        ops.mamba_scan(**args)


def test_cpu_never_launches_the_kernels():
    before = (fa.launches, ms.launches, m2.launches)
    _port_attn(*_qkv(10, 1, 20, 4, 2, 16))
    _port_scan(_scan_inputs(10, 1, 10, 8, 4))
    u, dt, A, Bm, Cm, D = (torch.from_numpy(a) for a in
                           _scan_inputs(10, 1, 10, 8, 4))
    ops.mamba2_scan(u.unflatten(-1, (2, 4)), dt[..., :2].contiguous(),
                    A[:2, 0].contiguous(), Bm[:, :, None], Cm[:, :, None],
                    D[:2].contiguous())
    assert (fa.launches, ms.launches, m2.launches) == before
    if not torch.cuda.is_available():
        assert before == (0, 0, 0)
