"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without an NVIDIA card: a
CUDA kernel has no CPU mode. The file imports only ``torch``, ``numpy``
and ``repro_torch`` (no JAX), so it also runs where the reference is not
installed::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: the GBDT kernel equals its plain version bit for bit. The
attention and scan kernels sum in another order than their plain versions:
2e-5 in fp32; in bf16 on the SIMT attention route one ulp of the output
(2**-7 relative), since both compute in fp32 and round once; on the wgmma
attention route ``2**-9 max|v|`` more, since the tensor cores take p in
bf16 (``repro_torch.kernels.flash_attention.tolerance`` derives it). fp32
matmuls run with TF32 off.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa, gbdt_predict as gp
from repro_torch.kernels import mamba_scan as ms, ops, ref

pytestmark = pytest.mark.cuda

F32 = dict(atol=2e-5, rtol=2e-5)
BF16_ULP = dict(atol=1e-6, rtol=2.0 ** -7)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _ensemble(seed, n, T, depth, F, device):
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(n, F)),
              rng.integers(0, F, size=(T, depth)).astype(np.int32),
              rng.normal(size=(T, depth)), rng.normal(size=(T, 2 ** depth)))
    return [torch.from_numpy(a).to(device) for a in arrays]


@pytest.mark.parametrize("n,T,depth,F", [
    (17, 9, 2, 5), (64, 64, 4, 23), (8, 130, 6, 8), (768, 400, 4, 23),
    (300, 50, 8, 23), (1, 1000, 3, 23), (5, 0, 4, 23), (129, 7, 0, 3),
    (64, 80, 3, 23),                        # the golden-trace predictor
    (33, 1000, 8, 23),                      # a 2.1 MB ensemble
    (1, 400, 4, 23), (4097, 400, 4, 23),    # a ragged last row group
    (50, 130, 5, 23), (40, 260, 4, 23),     # remainders; unbalanced combine
])
def test_kernel_equals_plain_version_bitwise(n, T, depth, F):
    dev = _card()
    args = _ensemble(9, n, T, depth, F, dev)
    before = gp.launches
    got = ops.gbdt_predict(*args, base=0.5)
    torch.cuda.synchronize()
    assert gp.launches == before + 1
    assert torch.equal(got, ref.gbdt_predict_ref(*args, base=0.5))
    cpu = ops.gbdt_predict(*[a.cpu() for a in args], base=0.5)
    assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("n,T,group", [
    (32768, 400, 1), (16384, 400, 8), (4096, 400, 16), (768, 400, 32),
    (33, 1000, 64), (9, 130, 16), (64, 80, 8),
])
def test_every_lane_group_width_gives_the_same_bits(n, T, group):
    """Chains keep their order whatever the group width the wrapper picks
    (one lane walking the row's blocks, 8 lanes taking turns through the
    chains, up to a group per chain); the batch sizes reach each width on
    an H100 SXM (132 SMs)."""
    dev = _card()
    X, feats, thr, leaves = _ensemble(3, n, T, 4, 23, dev)
    chains = ref.lane_schedule(T).chains
    assert gp.group_width(n, chains, gp.fill_lanes(X.device)) == group
    got = ops.gbdt_predict(X, feats, thr, leaves, base=0.5)
    want = ref.gbdt_predict_ref(X, feats, thr, leaves, base=0.5)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_out_of_range_feature_poisons_the_row():
    dev = _card()
    X, feats, thr, leaves = _ensemble(1, 3, 4, 2, 5, dev)
    feats[2, 1] = 7
    got = ops.gbdt_predict(X, feats, thr, leaves)
    torch.cuda.synchronize()
    assert torch.isnan(got).all()
    X, feats, thr, leaves = _ensemble(1, 5, 400, 4, 23, dev)
    feats[397, 0] = -1                      # a chain's last tree
    got = ops.gbdt_predict(X, feats, thr, leaves)
    torch.cuda.synchronize()
    assert torch.isnan(got).all()


def _qkv(seed, B, Sq, Hq, Hkv, hd, dtype, device, Sk=None):
    rng = np.random.default_rng(seed)
    Sk = Sk or Sq
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(device=device, dtype=dtype)
            for shape in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd),
                          (B, Sk, Hkv, hd))]


def _plain_attn(q, k, v, **kw):
    return ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2), **kw).transpose(1, 2)


def _attn_tol(q, v):
    """(atol, rtol) of the route that q's call takes."""
    which = fa.route(q.dtype, q.shape[-1], True)
    atol, rtol = fa.tolerance(which, q.dtype, v)
    return dict(atol=atol, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,kw", [
    ((1, 32, 4, 4, 16, None), {}), ((2, 64, 8, 2, 32, None), {}),
    ((1, 128, 15, 5, 64, None), {}), ((1, 48, 6, 1, 80, None), {}),
    ((2, 40, 4, 2, 128, None), {}), ((1, 300, 8, 2, 128, None), {}),
    ((1, 96, 4, 4, 32, None), {"window": 4}),
    ((1, 96, 4, 4, 32, None), {"window": 16}),
    ((1, 200, 4, 2, 64, None), {"window": 64}),
    ((2, 5, 4, 2, 16, 40), {"window": 8}),       # right-aligned queries
    ((1, 70, 4, 2, 16, 130), {}),
    ((1, 24, 2, 2, 16, 16), {}),                 # rows with no key
    ((1, 33, 4, 2, 16, None), {"causal": False}),
])
def test_flash_kernel_matches_plain_version(shape, kw, dtype):
    dev = _card()
    B, Sq, Hq, Hkv, hd, Sk = shape
    q, k, v = _qkv(1, B, Sq, Hq, Hkv, hd, dtype, dev, Sk=Sk)
    before = fa.launches
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    tol = _attn_tol(q, v)
    torch.testing.assert_close(got.float(), _plain_attn(q, k, v, **kw)
                               .float(), **tol)
    cpu = ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), **kw)
    torch.testing.assert_close(got.float().cpu(), cpu.float(), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("hd,misalign", [(20, False), (18, False),
                                         (64, True)])
def test_flash_kernel_scalar_staging(hd, misalign, dtype):
    """Head dims that are not a multiple of 16 bytes, and tensors that do
    not start on a 16-byte boundary, take the kernel's scalar staging."""
    dev = _card()
    q, k, v = _qkv(2, 2, 70, 4, 2, hd, dtype, dev)
    if misalign:  # the same values, one element past an aligned base
        q, k, v = (torch.cat([t.new_zeros(1), t.flatten()])[1:].view(t.shape)
                   for t in (q, k, v))
        assert q.data_ptr() % 16 and q.is_contiguous()
    before = fa.route_launches["simt"]
    got = ops.flash_attention(q, k, v, window=24)
    assert fa.route_launches["simt"] == before + 1
    tol = F32 if dtype == torch.float32 else BF16_ULP
    torch.testing.assert_close(got.float(), _plain_attn(q, k, v, window=24)
                               .float(), **tol)


#: (B, Sq, Hq, Hkv, hd, Sk), options: the shapes of chip_smoke.py's
#: ATTN_SWEEP that the wgmma route takes, at every head dim it has an
#: instance for, and the serving shape
WGMMA_SWEEP = [
    ((1, 32, 4, 4, 16, None), {}), ((2, 64, 8, 2, 32, None), {}),
    ((1, 128, 15, 5, 64, None), {}), ((1, 48, 6, 1, 80, None), {}),
    ((2, 40, 4, 2, 128, None), {}), ((1, 300, 8, 2, 96, None), {}),
    ((1, 96, 4, 4, 32, None), {"window": 4}),
    ((1, 96, 4, 4, 32, None), {"window": 16}),
    ((1, 96, 4, 4, 32, None), {"window": 64}),
    ((1, 400, 8, 2, 128, None), {"window": 130}),
    ((2, 5, 4, 2, 16, 40), {"window": 8}),       # right-aligned queries
    ((1, 70, 4, 2, 64, 300), {}),
    ((1, 33, 4, 2, 112, None), {"causal": False}),
    ((1, 200, 6, 3, 48, 150), {"causal": False, "window": 32}),
    ((4, 2048, 32, 8, 128, None), {}),           # the serving shape
]


@pytest.mark.parametrize("shape,kw", WGMMA_SWEEP)
def test_wgmma_route_matches_plain_version(shape, kw):
    dev = _card()
    B, Sq, Hq, Hkv, hd, Sk = shape
    q, k, v = _qkv(4, B, Sq, Hq, Hkv, hd, torch.bfloat16, dev, Sk=Sk)
    before = dict(fa.route_launches)
    got = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.route_launches["wgmma"] == before["wgmma"] + 1
    assert fa.route_launches["simt"] == before["simt"]
    torch.testing.assert_close(got.float(), _plain_attn(q, k, v, **kw)
                               .float(), **_attn_tol(q, v))


def test_wgmma_route_rows_without_a_key_are_zero():
    """Sq > Sk, causal: the first Sq - Sk rows sit before every key."""
    dev = _card()
    q, k, v = _qkv(5, 2, 200, 4, 2, 128, torch.bfloat16, dev, Sk=60)
    before = fa.route_launches["wgmma"]
    got = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert fa.route_launches["wgmma"] == before + 1
    assert bool((got[:, :140] == 0).all())
    assert bool(torch.isfinite(got).all()) and bool((got[:, 140:] != 0)
                                                    .any())
    torch.testing.assert_close(got.float(), _plain_attn(q, k, v).float(),
                               **_attn_tol(q, v))


def test_route_counters_split_the_launches():
    dev = _card()
    bf = _qkv(6, 1, 64, 4, 2, 64, torch.bfloat16, dev)
    f32 = _qkv(6, 1, 64, 4, 2, 64, torch.float32, dev)
    odd = _qkv(6, 1, 64, 4, 2, 20, torch.bfloat16, dev)
    total, by = fa.launches, dict(fa.route_launches)
    for args in (bf, f32, odd, bf):
        ops.flash_attention(*args)
    torch.cuda.synchronize()
    assert fa.route_launches["wgmma"] - by["wgmma"] == 2
    assert fa.route_launches["simt"] - by["simt"] == 2
    assert fa.launches - total == 4


def _scan(seed, B, L, Di, N, device):
    rng = np.random.default_rng(seed)
    sp = np.log1p(np.exp(rng.normal(size=(B, L, Di))))
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in (
        rng.normal(size=(B, L, Di)), sp * 0.1,
        -np.exp(rng.normal(size=(Di, N)) * 0.3),
        rng.normal(size=(B, L, N)), rng.normal(size=(B, L, N)),
        np.linspace(0.5, 1.5, Di))]


@pytest.mark.parametrize("shape", [
    (1, 16, 8, 4), (2, 64, 32, 16), (1, 40, 24, 8), (2, 33, 20, 8),
    (3, 100, 130, 16), (1, 7, 64, 64), (2, 64, 16, 1), (1, 300, 8, 5),
    # ragged against the kernel's 64-channel blocks and 32-step chunks,
    # on the 16-byte (Di % 4 == 0) and the 4-byte copy paths
    (2, 77, 70, 32), (1, 33, 4100, 16), (3, 95, 66, 64), (1, 65, 97, 8),
    (2, 31, 200, 3), (1, 129, 8196, 16),
])
def test_scan_kernel_matches_plain_version(shape):
    dev = _card()
    args = _scan(2, *shape, dev)
    before = ms.launches
    y, h = ops.mamba_scan(*args)
    torch.cuda.synchronize()
    assert ms.launches == before + 1
    want_y, want_h = ref.mamba_scan_ref(*args)
    torch.testing.assert_close(y, want_y, **F32)
    torch.testing.assert_close(h, want_h, **F32)


def test_scan_kernel_state_decays_with_negative_A():
    dev = _card()
    B, L, Di, N = 1, 64, 8, 4
    u = torch.zeros(B, L, Di, device=dev)
    u[:, 0] = 1.0
    ones = torch.ones(B, L, N, device=dev)
    y, _ = ops.mamba_scan(u, torch.full((B, L, Di), 0.5, device=dev),
                          -2.0 * torch.ones(Di, N, device=dev), ones, ones,
                          torch.zeros(Di, device=dev))
    mags = y[0, :, 0].abs().cpu()
    assert mags[1] < mags[0] and mags[30] < 1e-3


def test_wrappers_refuse_mixed_devices_and_grad_on_the_card():
    dev = _card()
    q, k, v = _qkv(3, 1, 8, 4, 2, 16, torch.float32, dev)
    with pytest.raises(ValueError, match="is on cpu"):
        ops.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="forward-only"):
        ops.flash_attention(q.requires_grad_(), k, v)
    args = _scan(4, 1, 8, 8, 4, dev)
    args[0] = args[0].bfloat16()
    with pytest.raises(TypeError, match="u must be"):
        ops.mamba_scan(*args)


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "falcon-mamba-7b"])
def test_reduced_model_serves_alike_on_card_and_cpu(arch):
    """A reduced model on the card (through both kernels) against the same
    weights on the CPU (through their plain versions): logits within 1e-4,
    the same greedy tokens."""
    dev = _card()
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.convert import model_arrays, model_from_arrays
    from repro_torch.models import model
    from repro_torch.train import serve
    cfg = reduce_for_smoke(get_config(arch))
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    cpu = model_from_arrays(cfg, model_arrays(params), device="cpu")
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 40))
    a = model.forward(cfg, params, tokens, device=dev)[0]
    b = model.forward(cfg, cpu, tokens, device="cpu")[0]
    torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)
    before = (fa.launches, ms.launches)
    ga = serve.greedy_generate(cfg, params, tokens, 5, 48, device=dev)
    gb = serve.greedy_generate(cfg, cpu, tokens, 5, 48, device="cpu")
    assert torch.equal(ga.cpu(), gb)
    assert (fa.launches, ms.launches) != before
