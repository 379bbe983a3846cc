"""The port's CUDA kernels on the card, against their plain versions.

Every test here is marked ``cuda`` and skips without an NVIDIA card: a
CUDA kernel has no CPU mode. The file imports only ``torch``, ``numpy``
and ``repro_torch`` (no JAX), so it also runs where the reference is not
installed::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Training on the card (the differentiable ``impl="xla"`` route, no
kernel): every reduced architecture's train step against the CPU's from
the same weights and batch (loss, ce, aux and grad_norm 1e-5 relative;
every grad leaf within 1e-4 of its max |g|; new params within 2 lr and
within 1e-5 on 99.9 % of the entries), and a restarted run equal to the
clean one bit for bit with deterministic algorithms on (which needs
``CUBLAS_WORKSPACE_CONFIG``, set here before CUDA starts).

Tolerances: the GBDT kernel equals its plain version bit for bit. The
attention and scan kernels sum in another order than their plain versions:
2e-5 in fp32; in bf16 on the SIMT attention route one ulp of the output
(2**-7 relative), since both compute in fp32 and round once; on the wgmma
attention route ``2**-9 max|v|`` more, since the tensor cores take p in
bf16 (``repro_torch.kernels.flash_attention.tolerance`` derives it). fp32
matmuls run with TF32 off.
"""
from __future__ import annotations

import copy
import os

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS
from repro_torch.kernels import flash_attention as fa, gbdt_predict as gp
from repro_torch.kernels import mamba2_scan as m2, mamba_scan as ms, ops, ref

pytestmark = pytest.mark.cuda
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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


#: the shapes the MoE, hybrid, audio and VLM families give the attention
#: kernel at serving size (chip_smoke.py's FAMILY_ATTN): Whisper's
#: bidirectional encoder over its 1500 frames, its decoder's
#: cross-attention and causal self-attention, Zamba2 (32/32 heads, hd 112),
#: Kimi-K2 (64/8, hd 112) and InternVL2 (64/8, hd 128) with 8 query heads
#: per KV head, Mixtral's window of 4096 at 6144 tokens
FAMILY_ATTN = [
    ((4, 1500, 20, 20, 64, None), {"causal": False}),
    ((4, 64, 20, 20, 64, 1500), {"causal": False}),
    ((4, 64, 20, 20, 64, None), {}),
    ((4, 2048, 32, 32, 112, None), {}),
    ((4, 2048, 64, 8, 112, None), {}),
    ((4, 2048, 64, 8, 128, None), {}),
    ((2, 6144, 48, 8, 128, None), {"window": 4096}),
]


@pytest.mark.parametrize("shape,kw", FAMILY_ATTN)
def test_wgmma_route_at_the_families_serving_shapes(shape, kw):
    test_wgmma_route_matches_plain_version(shape, kw)


#: head dims above 128, which pad to the 256-column variant with 64-key
#: tiles: 144, 224 (Zamba2-7B's shared attention) and 256, causal and
#: not, ragged against the 128-row query tile and the 64-key tile, with
#: right-aligned queries, a window and GQA; then Zamba2-7B's prefill shape
WGMMA_WIDE = [
    ((1, 70, 4, 2, 144, None), {}),
    ((2, 130, 4, 4, 144, None), {"causal": False}),
    ((1, 200, 6, 3, 224, None), {}),
    ((2, 97, 4, 4, 224, None), {"causal": False}),
    ((1, 33, 4, 2, 224, 161), {}),               # right-aligned queries
    ((1, 300, 4, 4, 224, None), {"window": 100}),
    ((1, 77, 4, 1, 256, None), {}),
    ((2, 129, 2, 2, 256, 65), {"causal": False}),
    ((1, 4096, 32, 32, 224, None), {}),          # Zamba2-7B's prefill
]


@pytest.mark.parametrize("shape,kw", WGMMA_WIDE)
def test_wgmma_route_above_head_dim_128(shape, kw):
    test_wgmma_route_matches_plain_version(shape, kw)


def test_unaligned_head_dim_224_raises():
    """bf16 at head dim 224 on a tensor off a 16-byte boundary would take
    the SIMT route, which stops at 128: it raises, launching nothing."""
    dev = _card()
    q, k, v = _qkv(8, 1, 40, 4, 2, 224, torch.bfloat16, dev)
    q = torch.cat([q.new_zeros(1), q.flatten()])[1:].view(q.shape)
    before = fa.launches
    with pytest.raises(ValueError, match="SIMT route stops at 128"):
        ops.flash_attention(q, k, v)
    assert fa.launches == before


def test_scan_kernel_at_the_hybrid_serving_shape():
    """Zamba2-7B's Mamba-2 prefill as a Mamba-1 scan: 7168 channels, 64
    states; each head's A repeated over its 64 channels, as the block
    passes it."""
    dev = _card()
    args = _scan(7, 4, 2048, 7168, 64, dev)
    args[2] = args[2][::64].repeat_interleave(64, dim=0)[:, :1].expand(
        7168, 64).contiguous()
    y, h = ops.mamba_scan(*args)
    want_y, want_h = ref.mamba_scan_ref(*args)
    torch.testing.assert_close(y, want_y, **F32)
    torch.testing.assert_close(h, want_h, **F32)


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


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "kimi-k2-1t-a32b",
                                  "zamba2-7b", "whisper-large-v3",
                                  "internvl2-76b"])
def test_reduced_family_serves_alike_on_card_and_cpu(arch):
    """The MoE, hybrid, audio and VLM families, reduced, on the card and
    on the CPU from the same weights and stub inputs: logits within 1e-4,
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
    extra = model.extra_inputs(cfg, 2, 40, "prefill",
                               torch.Generator().manual_seed(1), device="cpu")
    on_card = {k: v.to(dev) for k, v in extra.items()}
    a, aux_a = model.forward(cfg, params, tokens, on_card, device=dev)
    b, aux_b = model.forward(cfg, cpu, tokens, extra, device="cpu")
    torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(aux_a.cpu(), aux_b, atol=1e-4, rtol=1e-4)
    before = (fa.launches, m2.launches)
    max_seq = 48 + (cfg.vision_tokens if cfg.family == "vlm" else 0)
    ga = serve.greedy_generate(cfg, params, tokens, 5, max_seq,
                               extra=on_card, device=dev)
    gb = serve.greedy_generate(cfg, cpu, tokens, 5, max_seq, extra=extra,
                               device="cpu")
    assert torch.equal(ga.cpu(), gb)
    assert fa.launches > before[0]
    # the hybrid's Mamba-2 prompts run the Mamba-2 scan kernel
    assert (m2.launches > before[1]) == (cfg.family == "hybrid")


@pytest.mark.parametrize("n", [1, 24, 64])
def test_corrector_ensemble_equals_plain_version_bitwise(n):
    """The online GBDT corrector's ensemble (30 trees of depth 2 over the
    clock basis ``[1, s_core, s_mem]``, fitted as ``GBDTCorrector`` fits)
    at its batches: the one-row innovation, a v5lite ladder, a v5e ladder.
    The kernel equals its plain version, the CPU model and host numpy bit
    for bit, and the launch is counted under its row count."""
    dev = _card()
    from repro_torch.core import V5E_DVFS
    from repro_torch.core.gbdt import GBDTParams, fit_gbdt
    from repro_torch.core.online import clock_basis
    rng = np.random.default_rng(4)
    clocks = V5E_DVFS.clock_list()
    Z = np.stack([clock_basis(clocks[int(i)])
                  for i in rng.integers(0, len(clocks), 80)])
    y = rng.normal(0.0, 0.1, 80) + 0.3 * Z[:, 1] - 0.2 * Z[:, 2]
    params = GBDTParams(iterations=30, depth=2, learning_rate=0.2,
                        n_bins=16)
    model = fit_gbdt(Z, y, params, device=dev)
    assert model.feats.shape == (30, 2)
    Zn = np.stack([clock_basis(c) for c in clocks[-n:]])
    before = gp.rows_launches.get(n, 0)
    got = model.predict(Zn)
    assert gp.rows_launches.get(n, 0) == before + 1
    tabs = model.device_tables()
    want = ref.gbdt_predict_ref(torch.from_numpy(Zn).to(dev), *tabs,
                                model.base)
    np.testing.assert_array_equal(got, want.cpu().numpy())
    np.testing.assert_array_equal(
        got, fit_gbdt(Z, y, params, device="cpu").predict(Zn))
    np.testing.assert_array_equal(got, ref.gbdt_predict_numpy(
        Zn, model.feats, model.thresholds, model.leaves, model.base))


def test_layered_run_equals_cpu():
    """Tiers with admission, a slack-weighted cap, preemption and the GBDT
    corrector in one run: on the card (every table and correction through
    the kernel, one-row innovations included) the records equal the CPU
    run's field for field, ``compare=False`` provenance included."""
    import dataclasses

    import repro_torch.core as core
    from repro_torch.configs.paper_suite import PAPER_APPS
    from repro_torch.core.gbdt import GBDTParams
    dev = _card()
    apps = list(PAPER_APPS)
    tb = core.Testbed(seed=0)
    X, yp, yt, _ = core.build_dataset(apps, tb, seed=0)
    rng = np.random.default_rng(7)
    feats = {a.name: core.profile_features(a, tb, rng=rng) for a in apps}
    g = dict(iterations=80, depth=3, learning_rate=0.15)
    cfg = core.PredictorConfig(gbdt=GBDTParams(l2_leaf_reg=5.0, **g),
                               gbdt_time=GBDTParams(l2_leaf_reg=3.0, **g))
    pool = [core.V5P_CLASS, core.V5E_CLASS, core.V5E_CLASS,
            core.V5LITE_CLASS]
    idle = sum(c.idle_power() for c in pool)
    sprint = sum(c.dvfs.power(c.dvfs.max_clock, 1.0, 1.0) for c in pool)
    runs = {}
    for d in (dev, torch.device("cpu")):
        jobs = list(core.multi_tenant_workload(
            apps, tb, n_jobs=200, seed=2, pool=pool, overload=10.0,
            quantum_frac=0.25))
        svc = core.PredictionService(
            tb.dvfs, core.EnergyTimePredictor(cfg, device=d).fit(X, yp, yt),
            feats, testbed=tb, device=d)
        before = (gp.launches, gp.rows_launches.get(1, 0))
        res = core.run_schedule(
            jobs, "min-energy", core.Testbed(seed=100), service=svc,
            device_classes=pool,
            feedback=core.OnlineAdapter(svc, corrector=core.GBDTCorrector(
                core.ObservationStore(keep_rows=True), min_obs=4, device=d)),
            power_coordinator=core.PowerCapCoordinator(
                idle + 0.55 * (sprint - idle)),
            preemption=core.PreemptionManager(),
            admission=core.AdmissionController(lookahead_s=30.0,
                                               threshold=0.75), device=d)
        runs[d.type] = res, (gp.launches - before[0],
                             gp.rows_launches.get(1, 0) - before[1])

    def fields(r):
        return [(f.name, getattr(r, f.name)) for f in dataclasses.fields(r)]

    (a, (k_all, k_one)), (b, (c_all, c_one)) = runs["cuda"], runs["cpu"]
    assert [fields(r) for r in a.records] == [fields(r) for r in b.records]
    assert [j.job_id for j in a.shed] == [j.job_id for j in b.shed]
    assert a.shed_count > 0
    assert k_all > 0 and k_one > 0 and c_all == c_one == 0


# ---------------------------------------------------------------------- #
#  Cold start, federation and model-derived apps on the card
# ---------------------------------------------------------------------- #
_GOLDEN_CACHE: dict = {}


def _golden_fixture(dev):
    """tests/test_golden.py's fixture, its predictor on ``dev``."""
    import repro_torch.core as core
    from repro_torch.configs.paper_suite import PAPER_APPS
    from repro_torch.core.gbdt import GBDTParams
    key = str(dev)
    if key not in _GOLDEN_CACHE:
        apps = list(PAPER_APPS)
        tb = core.Testbed(seed=0)
        X, yp, yt, _ = core.build_dataset(apps, tb, seed=0)
        rng = np.random.default_rng(7)
        feats = {a.name: core.profile_features(a, tb, rng=rng) for a in apps}
        g = dict(iterations=80, depth=3, learning_rate=0.15)
        cfg = core.PredictorConfig(gbdt=GBDTParams(l2_leaf_reg=5.0, **g),
                                   gbdt_time=GBDTParams(l2_leaf_reg=3.0, **g))
        _GOLDEN_CACHE[key] = dict(
            apps=apps, tb=tb, feats=feats,
            pred=core.EnergyTimePredictor(cfg, device=dev).fit(X, yp, yt))
    return _GOLDEN_CACHE[key]


#: the paper corpus, and the cold-start golden run's profiled corpus (every
#: paper app but the last four)
KMEANS_CORPORA = {"paper": 12, "coldstart-profiled": 8}


@pytest.mark.parametrize("tf32", [False, True], ids=["tf32-off", "tf32-on"])
@pytest.mark.parametrize("corpus", sorted(KMEANS_CORPORA))
def test_kmeans_card_equals_cpu(corpus, tf32):
    """The Lloyd sweep gives the same labels, centres and SSE on the card
    as on the CPU, bit for bit, whatever the global TF32 switch says; the
    correlation table (the cold-start neighbour map) follows."""
    from repro_torch.core import CorrelationIndex
    from repro_torch.core.kmeans import KMeans, choose_k_elbow
    dev = _card()
    f = _golden_fixture(torch.device("cpu"))
    names = [a.name for a in f["apps"]][:KMEANS_CORPORA[corpus]]
    F = np.stack([f["feats"][n] for n in names])
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        for k in (2, 3, 5, min(8, len(names))):
            a = KMeans(k=k, device=dev).fit(F)
            b = KMeans(k=k, device="cpu").fit(F)
            np.testing.assert_array_equal(a.labels_, b.labels_)
            np.testing.assert_array_equal(a.centers_, b.centers_)
            assert a.sse_ == b.sse_
        assert choose_k_elbow(F, device=dev) == choose_k_elbow(F,
                                                               device="cpu")
        for k in (5, None):
            ta = CorrelationIndex(k=k, device=dev).fit(names, F).table()
            tb = CorrelationIndex(k=k, device="cpu").fit(names, F).table()
            assert [(n, int(lab), c) for n, lab, c in ta] == \
                [(n, int(lab), c) for n, lab, c in tb]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def test_synthesized_and_derived_tables_equal_cpu():
    """Synthesized ladders (κ from the card's neighbour map) and the
    model-derived apps' predicted ladders (through the kernel) equal the
    CPU service's bit for bit on every device class."""
    import dataclasses

    import repro_torch.core as core
    dev = _card()
    tabs = {}
    for d in (dev, torch.device("cpu")):
        f = _golden_fixture(d)
        held = {a.name for a in f["apps"][-4:]}
        svc = core.PredictionService(
            f["tb"].dvfs, f["pred"],
            {n: v for n, v in f["feats"].items() if n not in held},
            testbed=f["tb"], device=d)
        synth = core.ColdStartSynthesizer()
        svc.attach_synthesizer(synth)
        core.register_model_apps(svc, f["tb"])
        novel = [dataclasses.replace(a, name=f"novel-{a.name}")
                 for a in f["apps"]]
        before = gp.launches
        out = []
        for app in novel + list(core.model_app_suite()):
            svc.note_app(app)
            for cls in (None, core.V5P_CLASS, core.V5LITE_CLASS):
                t = svc.table(app.name, cls)
                out.append((app.name, t.source, t.P.tobytes(),
                            t.T.tobytes()))
        tabs[d.type] = (out, [synth.neighbor(a.name) for a in novel],
                        gp.launches - before)
    (a, na, k), (b, nb, c) = tabs["cuda"], tabs["cpu"]
    assert a == b and na == nb
    assert {s for _, s, _, _ in a} == {"synthesized", "predicted"}
    assert k > 0 and c == 0


@pytest.mark.parametrize("key", ["min-energy|coldstart|0",
                                 "min-energy|federation|0",
                                 "min-energy|models|0"])
def test_new_golden_digests_on_card(key):
    """The cold-start, federation and model-derived golden traces with the
    predictor and every table on the card, built as tests/test_golden.py
    builds them."""
    import hashlib
    import json
    import pathlib

    import repro_torch.core as core
    dev = _card()
    f = _golden_fixture(dev)
    apps, tb = f["apps"], f["tb"]
    kw = dict(predictor=f["pred"], device=dev)
    before = gp.launches
    if key == "min-energy|coldstart|0":
        held = {a.name for a in apps[-4:]}
        res = core.run_schedule(
            core.make_workload(apps, tb, seed=0), "min-energy",
            core.Testbed(seed=100),
            app_features={n: v for n, v in f["feats"].items()
                          if n not in held},
            coldstart=core.ColdStartSynthesizer(), **kw)
    elif key == "min-energy|federation|0":
        jobs = list(core.multi_rack_workload(apps, tb, n_devices=4,
                                             n_jobs=16, seed=0,
                                             utilization=0.7))
        res = core.run_schedule(
            jobs, "min-energy", core.Testbed(seed=100),
            app_features=f["feats"], n_devices=4,
            power_coordinator=core.FacilityCoordinator(
                375.0, (2, 2), share_policy="demand-weighted",
                escalation=True, guard=0.2),
            preemption=core.FederatedPreemptionManager(
                (2, 2), dvfs=tb.dvfs, device_slowdown={0: 3.0}), **kw)
    else:
        suite = core.model_app_suite()
        feats = dict(f["feats"])
        feats.update(core.register_model_apps(None, tb))
        pool = [core.V5P_CLASS, core.V5E_CLASS]
        jobs = core.merge_workloads(
            core.serving_workload(suite, tb, n_jobs=14, seed=0,
                                  n_devices=2, pool=pool),
            core.training_workload(suite, tb, n_jobs=4, seed=1,
                                   n_devices=2, pool=pool))
        res = core.run_schedule(jobs, "min-energy", core.Testbed(seed=100),
                                app_features=feats, n_devices=2,
                                device_classes=pool, **kw)

    def rnd(x):
        return float(f"{x:.12g}")

    trace = [[r.job_id, r.name, r.device, r.clock.core_mhz, r.clock.mem_mhz,
              rnd(r.start), rnd(r.end), rnd(r.time_s), rnd(r.power_w),
              rnd(r.energy_j), int(r.met_deadline),
              int(r.had_feasible_clock)] for r in res.records]
    digest = hashlib.sha256(json.dumps(
        trace, separators=(",", ":"), sort_keys=True).encode()).hexdigest()
    path = pathlib.Path(__file__).parent / "golden" / "schedule_traces.json"
    assert digest == json.loads(path.read_text())["traces"][key]["digest"]
    assert gp.launches > before


def _train_batch(cfg, rows=2, seq=32, seed=1) -> dict:
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    batch = dict(SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                        seq_len=seq, global_batch=rows,
                                        seed=seed)).batch(0))
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (rows, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_reduced_train_step_alike_on_card_and_cpu(arch):
    dev = _card()
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.convert import model_arrays, model_from_arrays
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train.step import loss_fn, make_train_step
    cfg = reduce_for_smoke(get_config(arch))
    arrays = model_arrays(model.init(cfg, torch.Generator().manual_seed(2),
                                     device="cpu"))
    batch = _train_batch(cfg)
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=50)
    before = (fa.launches, ms.launches)
    out = []
    for d in (dev, torch.device("cpu")):
        params = model_from_arrays(cfg, arrays, device=d)
        params.requires_grad_(True)
        loss, _ = loss_fn(params, batch, cfg, device=d)
        named = dict(params.named_parameters())
        grads = torch.autograd.grad(loss, list(named.values()))
        _, _, m = make_train_step(cfg, ocfg, device=d)(
            params, adamw.init(params, ocfg), batch)
        out.append(({k: float(v) for k, v in m.items()},
                    [g.cpu() for g in grads],
                    [p.detach().cpu() for p in named.values()]))
    assert (fa.launches, ms.launches) == before     # training: no kernel
    (mc, gc, pc), (mh, gh, ph) = out
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        assert abs(mc[k] - mh[k]) <= 1e-5 * abs(mh[k]), k
    for a, b in zip(gc, gh):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
    close = total = 0
    for a, b in zip(pc, ph):
        d_ = (a - b).abs()
        assert float(d_.max()) <= 2e-3 * (1 + 1e-3)
        close += int((d_ <= 1e-5).sum())
        total += d_.numel()
    assert close >= 0.999 * total


@pytest.mark.parametrize("arch", ["smollm-360m", "mixtral-8x22b"])
def test_restart_on_the_card_is_bit_exact(arch, tmp_path):
    """The embedding backward and the MoE's gathers accumulate by index:
    with deterministic algorithms on they take deterministic kernels, so a
    restarted run replays the clean one bit for bit."""
    dev = _card()
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.dist import (FailureInjector, RunnerConfig,
                                  TrainingRunner)
    from repro_torch.models import model
    from repro_torch.optim import adamw
    from repro_torch.train.step import make_train_step
    cfg = reduce_for_smoke(get_config(arch))
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(3),
                        device=dev, trainable=True)
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=50)
    step = make_train_step(cfg, ocfg, device=dev)
    runs = []
    torch.use_deterministic_algorithms(True)
    try:
        for label, fail in (("clean", ()), ("faulty", (6,))):
            p = copy.deepcopy(params)
            runner = TrainingRunner(
                RunnerConfig(str(tmp_path / label), ckpt_interval=4), step,
                lambda s: _train_batch(cfg, rows=4, seed=100 + s),
                injector=FailureInjector(fail))
            p, o, _ = runner.run(p, adamw.init(p, ocfg), 0, 10)
            runs.append((p, o, runner.restarts))
    finally:
        torch.use_deterministic_algorithms(False)
    (pa, oa, ra), (pb, ob, rb) = runs
    assert (ra, rb) == (0, 1) and int(ob.step) == 10
    for (n, a), b in zip(pa.named_parameters(), pb.parameters()):
        assert torch.equal(a, b), n
    for side in ("m", "v"):
        for n, a in getattr(oa, side).items():
            assert torch.equal(a, getattr(ob, side)[n]), (side, n)
