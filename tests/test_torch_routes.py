"""The attention wrapper's route choice and tolerances, on the CPU.

``repro_torch.kernels.flash_attention.route`` picks, before each CUDA
launch, the tensor-core kernel (``"wgmma"``) or the SIMT kernel
(``"simt"``) from the dtype, the head dim and the tensors' alignment.
``tolerance`` states how far each route may sit from the plain version;
the wgmma route's bound ``2**-9 max|v| + 2**-7 |want|`` is checked here on
hand-made inputs by rounding p to bf16 exactly as the kernel does.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa, ops

HEAD_DIMS = (8, 16, 18, 20, 32, 48, 64, 80, 96, 112, 120, 128)


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned",
                                                        "unaligned"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_route_for_each_dtype_head_dim_and_alignment(dtype, hd, aligned):
    want = ("wgmma" if dtype == torch.bfloat16 and hd % 16 == 0 and aligned
            else "simt")
    assert fa.route(dtype, hd, aligned) == want


def test_route_names_are_the_counted_routes():
    assert set(fa.ROUTES) == set(fa.route_launches) == {"wgmma", "simt"}


def test_tolerance_by_route_and_dtype():
    v = torch.tensor([[0.5, -4.0], [2.0, 3.0]])
    assert fa.tolerance("simt", torch.float32, v) == (2e-5, 2e-5)
    assert fa.tolerance("wgmma", torch.float32, v) == (2e-5, 2e-5)
    assert fa.tolerance("simt", torch.bfloat16, v) == (1e-6, 2.0 ** -7)
    # 2**-9 of the largest |v|, here the negative entry
    assert fa.tolerance("wgmma", torch.bfloat16, v) == (2.0 ** -7,
                                                         2.0 ** -7)
    assert fa.tolerance("wgmma", torch.bfloat16,
                        torch.zeros(3)) == (0.0, 2.0 ** -7)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("spread", [0.5, 4.0, 30.0])
def test_wgmma_bound_holds_for_bf16_rounded_p(seed, spread):
    """One attention row as the kernel computes it: fp32 p, l summed from
    the fp32 p, but P.V from p rounded to bf16. Before the output's own
    rounding it stays within 2**-9 max|v| of the exact row; after both
    outputs round to bf16, within the stated tolerance."""
    rng = np.random.default_rng(seed)
    Sk, hd = 777, 64
    s = torch.from_numpy(rng.normal(scale=spread, size=Sk)).float()
    v = torch.from_numpy(rng.normal(size=(Sk, hd))).bfloat16().float()
    p = torch.exp(s - s.max())
    l = p.sum()
    exact = (p.double() @ v.double()) / l.double()
    kernel = (p.bfloat16().double() @ v.double()) / l.double()
    assert float((kernel - exact).abs().max()) <= 2.0 ** -9 * float(
        v.abs().max())
    atol, rtol = fa.tolerance("wgmma", torch.bfloat16, v)
    got, want = kernel.bfloat16().float(), exact.bfloat16().float()
    assert bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def test_cpu_calls_count_no_route():
    before = dict(fa.route_launches)
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 8, 2, 16)))
               .bfloat16() for _ in range(3))
    ops.flash_attention(q, k, v)
    assert fa.route_launches == before


@pytest.mark.parametrize("hd", (144, 224, 256, 272))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_route_above_head_dim_128(dtype, hd):
    """bf16 head dims that are a multiple of 16 up to 256 take the wgmma
    route (its 256-column variant); nothing above 256 does, and the
    SIMT route stops at 128."""
    want = "wgmma" if dtype == torch.bfloat16 and hd <= 256 else "simt"
    assert fa.route(dtype, hd, True) == want
    assert fa.route(dtype, hd, False) == "simt"
    assert fa.max_head_dim(dtype) == (256 if dtype == torch.bfloat16
                                      else 128)


def _attn_args(hd, dtype):
    rng = np.random.default_rng(1)
    return [torch.from_numpy(rng.normal(size=(1, 9, 2, hd))).to(dtype)
            for _ in range(3)]


def test_head_dim_224_by_dtype_on_the_cpu():
    """bf16 at head dim 224 runs (the plain version, as the wgmma route
    would take it on a card); fp32 at 224 raises, as on the card, where
    the SIMT route stops at 128; bf16 above 256 raises."""
    out = ops.flash_attention(*_attn_args(224, torch.bfloat16))
    assert out.shape == (1, 9, 2, 224) and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="maximum of 128"):
        ops.flash_attention(*_attn_args(224, torch.float32))
    with pytest.raises(ValueError, match="maximum of 256"):
        ops.flash_attention(*_attn_args(272, torch.bfloat16))
