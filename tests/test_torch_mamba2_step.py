"""K5 on the card: ``ops.mamba2_state_step``'s kernel
(``csrc/mamba2_step.cu``) against its plain version
(``kernels.mamba2_step.plain``, run on the card too).

Every test here is marked ``cuda`` and skips without an NVIDIA card: a
CUDA kernel has no CPU mode. The file imports only ``torch`` and
``repro_torch`` (no JAX)::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mamba2_step.py

Each case runs one step and a 32-step rollout from the same state on
twin states, the inputs strided views of one projection as the block
passes them. The conv state is the inputs shifted, so it must be equal.
In fp32 y and the SSM state agree within 1e-5 of their largest value
(the state update rounds as the plain step's ops do; SiLU and softplus
may differ in an ulp). In bf16 the plain step rounds each conv tap to
bf16 and the kernel sums them in fp32, so both are held to the plain
step in fp32 on the same values: the kernel's error at most twice the
bf16 plain step's, plus one bf16 ulp of the largest value. The wrapper's
checks and its plain route are ``tests/test_torch_zamba2.py``'s.
"""
from __future__ import annotations

import math

import pytest
import torch

from repro_torch import obs
from repro_torch.kernels import mamba2_step as m5, ops

pytestmark = pytest.mark.cuda

#: (B, H, P, G, N, K): Zamba2-7B's layer at the decode cell's batch and
#: at B 1; small G 1 and G 2 shapes; P not a multiple of a block's 32
#: rows; N not a multiple of 4 (the scalar form); K 2 and 3
SHAPES = [(32, 112, 64, 2, 64, 4), (1, 112, 64, 2, 64, 4),
          (2, 6, 16, 1, 16, 4), (3, 8, 8, 2, 8, 4), (2, 4, 40, 2, 64, 4),
          (2, 6, 5, 3, 6, 2), (1, 4, 16, 1, 33, 3)]
STEPS = 32


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _token(gen, B, H, P, G, N, dtype, dev):
    """One token's xBC and dt_raw: strided views of a (B, 1, 2 H P + 2 G N
    + H) projection, as the block's split leaves them."""
    Di = H * P
    C = Di + 2 * G * N
    proj = torch.randn((B, 1, Di + C + H), generator=gen, device=dev)
    proj[..., Di + C:] -= 1.0
    proj = proj.to(dtype)
    return proj[..., Di:Di + C], proj[..., Di + C:]


def _layer(gen, B, H, P, G, N, K, dtype, dev):
    """The layer's weights (conv in ``dtype``; dt_bias, A_log, D fp32) and
    a bf16 conv state and an fp32 SSM state."""
    C = H * P + 2 * G * N
    w = [(torch.randn((C, K), generator=gen, device=dev) / K).to(dtype),
         (torch.randn((C,), generator=gen, device=dev) / 4).to(dtype),
         torch.randn((H,), generator=gen, device=dev) - 2.0,
         torch.log(torch.linspace(1.0, 16.0, H, device=dev)),
         torch.linspace(0.5, 1.5, H, device=dev)]
    conv = torch.randn((B, K - 1, C), generator=gen, device=dev).to(
        torch.bfloat16)
    h = torch.randn((B, H, P, N), generator=gen, device=dev)
    return w, conv, h


def _err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _ulp(want) -> float:
    """One bf16 ulp of the largest |value|."""
    return 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_in_fp32(shape):
    dev = _card()
    B, H, P, G, N, K = shape
    gen = torch.Generator(device=dev).manual_seed(1)
    w, conv, h = _layer(gen, B, H, P, G, N, K, torch.float32, dev)
    kc, kh = conv.clone(), h.clone()
    pc, ph = conv.clone(), h.clone()
    before = m5.launches
    for t in range(STEPS):
        xBC, dt_raw = _token(gen, B, H, P, G, N, torch.float32, dev)
        assert xBC.stride(0) != xBC.shape[-1]
        y = ops.mamba2_state_step(xBC, dt_raw, *w, kc, kh)
        want = m5.plain(xBC, dt_raw, *w, pc, ph)
        torch.cuda.synchronize()
        assert y.dtype == torch.float32 and y.shape == (B, 1, H * P)
        assert torch.equal(kc, pc), f"conv state, step {t}"
        assert _err(y, want) <= 1e-5 * float(want.abs().max()), t
        assert _err(kh, ph) <= 1e-5 * float(ph.abs().max()), t
    assert m5.launches == before + STEPS


@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_in_bf16_is_as_close_to_fp32_as_the_plain_step(shape):
    dev = _card()
    B, H, P, G, N, K = shape
    gen = torch.Generator(device=dev).manual_seed(2)
    w, conv, h = _layer(gen, B, H, P, G, N, K, torch.bfloat16, dev)
    w32 = [t.float() for t in w]
    kc, kh = conv.clone(), h.clone()               # the kernel, bf16
    pc, ph = conv.clone(), h.clone()               # the plain step, bf16
    fc, fh = conv.float(), h.clone()               # the plain step, fp32
    for t in range(STEPS):
        xBC, dt_raw = _token(gen, B, H, P, G, N, torch.bfloat16, dev)
        y = ops.mamba2_state_step(xBC, dt_raw, *w, kc, kh)
        yp = m5.plain(xBC, dt_raw, *w, pc, ph)
        yf = m5.plain(xBC.float(), dt_raw.float(), *w32, fc, fh)
        torch.cuda.synchronize()
        assert y.dtype == torch.bfloat16
        assert torch.equal(kc, pc) and torch.equal(kc.float(), fc), t
        for got, plain, want, what in ((y, yp, yf, "y"),
                                       (kh, ph, fh, "ssm state")):
            bound = 2 * _err(plain, want) + _ulp(want)
            assert _err(got, want) <= bound, (what, t, _err(got, want),
                                              bound)


def test_every_device_operation_is_one_of_the_two_kernels():
    """Calls launch the conv kernel and the state kernel and nothing
    else; neither is named as K3 (``mamba_scan``), whose roofline the
    benchmark reads by that name."""
    dev = _card()
    from torch.profiler import ProfilerActivity, profile
    gen = torch.Generator(device=dev).manual_seed(3)
    shape = (32, 112, 64, 2, 64)
    w, conv, h = _layer(gen, *shape, 4, torch.bfloat16, dev)
    xBC, dt_raw = _token(gen, *shape, torch.bfloat16, dev)
    ops.mamba2_state_step(xBC, dt_raw, *w, conv, h)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            ops.mamba2_state_step(xBC, dt_raw, *w, conv, h)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    kinds = {k for k in ("mamba2_conv_step_kernel",
                         "mamba2_state_step_kernel")
             if any(k in n for n in names)}
    assert len(kinds) == 2, names
    assert all(any(k in n for k in kinds) for n in names), names
    assert not any("mamba_scan" in n for n in names)


def test_the_decode_step_launches_it_once_a_layer():
    """A reduced Zamba2 on the card: each eager decode step launches K5
    once a Mamba-2 layer and counts one ``mamba.state_step_kernel`` a
    layer, as ``count_decode_step`` counts for a replay; a prefill
    launches none."""
    dev = _card()
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.models import model
    cfg = reduce_for_smoke(get_config("zamba2-7b"))
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    tokens = torch.randint(0, cfg.vocab_size, (2, 40),
                           generator=torch.Generator().manual_seed(3))
    obs.disable()
    obs.drain()
    before = m5.launches
    logits, cache = model.prefill(cfg, params, tokens, 48, device=dev)
    assert m5.launches == before
    obs.enable()
    try:
        model.decode_step(cfg, params, cache, logits[:, -1:].argmax(dim=-1),
                          40, device=dev)
        eager = obs.drain().counts
        model.count_decode_step(cfg, cache, 40)
        replay = obs.drain().counts
    finally:
        obs.disable()
        obs.drain()
    torch.cuda.synchronize()
    assert m5.launches - before == cfg.n_layers
    assert eager["mamba.state_step_kernel"] == cfg.n_layers
    assert replay == eager
