"""K3's Mamba-2 route on the card: ``ops.mamba2_scan``'s kernel
(``csrc/mamba2_scan.cu``) against its plain version.

Every test here is marked ``cuda`` and skips without an NVIDIA card: a
CUDA kernel has no CPU mode. The file imports only ``torch``, ``numpy``
and ``repro_torch`` (no JAX)::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mamba2_scan.py

The plain version (``ref.mamba2_scan_ref``: the Mamba-1 plain scan of
each group's channels) sums in another order: fp32 tolerance 2e-5, as
the Mamba-1 kernel's, and one ulp more where both round y once to bf16.
The kernel keeps the Mamba-1 kernel's arithmetic and order of sums, so
it also equals the route it replaced (the Mamba-1 kernel once a group on
the expanded fp32 inputs, y rounded once to the activation dtype) bit
for bit, at every N up to 64 in its one build. The wrapper's checks and
its plain route are ``tests/test_torch_zamba2.py``'s.
"""
from __future__ import annotations

import pytest
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import mamba2_scan as m2, ops, ref

pytestmark = pytest.mark.cuda

F32 = dict(atol=2e-5, rtol=2e-5)
#: y in bf16: the fp32 sums' tolerance and one bf16 ulp (2**-7 relative)
BF16 = dict(atol=2e-5, rtol=2.0 ** -7 + 2e-5)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, B, L, H, P, G, N, dtype, dev):
    """x, B and C as strided views of one (B, L, H P + 2 G N) tensor, as
    the Mamba-2 block's in-projection leaves them; dt after a softplus, A
    and D per head."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    Di = H * P
    xBC = torch.randn((B, L, Di + 2 * G * N), generator=gen,
                      device=dev).to(dtype)
    x = xBC[..., :Di].unflatten(-1, (H, P))
    Bm = xBC[..., Di:Di + G * N].unflatten(-1, (G, N))
    Cm = xBC[..., Di + G * N:].unflatten(-1, (G, N))
    dt = F.softplus(torch.randn((B, L, H), generator=gen, device=dev) - 1.0)
    A = -torch.linspace(1.0, 16.0, H, device=dev)
    D = torch.linspace(0.5, 1.5, H, device=dev)
    return x, dt, A, Bm, Cm, D


#: (B, L, H, P, G, N): Zamba2-7B's layer at B 1 (L 2, 33 ragged against
#: the 32-step chunks, the mean prompt 2 112, the published context
#: 4 096) and the decode cell's batch prefill (B 32, L 512); a tiny G 1;
#: P not a multiple of 4 (a thread's channels in two heads); rows whose
#: strides allow no 16-byte copies; N 4-64, all in the one build
SHAPES = [(1, 2, 112, 64, 2, 64), (1, 33, 112, 64, 2, 64),
          (1, 2112, 112, 64, 2, 64), (1, 4096, 112, 64, 2, 64),
          (32, 512, 112, 64, 2, 64), (2, 77, 6, 16, 1, 16),
          (1, 50, 6, 6, 2, 64), (2, 70, 10, 5, 5, 64),
          (2, 65, 8, 5, 2, 4), (1, 40, 4, 8, 2, 8), (1, 100, 12, 4, 3, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_matches_plain_on_the_card(shape, dtype):
    dev = _card()
    args = _inputs(1, *shape, dtype, dev)
    before = m2.launches
    y, h = ops.mamba2_scan(*args)
    torch.cuda.synchronize()
    assert m2.launches == before + 1
    assert y.dtype == dtype and h.dtype == torch.float32
    want_y, want_h = ref.mamba2_scan_ref(*args)
    torch.testing.assert_close(y, want_y,
                               **(F32 if dtype == torch.float32 else BF16))
    torch.testing.assert_close(h, want_h, **F32)
    # the route it replaced: the Mamba-1 kernel once a group, its fp32 y
    # rounded once to the activation dtype
    old_y, old_h = ref.mamba2_scan_ref(*args, scan=ops.mamba_scan)
    assert torch.equal(y, old_y) and torch.equal(h, old_h)


def test_every_device_operation_is_named_mamba_scan():
    """``scan_roofline.prefill`` sums the device time of the operations
    named ``mamba_scan``: a call launches nothing else."""
    dev = _card()
    from torch.profiler import ProfilerActivity, profile
    args = _inputs(2, 1, 256, 112, 64, 2, 64, torch.bfloat16, dev)
    ops.mamba2_scan(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.mamba2_scan(*args)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert names and all("mamba_scan" in n for n in names), names


def test_the_block_counts_its_kernel_scans():
    """A reduced Zamba2 prefill on the card: one ``mamba.scan_kernel`` and
    one launch a Mamba-2 layer; the decode step's recurrence none."""
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
    before = m2.launches
    obs.enable()
    try:
        logits, cache = model.prefill(cfg, params, tokens, 48, device=dev)
        prefilled = obs.drain().counts
        model.decode_step(cfg, params, cache,
                          logits[:, -1:].argmax(dim=-1), 40, device=dev)
        stepped = obs.drain().counts
    finally:
        obs.disable()
        obs.drain()
    assert prefilled["mamba.scan_kernel"] == cfg.n_layers
    assert m2.launches - before == cfg.n_layers
    assert "mamba.scan_kernel" not in stepped
