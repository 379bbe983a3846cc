"""FalconMamba-7B's form on the port's Mamba-1 LM: the two port fields
(``mixer_rms_eps``: weightless RMS norms of dt, B and C after
``x_proj``; ``residual_in_fp32``: the residual stream in fp32), their
defaults (the registry's config sets neither; what it computes is held
to the JAX package by ``tests/test_torch_models.py``), the spans and
counter of the Mamba-1 mixer, and on the card K3's Mamba-1 launch at the
published widths.

The file imports only ``torch`` and ``repro_torch`` (no JAX). The model
against transformers' ``FalconMambaForCausalLM`` and the benchmark's
plain reference is ``perfbench/test_perfbench_ssm.py``. The card tests
are marked ``cuda`` and skip without an NVIDIA card (a CUDA kernel has
no CPU mode)::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_falcon_mamba.py
"""
from __future__ import annotations

import collections
import dataclasses

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import base, get_config
from repro_torch.models import model, ssm, ssm_lm
from repro_torch.train import serve

B, S, STEPS = 2, 12, 3
#: FalconMamba's form at a test's size, served in bf16
FALCON = base.PortConfig(
    name="tiny-falcon-mamba", family="ssm", n_layers=3, d_model=32,
    n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=64, ssm_state=8,
    ssm_expand=2, mamba_version=1, remat="none", mixer_rms_eps=1e-6,
    residual_in_fp32=True)


@pytest.fixture
def recording():
    """Recording starts off and empty, and is left so."""
    obs.disable()
    obs.drain()
    yield
    obs.disable()
    obs.drain()


def _params(cfg, seed=3):
    return model.init(cfg, torch.Generator().manual_seed(seed),
                      device="cpu")


def _tokens(cfg, shape, seed=4):
    return torch.randint(0, cfg.vocab_size, shape,
                         generator=torch.Generator().manual_seed(seed))


def _serve(cfg, params, tokens):
    logits, cache = serve.make_prefill_step(cfg, S + STEPS, device="cpu")(
        params, tokens)
    step = serve.make_serve_step(cfg, device="cpu")
    out = [logits]
    tok = logits[:, -1:].argmax(dim=-1)
    for k in range(STEPS):
        lg, cache = step(params, cache, tok, S + k)
        tok = lg[:, -1:].argmax(dim=-1)
        out.append(lg)
    return out


def test_the_registry_config_sets_no_port_field():
    cfg = get_config("falcon-mamba-7b")
    assert cfg.port_fields_set() == []
    assert cfg.mixer_rms_eps is None and cfg.residual_in_fp32 is False
    assert not {"mixer_rms_eps", "residual_in_fp32"} & {
        f.name for f in dataclasses.fields(cfg)}
    assert sorted(FALCON.port_fields_set()) == ["mixer_rms_eps",
                                                "residual_in_fp32"]


def test_the_stream_is_fp32_and_each_norm_reads_it_as_the_fields_say(
        monkeypatch):
    """With ``residual_in_fp32`` each block's norm reads the stream
    rounded to bf16 and the final norm reads it in fp32; without it every
    norm reads bf16. The mixer's norms read the activation dtype."""
    seen = []
    norm = ssm_lm.rms_norm

    def spy(x, w, eps):
        seen.append(x.dtype)
        return norm(x, w, eps)
    monkeypatch.setattr(ssm_lm, "rms_norm", spy)
    tokens = _tokens(FALCON, (B, S))
    for cfg, last in ((FALCON, torch.float32),
                      (dataclasses.replace(FALCON, residual_in_fp32=False),
                       torch.bfloat16)):
        seen.clear()
        params = _params(cfg)
        logits, cache = model.prefill(cfg, params, tokens, S + 1,
                                      device="cpu")
        model.decode_step(cfg, params, cache, tokens[:, :1], S,
                          device="cpu")
        assert logits.dtype == torch.float32
        per_pass = [torch.bfloat16] * cfg.n_layers + [last]
        assert seen == per_pass * 2


def test_the_mixer_norms_change_the_output_and_keep_the_dtype():
    cfg = FALCON
    params = _params(cfg)
    x = torch.randn((B, S, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).bfloat16()
    lp = params.layers[0].mamba
    out, st = ssm.mamba1_block(lp, x, cfg)
    bare, _ = ssm.mamba1_block(lp, x, dataclasses.replace(
        cfg, mixer_rms_eps=None))
    assert out.dtype == torch.bfloat16 and st["ssm"].dtype == torch.float32
    assert not torch.allclose(out.float(), bare.float(), atol=1e-2)
    t = torch.randn((4, 16), generator=torch.Generator().manual_seed(2))
    r = ssm._unit_rms(t.bfloat16(), 1e-6)
    assert r.dtype == torch.bfloat16
    torch.testing.assert_close(r.float().pow(2).mean(-1), torch.ones(4),
                               atol=2e-2, rtol=0)


def test_each_root_holds_its_mixers_with_their_scan_and_norms(recording):
    """Each prefill and decode step: one ``mamba`` span a layer beside
    its block's ``norm``, holding one ``mamba.scan`` and the mixer's
    three ``norm`` spans; the final norm; on the CPU no
    ``mamba.scan_kernel``. Recording changes no bit."""
    cfg = FALCON
    params = _params(cfg)
    tokens = _tokens(cfg, (B, S))
    want = _serve(cfg, params, tokens)
    obs.enable()
    got = _serve(cfg, params, tokens)
    obs.disable()
    spans = obs.drain()
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    kids = collections.defaultdict(list)
    for i in range(len(spans)):
        if spans.parent[i] >= 0:
            kids[spans.parent[i]].append(i)
    roots = [i for i in range(len(spans)) if spans.parent[i] < 0]
    assert [spans.named(i) for i in roots] == \
        ["serve.prefill"] + ["serve.decode_step"] * STEPS
    for r in roots:
        top = collections.Counter(spans.named(i) for i in kids[r])
        assert top == {"mamba": cfg.n_layers, "norm": cfg.n_layers + 1}
        for i in kids[r]:
            if spans.named(i) == "mamba":
                inner = collections.Counter(spans.named(j) for j in kids[i])
                assert inner == {"mamba.scan": 1, "norm": 3}
    assert "mamba.scan_kernel" not in spans.counts


# --------------------------------------------------------------------- #
#  On the card
# --------------------------------------------------------------------- #
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _published(**kw):
    return base.with_port_fields(get_config("falcon-mamba-7b"),
                                 mixer_rms_eps=1e-6, residual_in_fp32=True,
                                 **kw)


@pytest.mark.cuda
def test_the_published_mixer_takes_k3_and_matches_its_plain_version(
        monkeypatch):
    """FalconMamba-7B's mixer (Di 8192, N 16, dt rank 256, the mixer
    norms) on a 2 048-token prompt, in fp32: one launch of K3's Mamba-1
    kernel, against the same block with the scan's plain version
    (``ref.mamba_scan_ref``) on the card. The scan's 2e-5 (fp32, another
    order of sums) is carried through ``out_proj``'s sum over 8 192
    channels: 1e-4."""
    from repro_torch.kernels import mamba_scan as ms, ops, ref
    dev = _card()
    cfg = _published(param_dtype="float32", activation_dtype="float32")
    assert (cfg.d_inner, cfg.ssm_state, ssm._dt_rank(cfg)) == \
        (8192, 16, 256)
    p = ssm.Mamba1(cfg, dev)
    p.reset_parameters(torch.Generator(device=dev).manual_seed(0))
    x = torch.randn((1, 2048, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    before = ms.launches
    got, st = ssm.mamba1_block(p, x, cfg)
    torch.cuda.synchronize()
    assert ms.launches - before == 1
    monkeypatch.setattr(ops, "mamba_scan", ref.mamba_scan_ref)
    want, want_st = ssm.mamba1_block(p, x, cfg)
    torch.cuda.synchronize()
    assert ms.launches - before == 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(st["ssm"], want_st["ssm"], atol=2e-5,
                               rtol=2e-5)


@pytest.mark.cuda
def test_a_published_prefill_counts_64_scan_kernels(recording):
    """FalconMamba-7B whole (64 layers, bf16) on the card: a prefill
    launches K3's Mamba-1 kernel once a layer and counts one
    ``mamba.scan_kernel`` each; a decode step's recurrence none."""
    from repro_torch.kernels import mamba_scan as ms
    dev = _card()
    cfg = _published()
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    tokens = _tokens(cfg, (1, 512))
    before = ms.launches
    obs.enable()
    logits, cache = serve.make_prefill_step(cfg, 513, device=dev)(
        params, tokens)
    prefilled = obs.drain().counts
    serve.make_serve_step(cfg, device=dev)(
        params, cache, logits[:, -1:].argmax(dim=-1), 512)
    stepped = obs.drain().counts
    obs.disable()
    assert prefilled["mamba.scan_kernel"] == cfg.n_layers == 64
    assert ms.launches - before == 64
    assert "mamba.scan_kernel" not in stepped
