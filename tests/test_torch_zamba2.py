"""The port's hybrid with Zamba2-7B's fields (``shared_block="zamba2"``,
``mamba_ngroups``, ``num_mem_blocks``, ``adapter_rank``,
``hybrid_layer_ids``, ``hidden_act``), on the CPU.

At their defaults the fields leave today's computation as it was: the
pieces this form touched (the hybrid decode loop, the Mamba-2 block's
kernel route, the gated MLP, RoPE, the attention's input width) are held
bit for bit to the operations they ran before it. ``ops.mamba2_scan``'s
plain route is the Mamba-2 block's former per-group Mamba-1 route bit for
bit (its card tests are ``tests/test_torch_mamba2_scan.py``'s). Set, the form records
its spans (``shared``, ``shared.adapter``, ``mamba``, ``mamba.scan``) and
the ``mamba.state_bytes`` counter, changes no bit with them on, counts
its parameters, and refuses a mesh, naming the fields. The form's
numbers against the plain reference and transformers' Zamba2 are
``perfbench/test_perfbench_hybrid.py``'s.
"""
from __future__ import annotations

import collections
import dataclasses

import pytest
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.configs import base, get_config
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as attn_mod
from repro_torch.models import common, hybrid, mlp as mlp_mod, model, ssm
from repro_torch.train import serve

B, S, MAX_SEQ, STEPS = 2, 12, 20, 3
#: Zamba2's form at a test's size: 7 layers, applications at 1, 4 and 5
#: (blocks 0, 1, 0), two B/C groups, a LoRA of rank 4, head dim 16
ZAMBA = base.PortConfig(
    name="tiny-zamba2", family="hybrid", n_layers=7, d_model=32,
    n_heads=4, n_kv_heads=4, head_dim=16, d_ff=48, vocab_size=64,
    ssm_state=8, ssm_expand=2, ssm_head_dim=16, mamba_version=2,
    tie_embeddings=True, param_dtype="float32", activation_dtype="float32",
    remat="none", hidden_act="gelu", mamba_ngroups=2,
    shared_block="zamba2", num_mem_blocks=2, adapter_rank=4,
    hybrid_layer_ids=(1, 4, 5))


def _stand_in():
    """The reference's Zamba2 stand-in (one residual block every period)
    at ``reduce_for_smoke`` widths."""
    return base.reduce_for_smoke(get_config("zamba2-7b"))


def _params(cfg, seed=3):
    return model.init(cfg, torch.Generator().manual_seed(seed),
                      device="cpu")


def _tokens(cfg, shape, seed=4):
    return torch.randint(0, cfg.vocab_size, shape,
                         generator=torch.Generator().manual_seed(seed))


# --------------------------------------------------------------------- #
#  The defaults: today's operations, bit for bit
# --------------------------------------------------------------------- #
def test_the_defaults_set_no_field():
    for arch in ("zamba2-7b", "mistral-nemo-12b", "falcon-mamba-7b"):
        cfg = get_config(arch)
        assert cfg.port_fields_set() == [] and cfg.query_scale == 1.0
        assert not set(base.PORT_FIELDS) & {
            f.name for f in dataclasses.fields(cfg)}
        assert base.with_port_fields(cfg).port_fields_set() == []
    # every field but FalconMamba's two (its mixer norms, fp32 residual)
    assert set(ZAMBA.port_fields_set()) == set(base.PORT_FIELDS) - {
        "mixer_rms_eps", "residual_in_fp32"}


def _decode_as_before(params, cache, tokens, pos, cfg):
    """The residual form's decode step as it ran before the Zamba2 form:
    each block's state step inline, then the shared block."""
    x = common.embed_tokens(params.embed, tokens, cfg)
    for a, (lo, hi) in enumerate(hybrid._segments(cfg)):
        for i in range(lo, hi):
            lp = params.layers[i]
            h, st = ssm.mamba2_block(
                lp.mamba, common.rms_norm(x, lp.norm, cfg.norm_eps), cfg,
                state={"conv": cache["conv"][i].to(x.dtype),
                       "ssm": cache["ssm"][i]})
            x = x + h
            common.assign(cache["conv"], (i,), st["conv"])
            common.assign(cache["ssm"], (i,), st["ssm"])
        if a < hybrid.n_attn_applications(cfg):
            sp = params.shared_attn
            h, _, _ = attn_mod.attention_decode(
                sp.attn, common.rms_norm(x, sp.attn_norm, cfg.norm_eps),
                cache["attn_k"][a], cache["attn_v"][a], pos, cfg)
            x = x + h
            x = x + mlp_mod.mlp(sp.mlp, common.rms_norm(x, sp.mlp_norm,
                                                        cfg.norm_eps))
    return hybrid._head(params, x, cfg), cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_default_hybrid_decode_is_the_step_before_it(dtype):
    cfg = dataclasses.replace(_stand_in(), param_dtype=dtype,
                              activation_dtype=dtype)
    params = _params(cfg)
    _, cache = model.prefill(cfg, params, _tokens(cfg, (B, S)), MAX_SEQ,
                             device="cpu")
    twin = {k: v.clone() for k, v in cache.items()}
    for k in range(STEPS):
        tok = _tokens(cfg, (B, 1), seed=10 + k)
        got, cache = model.decode_step(cfg, params, cache, tok, S + k,
                                       device="cpu")
        want, twin = _decode_as_before(params, twin, tok, S + k, cfg)
        assert torch.equal(got, want)
        for n in cache:
            assert torch.equal(cache[n], twin[n])


def test_default_mamba2_kernel_route_is_the_one_call_before_it():
    cfg = _stand_in()
    p = ssm.Mamba2(cfg, "cpu")
    p.reset_parameters(torch.Generator().manual_seed(1))
    Di, N, Pd = cfg.d_inner, cfg.ssm_state, cfg.ssm_head_dim
    H = Di // Pd
    g = torch.Generator().manual_seed(2)
    xs, z = (torch.randn(B, S, Di, generator=g) for _ in range(2))
    Bm, Cm = (torch.randn(B, S, N, generator=g) for _ in range(2))
    dt_raw = torch.randn(B, S, H, generator=g)
    got, h = ssm._mamba2_core(xs, Bm, Cm, dt_raw, z, p.dt_bias, p.A_log,
                              p.D, p.norm_w, None, cfg, "flash",
                              torch.float32, common.rms_norm)
    # before: one call, its inputs made as here
    dt = F.softplus(dt_raw.float() + p.dt_bias[None, None])
    A = -torch.exp(p.A_log)
    y, h_want = kops.mamba_scan(
        xs.float().contiguous(), dt.float().repeat_interleave(Pd, dim=-1),
        A.repeat_interleave(Pd)[:, None].expand(Di, N).contiguous(),
        Bm.float().contiguous(), Cm.float().contiguous(),
        p.D.repeat_interleave(Pd))
    want = common.rms_norm(y.reshape(B, S, Di) * F.silu(z), p.norm_w,
                           cfg.norm_eps)
    assert torch.equal(got, want)
    assert torch.equal(h, h_want.reshape(B, H, Pd, N))


def _kernel_scan_before(xs, dt, A, Bm, Cm, D, dtype, Pd):
    """The Mamba-2 prompt's scan as the block ran it before
    ``ops.mamba2_scan``: the Mamba-1 scan of its channels, one call for B
    and C of (B, L, N), else one a group."""
    B, L, Di = xs.shape
    N = Bm.shape[-1]
    H = Di // Pd
    dt_c = dt.to(dtype).float().repeat_interleave(Pd, dim=-1)
    A_c = A.repeat_interleave(Pd)[:, None].expand(Di, N).contiguous()
    D_c = D.repeat_interleave(Pd)
    if Bm.dim() == 3:
        y, h_last = kops.mamba_scan(xs.float().contiguous(), dt_c, A_c,
                                    Bm.float().contiguous(),
                                    Cm.float().contiguous(), D_c)
        return y, h_last.reshape(B, H, Pd, N)
    G = Bm.shape[2]
    c = Di // G
    ys, hs = [], []
    for g in range(G):
        ch = slice(g * c, (g + 1) * c)
        y, h = kops.mamba_scan(xs[..., ch].float().contiguous(),
                               dt_c[..., ch].contiguous(),
                               A_c[ch].contiguous(),
                               Bm[:, :, g].float().contiguous(),
                               Cm[:, :, g].float().contiguous(),
                               D_c[ch].contiguous())
        ys.append(y)
        hs.append(h)
    return torch.cat(ys, dim=-1), torch.cat(hs, dim=1).reshape(B, H, Pd, N)


def _scan_views(seed, Bsz, L, H, Pd, G, N, dtype):
    """x, B and C as the block's strided views of one conv output xBC,
    B and C (B, L, G, N); dt after the softplus, A and D per head."""
    g = torch.Generator().manual_seed(seed)
    Di = H * Pd
    xBC = torch.randn(Bsz, L, Di + 2 * G * N, generator=g).to(dtype)
    xs, Bm, Cm = common.split_last(xBC, (Di, G * N, G * N))
    dt = F.softplus(torch.randn(Bsz, L, H, generator=g) - 1.0)
    A = -torch.linspace(1.0, 8.0, H)
    D = torch.linspace(0.5, 1.5, H)
    return (xs, dt, A, Bm.unflatten(-1, (G, N)), Cm.unflatten(-1, (G, N)),
            D)


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("L", [2, 33])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["views", "contiguous"])
def test_mamba2_scan_plain_route_is_the_kernel_route_before_it(G, L, dtype,
                                                               layout):
    """``ops.mamba2_scan`` on the CPU: the block's former per-group
    Mamba-1 route bit for bit (its fp32 y rounded once to the activation
    dtype), on x, B and C as strided views of xBC or as contiguous
    copies."""
    H, Pd, N = 4, 8, 16
    xs, dt, A, Bm, Cm, D = _scan_views(5, 2, L, H, Pd, G, N, dtype)
    assert not xs.is_contiguous() and not Bm.is_contiguous()
    if layout == "contiguous":
        xs, Bm, Cm = xs.contiguous(), Bm.contiguous(), Cm.contiguous()
    y, h = kops.mamba2_scan(xs.unflatten(-1, (H, Pd)), dt, A, Bm, Cm, D)
    want_y, want_h = _kernel_scan_before(xs, dt, A, Bm, Cm, D, dtype, Pd)
    assert y.dtype == dtype and y.shape == (2, L, H, Pd)
    assert torch.equal(y.flatten(2), want_y.to(dtype))
    assert torch.equal(h, want_h)
    if G == 1:   # B and C of (B, L, N): the one call before
        want_y, want_h = _kernel_scan_before(xs, dt, A, Bm[:, :, 0],
                                             Cm[:, :, 0], D, dtype, Pd)
        assert torch.equal(y.flatten(2), want_y.to(dtype))
        assert torch.equal(h, want_h)


@pytest.mark.parametrize("G,L", [(1, 5), (2, 40), (4, 17)])
def test_mamba2_scan_plain_route_matches_the_recurrence(G, L):
    """... and agrees with ``ssm.mamba2_scan``'s recurrence in fp32 within
    the scan tests' tolerance."""
    H, Pd, N = 8, 4, 16
    xs, dt, A, Bm, Cm, D = _scan_views(6, 2, L, H, Pd, G, N, torch.float32)
    u = xs.unflatten(-1, (H, Pd))
    y, h = kops.mamba2_scan(u, dt, A, Bm, Cm, D)
    want_y, want_h = ssm.mamba2_scan(u, dt, A, Bm, Cm, D)
    torch.testing.assert_close(y, want_y, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(h, want_h, atol=2e-5, rtol=2e-5)


def test_mamba2_scan_plain_route_calls_the_mamba1_scan_once_a_group(
        monkeypatch):
    calls = []
    scan = kops.mamba_scan
    monkeypatch.setattr(kops, "mamba_scan",
                        lambda *a: calls.append(a[0].shape) or scan(*a))
    xs, dt, A, Bm, Cm, D = _scan_views(7, 1, 9, 6, 4, 3, 8, torch.float32)
    kops.mamba2_scan(xs.unflatten(-1, (6, 4)), dt, A, Bm, Cm, D)
    assert calls == [(1, 9, 8)] * 3


def _refused(args, change):
    xs, dt, A, Bm, Cm, D = args
    x = xs.unflatten(-1, (4, 8))
    kw = dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, D=D)
    return change(kw) or kw


@pytest.mark.parametrize("change,err,match", [
    (lambda k: k.update(x=k["x"].half()), TypeError, "x must be"),
    (lambda k: k.update(Bm=k["Bm"].double()), TypeError, "Bm must be"),
    (lambda k: k.update(dt=k["dt"].bfloat16()), TypeError, "dt must be"),
    (lambda k: k.update(Bm=k["Bm"].bfloat16(), Cm=k["Cm"].bfloat16()),
     TypeError, "Bm must be"),
    (lambda k: k.update(dt=k["dt"][:, :-1].contiguous()), ValueError,
     "dt shape"),
    (lambda k: k.update(A=k["A"][:3].contiguous()), ValueError, "A shape"),
    (lambda k: k.update(Cm=k["Cm"][:, :, :1]), ValueError, "Cm shape"),
    (lambda k: k.update(Bm=k["Bm"][:, :, :, :1], Cm=k["Cm"][:, :, :, :1]),
     ValueError, "Bm's last two dims"),
    (lambda k: k.update(Bm=torch.zeros(2, 5, 3, 16),
                        Cm=torch.zeros(2, 5, 3, 16)), ValueError,
     "4 heads do not split into 3 groups"),
    (lambda k: k.update(Bm=torch.zeros(2, 5, 2, 65),
                        Cm=torch.zeros(2, 5, 2, 65)), ValueError,
     "state size 65"),
    (lambda k: k.update(x=k["x"].transpose(2, 3).contiguous().transpose(
        2, 3)), ValueError, "x's last two dims"),
    (lambda k: k.update(D=k["D"].requires_grad_()), ValueError,
     "forward-only"),
])
def test_mamba2_scan_wrapper_refusals(change, err, match):
    kw = _refused(_scan_views(8, 2, 5, 4, 8, 2, 16, torch.float32), change)
    with pytest.raises(err, match=match):
        kops.mamba2_scan(**kw)


def test_the_scan_kernel_counter_counts_the_card_alone(recording):
    """``mamba.scan_kernel`` counts the Mamba-2 prompt scans that ran in
    the kernel; on the CPU (the plain version) it stays unset."""
    params = _params(ZAMBA)
    obs.enable()
    model.prefill(ZAMBA, params, _tokens(ZAMBA, (B, S)), MAX_SEQ,
                  device="cpu")
    obs.disable()
    assert "mamba.scan_kernel" not in obs.drain().counts


def test_default_mlp_rope_and_attention_are_as_before():
    cfg = get_config("mistral-nemo-12b")
    small = base.reduce_for_smoke(cfg)
    p = mlp_mod.init_mlp(small, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(B, S, small.d_model)
    want = (F.silu(x @ p.w_gate) * (x @ p.w_up)) @ p.w_down
    assert torch.equal(mlp_mod.mlp(p, x), want)
    q = torch.randn(B, S, 4, 16).bfloat16()
    pos = torch.arange(S)[None]
    freqs = common.rope_freqs(16, 1e4)
    ang = pos[..., :, None].float() * freqs
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = q.float().chunk(2, dim=-1)
    want = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).bfloat16()
    assert torch.equal(common.apply_rope(q, pos, 1e4), want)
    a = attn_mod.Attention(cfg, "meta")
    assert a.wq.shape == (cfg.d_model, cfg.n_heads * cfg.resolved_head_dim)


def test_param_counts():
    cfg = _stand_in()
    # the stand-in keeps the reference's formula
    Di, N, D = cfg.d_inner, cfg.ssm_state, cfg.d_model
    H = Di // cfg.ssm_head_dim
    hd = cfg.resolved_head_dim
    att = D * cfg.n_heads * hd * 2 + 2 * D * cfg.n_kv_heads * hd
    blk = D * 2 * Di + Di * cfg.ssm_conv + Di * N * 2 + 2 * H + Di * D \
        + 2 * D
    assert cfg.param_count() == (2 * cfg.vocab_size * D + cfg.n_layers * blk
                                 + att + 3 * D * cfg.d_ff + 2 * D + D)
    # the Zamba2 form counts what the model holds
    for c in (ZAMBA, dataclasses.replace(ZAMBA, adapter_rank=0,
                                         num_mem_blocks=1)):
        m = hybrid.HybridLM(c, torch.device("meta"))
        assert c.param_count() == sum(p.numel() for p in m.parameters())


def test_zamba2_form_specs_name_every_parameter():
    params = hybrid.HybridLM(ZAMBA, torch.device("meta"))
    specs = model.named_specs(model.param_specs(ZAMBA), params)
    assert set(specs) == {n for n, _ in params.named_parameters()}
    assert len(specs["apps.2.lora_b"]) == 2


@pytest.mark.parametrize("change,field", [
    ({"shared_block": "other"}, "shared_block"),
    ({"hybrid_layer_ids": (4, 1)}, "hybrid_layer_ids"),
    ({"hybrid_layer_ids": (1, 7)}, "hybrid_layer_ids"),
    ({"hybrid_layer_ids": ()}, "hybrid_layer_ids"),
    ({"num_mem_blocks": 0}, "num_mem_blocks"),
    ({"shared_block": "residual", "hybrid_attn_period": 2},
     "hybrid_layer_ids"),
    ({"mamba_ngroups": 3}, "mamba_ngroups"),
    ({"hidden_act": "relu"}, "hidden_act"),
])
def test_incomplete_forms_are_refused(change, field):
    with pytest.raises(ValueError, match=field):
        hybrid.HybridLM(dataclasses.replace(ZAMBA, **change),
                        torch.device("meta"))


def test_a_mesh_refuses_the_fields(monkeypatch):
    params = _params(ZAMBA)
    tokens = _tokens(ZAMBA, (1, 4))
    monkeypatch.setattr(hybrid, "current_mesh", lambda: object())
    for call in (lambda: model.forward(ZAMBA, params, tokens, device="cpu"),
                 lambda: model.prefill(ZAMBA, params, tokens, 8,
                                       device="cpu")):
        with pytest.raises(ValueError, match="shared_block.*mesh"):
            call()
    monkeypatch.setattr(ssm, "current_mesh", lambda: object())
    cfg = base.with_port_fields(_stand_in(), mamba_ngroups=2)
    p = ssm.Mamba2(cfg, "cpu")
    p.reset_parameters(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="mamba_ngroups"):
        ssm.mamba2_block(p, torch.randn(1, 4, cfg.d_model), cfg)


def test_query_scale_scales_the_scores_by_half_the_head_dim():
    """q times sqrt(2) inside RoPE, then the kernel's 1/sqrt(hd): scores
    scaled by (hd/2)^-1/2, on the flash, plain and decode routes alike."""
    cfg = dataclasses.replace(ZAMBA, d_model=64)
    p = attn_mod.init_attention(cfg, torch.Generator().manual_seed(0),
                                "cpu")
    x = torch.randn(1, 6, 64)
    pos = torch.arange(6)[None]
    q, k, v = attn_mod._project_qkv(p, x, cfg, pos)
    q0, _, _ = attn_mod._project_qkv(
        p, x, dataclasses.replace(cfg, shared_block="residual",
                                  num_mem_blocks=1, adapter_rank=0,
                                  hybrid_layer_ids=()), pos)
    torch.testing.assert_close(q, q0 * 2 ** 0.5, rtol=1e-6, atol=0)
    flash, _ = attn_mod.attention(p, x, cfg, impl="flash")
    plain, _ = attn_mod.attention(p, x, cfg, impl="xla")
    torch.testing.assert_close(flash, plain, atol=2e-5, rtol=2e-5)
    ck = torch.zeros(1, cfg.n_kv_heads, 6, cfg.resolved_head_dim)
    cv = torch.zeros_like(ck)
    outs = [attn_mod.attention_decode(p, x[:, t:t + 1], ck, cv, t, cfg)[0]
            for t in range(6)]
    torch.testing.assert_close(torch.cat(outs, dim=1), plain, atol=2e-5,
                               rtol=2e-5)


# --------------------------------------------------------------------- #
#  Spans and counters
# --------------------------------------------------------------------- #
@pytest.fixture
def recording():
    obs.disable()
    obs.drain()
    yield
    obs.disable()
    obs.drain()


def _serve(cfg, params, tokens):
    logits, cache = serve.make_prefill_step(cfg, MAX_SEQ, device="cpu")(
        params, tokens)
    step = serve.make_serve_step(cfg, device="cpu")
    out = [logits]
    tok = logits[:, -1:].argmax(dim=-1)
    for k in range(STEPS):
        lg, cache = step(params, cache, tok, S + k)
        tok = lg[:, -1:].argmax(dim=-1)
        out.append(lg)
    return out


@pytest.fixture(scope="module")
def served():
    return ZAMBA, _params(ZAMBA), _tokens(ZAMBA, (B, S))


def test_spans_change_no_bit(recording, served):
    want = _serve(*served)
    obs.enable()
    got = _serve(*served)
    obs.disable()
    assert len(obs.drain()) > 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _kids(spans):
    out = collections.defaultdict(list)
    for i in range(len(spans)):
        if spans.parent[i] >= 0:
            out[spans.parent[i]].append(i)
    return out


def test_each_root_holds_its_mixers_and_applications(recording, served):
    cfg = served[0]
    obs.enable()
    _serve(*served)
    obs.disable()
    spans = obs.drain()
    kids = _kids(spans)
    roots = [i for i in range(len(spans)) if spans.parent[i] < 0]
    assert [spans.named(i) for i in roots] == \
        ["serve.prefill"] + ["serve.decode_step"] * STEPS
    n_apps = len(cfg.hybrid_layer_ids)
    for r in roots:
        top = collections.Counter(spans.named(i) for i in kids[r])
        assert top["mamba"] == cfg.n_layers and top["shared"] == n_apps
        for i in kids[r]:
            inner = collections.Counter(spans.named(j) for j in kids[i])
            if spans.named(i) == "mamba":
                assert inner["mamba.scan"] == 1
            if spans.named(i) == "shared":
                assert inner["mlp"] == 1 and inner["norm"] == 2
                (m,) = (j for j in kids[i] if spans.named(j) == "mlp")
                assert [spans.named(j) for j in kids[m]] == \
                    ["shared.adapter"]
    # decode only: each layer's conv (bf16 cache) and fp32 SSM state,
    # read and written
    conv = B * 3 * (cfg.d_inner + 2 * 2 * cfg.ssm_state) * 2
    state = B * (cfg.d_inner // cfg.ssm_head_dim) * cfg.ssm_head_dim \
        * cfg.ssm_state * 4
    assert spans.counts["mamba.state_bytes"] == \
        STEPS * cfg.n_layers * 2 * (conv + state)


# --------------------------------------------------------------------- #
#  The decode step with a tensor position (what a CUDA graph replays)
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("form", ["residual", "zamba2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_position_equals_int_position_bitwise(form, dtype):
    cfg = ZAMBA if form == "zamba2" else _stand_in()
    cfg = dataclasses.replace(cfg, param_dtype=dtype, activation_dtype=dtype)
    assert model.decode_graphable(cfg)
    params = _params(cfg)
    logits, cache = model.prefill(cfg, params, _tokens(cfg, (B, S)), MAX_SEQ,
                                  device="cpu")
    twin = {k: v.clone() for k, v in cache.items()}
    tok = logits[:, -1:].argmax(dim=-1)
    for pos in range(S, S + STEPS):
        a, cache = model.decode_step(cfg, params, cache, tok, pos,
                                     device="cpu")
        b, twin = model.decode_step(cfg, params, twin, tok,
                                    torch.tensor(pos), device="cpu")
        assert torch.equal(a, b)
        assert all(torch.equal(cache[k], twin[k]) for k in cache)
        tok = a[:, -1:].argmax(dim=-1)


def test_the_graph_policy_and_the_step_counts(recording):
    """The hybrid's graph keeps its conv and SSM state across its warm-up
    and holds its cache weakly (the dense one neither); what the eager
    int-``pos`` step counts is what ``count_decode_step`` counts for a
    replay."""
    assert model.graph_policy(ZAMBA) == model.GraphPolicy(("conv", "ssm"),
                                                          True)
    assert model.graph_policy(get_config("mistral-nemo-12b")) == \
        model.GraphPolicy()
    params = _params(ZAMBA)
    _, cache = model.prefill(ZAMBA, params, _tokens(ZAMBA, (B, S)), MAX_SEQ,
                             device="cpu")
    tok = _tokens(ZAMBA, (B, 1))
    obs.enable()
    model.decode_step(ZAMBA, params, cache, tok, S, device="cpu")
    eager = obs.drain().counts
    model.count_decode_step(ZAMBA, cache, S)
    obs.disable()
    assert obs.drain().counts == eager
    assert set(eager) == {"attention.positions_attended",
                          "attention.positions_live", "mamba.state_bytes"}
