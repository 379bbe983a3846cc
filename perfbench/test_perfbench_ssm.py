"""FalconMamba in the benchmark, on the CPU: the plain reference
(``reference/ssm.py``) against transformers' ``FalconMambaForCausalLM``
(which shows that its equations are FalconMamba's) and against the
port's Mamba-1 LM with FalconMamba's mixer norms and fp32 residual
(forward, and prefill then decode through the state), a tiny ssm cell
through the harness, the counts on hand-worked cases, and the Mamba-1
scan's roofline reader.

Every comparison is fp32 against fp32, so the tolerances are summation
order's: 2e-5 (as the dense and hybrid references' tests). A port or a
reference without the three weightless mixer norms moves the logits far
outside it, and each comparison is shown to fail then."""
from __future__ import annotations

import json
import math
import os
import pathlib
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import counts, harness, port, testcells, weights
from perfbench.counts import ssm as scounts
from perfbench.reference import ssm as ref

HERE = pathlib.Path(__file__).resolve().parent
FALCON = json.loads((HERE / "configs" / "falcon-mamba-7b.json").read_text())
#: three layers, dt rank 2 (hidden_size / 16), state 8; the prompts run
#: past the reference scan's 64-step chunks
TINY_CELL = {
    "name": "tiny-ssm", "source": "test", "family": "ssm",
    "hidden_size": 32, "num_hidden_layers": 3, "intermediate_size": 64,
    "state_size": 8, "conv_kernel": 4, "time_step_rank": 2,
    "vocab_size": 256, "mixer_rms_eps": 1e-6, "layer_norm_epsilon": 1e-5,
    "residual_in_fp32": True, "use_bias": False, "use_conv_bias": True,
    "hidden_act": "silu", "tie_word_embeddings": False,
    "torch_dtype": "bfloat16"}
#: prompts past the reference scan's 64-step chunk, three of them
#: checked, so that the control's gap is read over some 300 positions
MIX = {"batch": 1, "prompt_lengths": [64, 96, 128], "output_tokens": 1,
       "check_requests": 3}
CELLS = {"tinys.prefill": "tiny-ssm-prefill"}
#: the tiny cell's limit: over 13 seeds and windows of 0.05 to 3 s (2 to
#: 162 requests served) the bf16 port read at most 0.080, the fp8
#: control at least 0.306 (a test below holds both)
LIMIT = 0.15
TINY = dict(TINY_CELL, vocab_size=64, torch_dtype="float32")
#: fp32 against fp32: the summation order (the recurrence step by step,
#: or chunked) is all that differs
TOL = dict(atol=2e-5, rtol=2e-5)


def make_home(tmp: pathlib.Path) -> tuple[pathlib.Path, dict]:
    """(a copy of the benchmark's files (:mod:`perfbench.testcells`'s)
    with a FalconMamba configuration cut to a test's size and a prefill
    cell of it, ``tinys.prefill``, listed wherever
    ``falcon-mamba-7b.prefill`` is; the spec naming it)."""
    home, spec = testcells.make_home(tmp)
    (home / "configs" / "tiny-ssm.json").write_text(json.dumps(TINY_CELL))
    (home / "mixes" / "tiny-ssm-prefill.json").write_text(json.dumps(MIX))
    for cell in CELLS:
        (home / "workloads" / f"{cell}.json").write_text(
            json.dumps({"limits": {"max_logit_gap": LIMIT}}))
    spec["workloads"] += [{"name": cell, "config": "tiny-ssm",
                           "traffic": mix, "chips": 1, "why": "a test"}
                          for cell, mix in CELLS.items()]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "falcon-mamba-7b.prefill" in m.get("workloads", ()):
            m["workloads"] = m["workloads"] + ["tinys.prefill"]
    return home, spec


def _setup(c, seed=3):
    W = weights.make(ref.weight_shapes(c), seed, "cpu", torch.float32)
    cfg, lm = port.build(c, W, "cpu")
    return W, cfg, lm


def _reference(c, W, tokens):
    return torch.cat([lg for _, lg in ref.logit_blocks(c, W, tokens)])


def _tokens(c, n, seed=1):
    return torch.randint(0, c["vocab_size"], (n,),
                         generator=torch.Generator().manual_seed(seed))


def _prefill_then_decode(cfg, lm, prompt, new):
    """The port's logits at every position: the prompt's prefill, then
    one decode step a new token (``serve.make_serve_step``), in an fp32
    cache so that every position is held to fp32."""
    from repro_torch.models import model
    from repro_torch.train import serve
    S, n = prompt.shape[1], new.shape[1]
    logits, cache = model.prefill(cfg, lm, prompt, S + n,
                                  cache_dtype=torch.float32, device="cpu")
    steps = [logits]
    step = serve.make_serve_step(cfg, device="cpu")
    for k in range(n):
        lg, cache = step(lm, cache, new[:, k:k + 1], S + k)
        steps.append(lg)
    return torch.cat(steps, dim=1)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_reference_matches_the_ports_forward(impl):
    from repro_torch.models import model
    c = TINY
    W, cfg, lm = _setup(c)
    tokens = _tokens(c, 150)
    got, _ = model.forward(cfg, lm, tokens[None], device="cpu", impl=impl)
    torch.testing.assert_close(got[0], _reference(c, W, tokens), **TOL)


def test_reference_matches_prefill_then_decode():
    c = TINY
    W, cfg, lm = _setup(c, seed=11)
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, c["vocab_size"], (2, 70), generator=g)
    new = torch.randint(0, c["vocab_size"], (2, 6), generator=g)
    got = _prefill_then_decode(cfg, lm, prompt, new)
    for row in range(2):
        want = _reference(c, W, torch.cat([prompt[row], new[row]]))
        torch.testing.assert_close(got[row], want, **TOL)


@pytest.mark.parametrize("route", ["forward", "prefill-then-decode"])
def test_a_port_without_the_mixer_norms_fails(route):
    """The port with ``mixer_rms_eps`` unset (the Mamba-1 mixer as it ran
    before FalconMamba's norms) is far outside TOL on either route."""
    import dataclasses

    from repro_torch.models import model
    c = TINY
    W, cfg, lm = _setup(c)
    bare = dataclasses.replace(cfg, mixer_rms_eps=None)
    tokens = _tokens(c, 76)
    want = _reference(c, W, tokens)
    if route == "forward":
        got = model.forward(bare, lm, tokens[None], device="cpu")[0][0]
    else:
        got = _prefill_then_decode(bare, lm, tokens[None, :70],
                                   tokens[None, 70:])[0, :-1]
        want = want[:-1]
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, want, **TOL)


def test_the_chunked_scan_is_the_recurrence():
    """:func:`ref.scan` at chunks shorter, ragged against and longer than
    the sequence, against the recurrence step by step."""
    g = torch.Generator().manual_seed(0)
    S, Di, N = 150, 16, 8
    x, B, C = (torch.randn(s, generator=g) for s in ((S, Di), (S, N),
                                                      (S, N)))
    dt = 0.2 * torch.rand((S, Di), generator=g)
    A = -16 * torch.rand((Di, N), generator=g)
    h, want = torch.zeros(Di, N), []
    for t in range(S):
        h = torch.exp(dt[t, :, None] * A) * h \
            + (dt[t] * x[t])[:, None] * B[t]
        want.append(h @ C[t])
    want = torch.stack(want)
    for chunk in (1, 7, 64, 200):
        torch.testing.assert_close(ref.scan(x, dt, A, B, C, chunk), want,
                                   **TOL)


# --------------------------------------------------------------------- #
#  The reference against transformers' FalconMamba
# --------------------------------------------------------------------- #
def _transformers_falcon_mamba(c, W, monkeypatch):
    """transformers' ``FalconMambaForCausalLM`` for ``c`` holding ``W``,
    in fp32 on the CPU (its plain ``slow_forward``; no conv kernel is
    looked up)."""
    os.environ.setdefault("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    from transformers import FalconMambaConfig
    from transformers.models.falcon_mamba import modeling_falcon_mamba
    monkeypatch.setattr(modeling_falcon_mamba, "_causal_conv1d_cache",
                        (None, None))
    D = c["hidden_size"]
    hc = FalconMambaConfig(
        vocab_size=c["vocab_size"], hidden_size=D,
        state_size=c["state_size"],
        num_hidden_layers=c["num_hidden_layers"],
        expand=c["intermediate_size"] // D, conv_kernel=c["conv_kernel"],
        time_step_rank=c["time_step_rank"],
        layer_norm_epsilon=c["layer_norm_epsilon"],
        mixer_rms_eps=c["mixer_rms_eps"],
        residual_in_fp32=c["residual_in_fp32"], use_bias=c["use_bias"],
        use_conv_bias=c["use_conv_bias"], hidden_act=c["hidden_act"],
        tie_word_embeddings=c["tie_word_embeddings"])
    assert hc.intermediate_size == c["intermediate_size"]
    torch.manual_seed(0)
    m = transformers.FalconMambaForCausalLM(hc).eval()
    with torch.no_grad():
        bb = m.backbone
        bb.embeddings.weight.copy_(W["embed.tok"])
        bb.norm_f.weight.copy_(W["final_norm"])
        m.lm_head.weight.copy_(W["embed.unembed"].T)
        for i, layer in enumerate(bb.layers):
            layer.norm.weight.copy_(W["layers.norm"][i])
            mx = layer.mixer

            def w(name):
                return W[f"layers.mamba.{name}"][i]
            for name in ("in_proj", "x_proj", "out_proj"):
                getattr(mx, name).weight.copy_(w(name).T)
            mx.conv1d.weight.copy_(w("conv_w")[:, None])
            mx.conv1d.bias.copy_(w("conv_b"))
            mx.dt_proj.weight.copy_(w("dt_proj").T)
            mx.dt_proj.bias.copy_(w("dt_bias"))
            mx.A_log.copy_(w("A_log"))
            mx.D.copy_(w("D"))
    return m


def _transformers_logits(m, tokens, prompt: int):
    """Logits at every position: the first ``prompt`` tokens in one
    forward, then one token a step through its cache (its recurrence)."""
    with torch.no_grad():
        out = m(tokens[None, :prompt], use_cache=True)
        got, cache = [out.logits[0]], out.cache_params
        for k in range(prompt, tokens.shape[0]):
            out = m(tokens[None, k:k + 1], cache_params=cache,
                    use_cache=True, cache_position=torch.tensor([k]))
            got.append(out.logits[0])
    return torch.cat(got)


def test_reference_matches_transformers_falcon_mamba(monkeypatch):
    c = TINY
    W = weights.make(ref.weight_shapes(c), 5, "cpu", torch.float32)
    m = _transformers_falcon_mamba(c, W, monkeypatch)
    tokens = _tokens(c, 76, seed=4)
    got = _transformers_logits(m, tokens, 70)
    torch.testing.assert_close(got, _reference(c, W, tokens), **TOL)


def test_a_reference_without_the_mixer_norms_fails_against_transformers(
        monkeypatch):
    c = TINY
    W = weights.make(ref.weight_shapes(c), 5, "cpu", torch.float32)
    m = _transformers_falcon_mamba(c, W, monkeypatch)
    tokens = _tokens(c, 76, seed=4)
    got = _transformers_logits(m, tokens, 70)
    monkeypatch.setattr(ref, "unit_rms", lambda x, eps: x)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, _reference(c, W, tokens), **TOL)


# --------------------------------------------------------------------- #
#  A tiny ssm cell through the harness
# --------------------------------------------------------------------- #
@pytest.fixture
def tiny(tmp_path):
    return make_home(tmp_path)


def _run(tiny, cell, traced=False, seed=2 ** 40 + 5, seconds=3.0):
    home, spec = tiny
    return harness.run_cell(cell, seed, seconds, traced, "cpu",
                            time.perf_counter(), home=home, spec=spec,
                            log=lambda msg: None)


@pytest.mark.parametrize("traced", [False, True])
def test_a_tiny_ssm_cell_runs_and_is_correct(tiny, traced):
    out = _run(tiny, "tinys.prefill", traced=traced)
    assert out["correct"] is True and out["failed"] == 0
    check = out["checks"]["max_logit_gap"]
    assert 0 <= check["value"] <= check["limit"] == LIMIT
    if not traced:
        assert set(out["metrics"]) == {"prefill_tok_per_s", "ttft_p90_ms",
                                       "setup_s"}
        return
    assert {"busy_s", "window_s"} <= set(out["device"])
    names = {m["name"] for m in harness.cell_metrics(tiny[1],
                                                     "tinys.prefill", True)}
    assert "mamba1_scan_roofline.prefill" in names
    assert set(out["metrics"]) <= names
    # the CPU has no device time: the rooflines and MFUs are absent
    assert not {"prefill_mfu", "mamba1_scan_roofline.prefill"} \
        & set(out["metrics"])


def test_the_control_reads_far_above_the_ssm_port(tiny):
    home, spec = tiny
    cl = harness.load_cell("tinys.prefill", home, spec)
    for seed in (1, 2, 3):
        served = harness.serve_seed(cl, seed, 1.0, "cpu",
                                    harness.Recorder(False))
        got = harness.readings(cl, seed, "cpu", served, control=True)
        program, control = got["max_logit_gap"], got["control.max_logit_gap"]
        assert program <= LIMIT < control


def test_the_tiny_cells_check_fails_a_port_without_the_mixer_norms(
        tiny, monkeypatch):
    """The harness's own check, at the tiny cell's limit, refuses the
    port with ``mixer_rms_eps`` unset (the reference keeps the norms)."""
    import dataclasses

    from perfbench.port import ssm as port_ssm
    configured = port_ssm.config
    monkeypatch.setattr(port_ssm, "config", lambda c: dataclasses.replace(
        configured(c), mixer_rms_eps=None))
    home, spec = tiny
    cl = harness.load_cell("tinys.prefill", home, spec)
    for seed in (1, 2, 3):
        served = harness.serve_seed(cl, seed, 1.0, "cpu",
                                    harness.Recorder(False))
        assert harness.readings(cl, seed, "cpu",
                                served)["max_logit_gap"] > LIMIT


# --------------------------------------------------------------------- #
#  The configuration, the counts and the scan's roofline
# --------------------------------------------------------------------- #
def test_weights_are_the_ports_parameters():
    """Every weight the reference makes is a parameter of the port's
    model of the same shape and dtype (laid out on ``meta``), and the
    published model holds 7.27 B of them."""
    from repro_torch.models import ssm_lm
    from perfbench.port import ssm as port_ssm
    for c in (TINY, FALCON):
        cfg = port_ssm.config(c)
        lm = ssm_lm.LM(cfg, torch.device("meta"))
        have = {}
        for name, p in lm.named_parameters():
            key, layer = port._key(name)
            have.setdefault(key, (p.shape if layer is None else
                                  (c["num_hidden_layers"], *p.shape),
                                  p.dtype))
        shapes = ref.weight_shapes(c)
        assert set(have) == set(shapes)
        for key, (shape, _, *kind) in shapes.items():
            want = torch.float32 if kind == ["float32"] else \
                getattr(torch, c["torch_dtype"])
            assert tuple(have[key][0]) == shape and have[key][1] == want
    n = sum(math.prod(s[0]) for s in ref.weight_shapes(FALCON).values())
    assert n == 7_272_665_088
    fp32 = 64 * (2 * 8192 + 8192 * 16)
    assert scounts.weight_bytes(FALCON) == 2 * (n - fp32) + 4 * fp32


@pytest.mark.parametrize("change,match", [
    ({"time_step_rank": 255}, "time_step_rank"),
    ({"intermediate_size": 4100}, "multiple"),
    ({"use_bias": True}, "bias"),
    ({"hidden_act": "gelu"}, "silu")])
def test_the_port_refuses_what_it_does_not_compute(change, match):
    from perfbench.port import ssm as port_ssm
    with pytest.raises(ValueError, match=match):
        port_ssm.config(dict(FALCON, **change))


def test_the_configuration_maps_onto_the_ports_fields():
    from perfbench.port import ssm as port_ssm
    cfg = port_ssm.config(FALCON)
    assert (cfg.d_model, cfg.n_layers, cfg.d_inner, cfg.ssm_state,
            cfg.ssm_conv, cfg.vocab_size) == (4096, 64, 8192, 16, 4, 65024)
    assert cfg.mixer_rms_eps == 1e-6 and cfg.residual_in_fp32
    assert cfg.norm_eps == 1e-5 and not cfg.tie_embeddings
    assert sorted(cfg.port_fields_set()) == ["mixer_rms_eps",
                                             "residual_in_fp32"]


TOY = {"hidden_size": 4, "num_hidden_layers": 3, "intermediate_size": 8,
       "state_size": 2, "conv_kernel": 4, "time_step_rank": 1,
       "vocab_size": 10}


def test_ssm_counts_by_hand():
    # a mixer: in_proj 4 x 16, x_proj 8 x (1 + 4), dt_proj 1 x 8,
    # out_proj 8 x 4
    mm = 64 + 40 + 8 + 32
    assert scounts.mamba_matmul_params(TOY) == mm
    # bf16: 3 x (norm 4, products, conv 8 x 4 and bias 8), the final
    # norm, the token table and the head; fp32: 3 x (dt_bias, D, A_log)
    assert scounts.weight_bytes(TOY) == \
        2 * (3 * (4 + mm + 40) + 4 + 2 * 40) + 4 * 3 * (8 + 8 + 16)
    scan_ops, scan_bytes = scounts.scan(1, 3, 8, 2)
    assert scan_ops == 4 * 3 * 8 * 2
    assert scan_bytes == 2 * (3 * 3 * 8 + 2 * 3 * 2) + 4 * (16 + 16 + 8)
    state = 3 * (2 * 3 * 8 + 4 * 8 * 2)
    assert scounts.state_bytes(TOY) == state
    ops, nbytes = scounts.prefill(TOY, 1, 3)
    assert ops == 2 * 3 * 3 * mm + 3 * scan_ops + 2 * 4 * 10
    assert nbytes == (scounts.weight_bytes(TOY) + 2 * 3 * 4 + 4 * 3
                      + state + 4 * 10)
    ops, nbytes = scounts.decode_step(TOY, 2, 5)
    step_ops, _ = scounts.scan(2, 1, 8, 2)
    assert ops == 2 * 2 * (3 * mm + 4 * 10) + 3 * step_ops
    assert nbytes == (scounts.weight_bytes(TOY) + 2 * 2 * 4 + 4 * 2
                      + 2 * 2 * state + 4 * 2 * 10)


def test_mamba1_scan_roofline_reads_the_mamba1_kernels_device_time():
    peak = counts.peaks("NVIDIA H100 80GB HBM3")
    c = FALCON
    read = harness.reader(HERE, "mamba1_scan_roofline.prefill")
    least = 64 * (counts.least_seconds(*scounts.scan(1, 8192, 8192, 16),
                                       peak)
                  + counts.least_seconds(*scounts.scan(1, 512, 8192, 16),
                                         peak))

    def rec(issued, S):
        return SimpleNamespace(issued=issued, arrivals=[issued + 1],
                               req=SimpleNamespace(batch=1, prompt_len=S))

    def run(device_s, t_traced=1.0, counted=scounts):
        tr = SimpleNamespace(device_ops=[
            ["void (anonymous namespace)::mamba_scan_kernel<16, 2, 8>(...)",
             device_s],
            # the Mamba-2 route's kernel is not this metric's
            ["void (anonymous namespace)::mamba_scan_mamba2_kernel<bf16>",
             5.0], ["nvjet_gemm", 1.0]])
        # one prefill before the trace began, two inside it
        recs = [rec(0.5, 4096), rec(1.5, 8192), rec(2.5, 512)]
        return harness.Run("c", c, {}, counted, peak, 0.0, 0.0, 3.0, recs,
                           tr, t_traced)
    assert read(run(least / 0.25)) == pytest.approx(25.0)
    assert read(run(0.0)) is None
    assert read(run(1.0, t_traced=9.0)) is None
    assert read(run(1.0, counted=SimpleNamespace())) is None
