"""Zamba2 in the benchmark, on the CPU: the plain reference
(``reference/hybrid.py``) against transformers' ``Zamba2ForCausalLM``
(which shows that its equations are Zamba2's) and against the port's
hybrid in its ``"zamba2"`` form (forward, and prefill then decode through
the cache), tiny hybrid cells through the harness, the counts on
hand-worked cases, and the scan's roofline reader.

Every comparison is fp32 against fp32, so the tolerances are summation
order's: 2e-5 (as the dense reference's test). Computing the SSM state in
bf16, or the scan's inputs, moves the logits by ~1e-3 here, and each
tolerance is shown to fail then."""
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
from perfbench.counts import hybrid as hcounts
from perfbench.reference import hybrid as ref

HERE = pathlib.Path(__file__).resolve().parent
ZAMBA = json.loads((HERE / "configs" / "zamba2-7b.json").read_text())
#: two groups, two shared blocks applied at uneven layers, a head dim
#: (16) that is not d_model / heads (8), a scan chunk (8) shorter than
#: the prompts
TINY_CELL = {
    "name": "tiny-hybrid", "source": "test", "family": "hybrid",
    "hidden_size": 32, "num_hidden_layers": 7, "num_attention_heads": 4,
    "num_key_value_heads": 4, "attention_head_dim": 16,
    "intermediate_size": 48, "vocab_size": 256, "mamba_d_state": 8,
    "mamba_d_conv": 4, "mamba_expand": 2, "mamba_headdim": 16,
    "n_mamba_heads": 4, "mamba_ngroups": 2, "num_mem_blocks": 2,
    "adapter_rank": 4, "hybrid_layer_ids": [1, 4, 5], "chunk_size": 8,
    "rope_theta": 10000, "rms_norm_eps": 1e-5, "hidden_act": "gelu",
    "torch_dtype": "bfloat16"}
CELLS = {"tinyh.prefill": "tiny-prefill", "tinyh.decode": "tiny-decode"}
#: tiny cells' limit: the bf16 port read at most 0.041 (prefill) and
#: 0.028 (decode) over 8 seeds and two windows, the fp8 control at least
#: 0.120 and 0.088 (a test below holds both)
LIMIT = 0.06


def make_home(tmp: pathlib.Path) -> tuple[pathlib.Path, dict]:
    """(a copy of the benchmark's files (:mod:`perfbench.testcells`'s,
    with its tiny dense cells) with a Zamba2 configuration cut to a
    test's size and two cells of it added, ``tinyh.prefill`` and
    ``tinyh.decode`` on the tiny mixes, listed wherever the Zamba2-7B
    cells are; the spec naming them)."""
    home, spec = testcells.make_home(tmp)
    (home / "configs" / "tiny-hybrid.json").write_text(
        json.dumps(TINY_CELL))
    for cell in CELLS:
        (home / "workloads" / f"{cell}.json").write_text(
            json.dumps({"limits": {"max_logit_gap": LIMIT}}))
    spec["workloads"] += [{"name": cell, "config": "tiny-hybrid",
                           "traffic": mix, "chips": 1, "why": "a test"}
                          for cell, mix in CELLS.items()]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] = m["workloads"] + [
                w.replace("zamba2-7b", "tinyh") for w in m["workloads"]
                if w.startswith("zamba2-7b.")]
    return home, spec


TINY = dict(TINY_CELL, vocab_size=64, torch_dtype="float32")
#: fp32 against fp32: the summation order (a sequential recurrence, or a
#: chunked SSD; blocked or flash attention) is all that differs
TOL = dict(atol=2e-5, rtol=2e-5)
CASES = {
    "two-groups": TINY,
    # one group, three blocks over four applications (the last at the
    # last layer), 2 heads of 32 (Zamba2's 2 d_model / heads) on d_model 32
    "three-blocks": dict(TINY, mamba_ngroups=1, num_mem_blocks=3,
                         hybrid_layer_ids=[0, 2, 3, 6],
                         num_attention_heads=2, num_key_value_heads=2,
                         attention_head_dim=32, adapter_rank=2),
}


def _setup(c, seed=3):
    W = weights.make(ref.weight_shapes(c), seed, "cpu", torch.float32)
    cfg, lm = port.build(c, W, "cpu")
    return W, cfg, lm


def _reference(c, W, tokens):
    return torch.cat([lg for _, lg in ref.logit_blocks(c, W, tokens)])


def _tokens(c, n, seed=1):
    return torch.randint(0, c["vocab_size"], (n,),
                         generator=torch.Generator().manual_seed(seed))


def _bf16_state_scan(u, dt, A, Bm, Cm, D):
    """The kernel's scan (from a zero state) with its inputs and its state
    rounded to bf16 at every step."""
    Bsz, L, Di = u.shape
    r = [t.bfloat16().float() for t in (u, dt, Bm, Cm)]
    u, dt, Bm, Cm = r
    h = torch.zeros(Bsz, Di, A.shape[1])
    ys = []
    for t in range(L):
        h = (torch.exp(dt[:, t, :, None] * A) * h
             + (dt[:, t] * u[:, t])[..., None] * Bm[:, t, None, :])
        h = h.bfloat16().float()
        ys.append((h * Cm[:, t, None, :]).sum(-1) + D * u[:, t])
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("impl", ["flash", "xla"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_the_ports_forward(case, impl):
    from repro_torch.models import model
    c = CASES[case]
    W, cfg, lm = _setup(c)
    tokens = _tokens(c, 21)
    got, _ = model.forward(cfg, lm, tokens[None], device="cpu", impl=impl)
    torch.testing.assert_close(got[0], _reference(c, W, tokens), **TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_prefill_then_decode(case):
    from repro_torch.models import model
    from repro_torch.train import serve
    c = CASES[case]
    W, cfg, lm = _setup(c, seed=11)
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, c["vocab_size"], (2, 11), generator=g)
    new = torch.randint(0, c["vocab_size"], (2, 6), generator=g)
    # an fp32 cache, so that every position is held to fp32
    logits, cache = model.prefill(cfg, lm, prompt, 17,
                                  cache_dtype=torch.float32, device="cpu")
    steps = [logits]
    step = serve.make_serve_step(cfg, device="cpu")
    for k in range(6):
        lg, cache = step(lm, cache, new[:, k:k + 1], 11 + k)
        steps.append(lg)
    got = torch.cat(steps, dim=1)
    for row in range(2):
        want = _reference(c, W, torch.cat([prompt[row], new[row]]))
        torch.testing.assert_close(got[row], want, **TOL)


def test_a_bf16_state_fails_the_tolerance(monkeypatch):
    """The forward's scan kernel with a bf16 state and inputs, and the
    decode's state kept in bf16 between steps: each is outside TOL."""
    from repro_torch.kernels import ops
    from repro_torch.models import model, ssm
    c = TINY
    W, cfg, lm = _setup(c)
    tokens = _tokens(c, 21)
    want = _reference(c, W, tokens)
    with monkeypatch.context() as m:
        m.setattr(ops, "mamba_scan", _bf16_state_scan)
        got, _ = model.forward(cfg, lm, tokens[None], device="cpu")
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got[0], want, **TOL)
    scan = ssm.mamba2_scan

    def bf16_state(*args):
        y, h = scan(*args)
        return y, h.bfloat16().float()
    monkeypatch.setattr(ssm, "mamba2_scan", bf16_state)
    logits, cache = model.prefill(cfg, lm, tokens[None, :5], 21,
                                  cache_dtype=torch.float32, device="cpu")
    steps = [logits]
    for k in range(5, 21):
        lg, cache = model.decode_step(cfg, lm, cache, tokens[None, k:k + 1],
                                      k, device="cpu")
        steps.append(lg)
    got = torch.cat(steps, dim=1)[0, :-1]
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, want[:-1], **TOL)


# --------------------------------------------------------------------- #
#  The reference against transformers' Zamba2
# --------------------------------------------------------------------- #
def _transformers_zamba2(c, W):
    """transformers' ``Zamba2ForCausalLM`` for ``c`` holding ``W``, in
    fp32 on the CPU (its plain ``torch_forward``). Each mixer's
    ``time_step_min`` is set to 0: its plain path clamps dt from below at
    ``time_step_min``, its CUDA path at ``time_step_limit`` (null: no
    clamp), and a clamp at 0 is none for a softplus."""
    os.environ.setdefault("USE_TF", "0")
    transformers = pytest.importorskip("transformers")
    from transformers import Zamba2Config
    L, apps = c["num_hidden_layers"], list(c["hybrid_layer_ids"])
    hc = Zamba2Config(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        num_hidden_layers=L,
        layers_block_type=["hybrid" if i in apps else "mamba"
                           for i in range(L)],
        mamba_d_state=c["mamba_d_state"], mamba_d_conv=c["mamba_d_conv"],
        mamba_expand=c["mamba_expand"], mamba_ngroups=c["mamba_ngroups"],
        n_mamba_heads=c["n_mamba_heads"],
        intermediate_size=c["intermediate_size"],
        hidden_act=c["hidden_act"],
        num_attention_heads=c["num_attention_heads"],
        num_key_value_heads=c["num_key_value_heads"],
        num_mem_blocks=c["num_mem_blocks"],
        use_shared_attention_adapter=False, adapter_rank=c["adapter_rank"],
        use_mem_rope=True, rope_theta=c["rope_theta"],
        rms_norm_eps=c["rms_norm_eps"], chunk_size=c["chunk_size"],
        attn_implementation="eager")
    assert hc.attention_head_dim == c["attention_head_dim"]
    assert hc.mamba_headdim == c["mamba_headdim"]
    torch.manual_seed(0)
    m = transformers.Zamba2ForCausalLM(hc).eval()
    at = {layer: a for a, layer in enumerate(apps)}
    nb = c["num_mem_blocks"]
    with torch.no_grad():
        mm = m.model
        mm.embed_tokens.weight.copy_(W["embed.tok"])       # lm_head is tied
        mm.final_layernorm.weight.copy_(W["final_norm"])
        for i, layer in enumerate(mm.layers):
            dec = layer.mamba_decoder if i in at else layer
            dec.input_layernorm.weight.copy_(W["layers.norm"][i])
            mx = dec.mamba
            mx.time_step_min = 0.0
            mx.in_proj.weight.copy_(W["layers.mamba.in_proj"][i].T)
            mx.conv1d.weight.copy_(W["layers.mamba.conv_w"][i][:, None])
            mx.conv1d.bias.copy_(W["layers.mamba.conv_b"][i])
            for n in ("A_log", "dt_bias", "D"):
                getattr(mx, n).copy_(W[f"layers.mamba.{n}"][i])
            mx.norm.weight.copy_(W["layers.mamba.norm_w"][i])
            mx.out_proj.weight.copy_(W["layers.mamba.out_proj"][i].T)
            if i not in at:
                continue
            a = at[i]
            b = a % nb
            st = layer.shared_transformer
            assert st.block_id == b
            st.input_layernorm.weight.copy_(W["shared.attn_norm"][b])
            st.pre_ff_layernorm.weight.copy_(W["shared.mlp_norm"][b])
            for n in "qkvo":
                getattr(st.self_attn, f"{n}_proj").weight.copy_(
                    W[f"shared.attn.w{n}"][b].T)
            ff = st.feed_forward
            ff.gate_up_proj.weight.copy_(torch.cat(
                [W["shared.mlp.w_gate"][b], W["shared.mlp.w_up"][b]], 1).T)
            ff.down_proj.weight.copy_(W["shared.mlp.w_down"][b].T)
            lora = ff.gate_up_proj_adapter_list[a]
            lora[0].weight.copy_(W["apps.lora_a"][a].T)
            lora[1].weight.copy_(W["apps.lora_b"][a].T)
            layer.linear.weight.copy_(W["apps.linear"][a].T)
    return m


def _transformers_logits(m, tokens, prompt: int):
    """Logits at every position: the first ``prompt`` tokens in one
    forward, then one token a step through its cache (its recurrence).
    (Its plain prefill sums the chunks' carried states over the wrong
    index, ``.sum(dim=2)`` in ``torch_forward``, so it is exact only
    within one chunk: the prompt stays within ``chunk_size``.)"""
    with torch.no_grad():
        out = m(tokens[None, :prompt], use_cache=True)
        got, cache = [out.logits[0]], out.past_key_values
        for k in range(prompt, tokens.shape[0]):
            out = m(tokens[None, k:k + 1], past_key_values=cache,
                    use_cache=True, cache_position=torch.tensor([k]))
            got.append(out.logits[0])
    return torch.cat(got)


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_matches_transformers_zamba2(case):
    c = CASES[case]
    W = weights.make(ref.weight_shapes(c), 5, "cpu", torch.float32)
    m = _transformers_zamba2(c, W)
    tokens = _tokens(c, 21, seed=4)
    got = _transformers_logits(m, tokens, c["chunk_size"])
    torch.testing.assert_close(got, _reference(c, W, tokens), **TOL)


def test_a_bf16_scan_fails_against_transformers(monkeypatch):
    c = TINY
    W = weights.make(ref.weight_shapes(c), 5, "cpu", torch.float32)
    m = _transformers_zamba2(c, W)
    tokens = _tokens(c, 21, seed=4)
    got = _transformers_logits(m, tokens, c["chunk_size"])
    ssd = ref.ssd

    def bf16_ssd(x, dt, A, B, C, chunk):
        return ssd(*(t.bfloat16().float() for t in (x, dt)), A,
                   *(t.bfloat16().float() for t in (B, C)), chunk)
    monkeypatch.setattr(ref, "ssd", bf16_ssd)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, _reference(c, W, tokens), **TOL)


# --------------------------------------------------------------------- #
#  Tiny hybrid cells through the harness
# --------------------------------------------------------------------- #
@pytest.fixture
def tiny(tmp_path):
    return make_home(tmp_path)


def _run(tiny, cell, traced=False, seed=2 ** 40 + 5, seconds=4.0):
    home, spec = tiny
    return harness.run_cell(cell, seed, seconds, traced, "cpu",
                            time.perf_counter(), home=home, spec=spec,
                            log=lambda msg: None)


@pytest.mark.parametrize("cell,e2e", [
    ("tinyh.prefill", {"prefill_tok_per_s", "ttft_p90_ms", "setup_s"}),
    ("tinyh.decode", {"decode_tok_per_s", "itl_p95_ms", "setup_s"})])
def test_a_tiny_hybrid_cell_runs_and_is_correct(tiny, cell, e2e):
    out = _run(tiny, cell)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == e2e
    check = out["checks"]["max_logit_gap"]
    assert 0 <= check["value"] <= check["limit"] == LIMIT


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_a_traced_tiny_hybrid_cell_gives_the_trace_keys(tiny, cell):
    out = _run(tiny, cell, traced=True, seconds=2.0)
    assert out["correct"] is True
    assert {"busy_s", "window_s"} <= set(out["device"])
    names = {m["name"] for m in harness.cell_metrics(tiny[1], cell, True)}
    assert set(out["metrics"]) <= names
    # the CPU has no device time: the rooflines and MFUs are absent
    assert not {"prefill_mfu", "decode_mfu", "attn_roofline.prefill",
                "scan_roofline.prefill"} & set(out["metrics"])


def test_the_control_reads_far_above_the_hybrid(tiny):
    home, spec = tiny
    cl = harness.load_cell("tinyh.decode", home, spec)
    for seed in (1, 2, 3):
        served = harness.serve_seed(cl, seed, 1.0, "cpu",
                                    harness.Recorder(False))
        got = harness.readings(cl, seed, "cpu", served, control=True)
        program, control = got["max_logit_gap"], got["control.max_logit_gap"]
        assert program <= LIMIT < control


# --------------------------------------------------------------------- #
#  Counts and the scan's roofline
# --------------------------------------------------------------------- #
def test_weights_are_the_ports_parameters():
    from perfbench.port import hybrid as port_hybrid
    for c in (TINY, ZAMBA):
        n = port_hybrid.config(c).param_count()
        fp32 = 3 * c["n_mamba_heads"] * c["num_hidden_layers"]
        assert hcounts.weight_bytes(c) == 2 * n + 2 * fp32
        assert n == sum(math.prod(s[0])
                        for s in ref.weight_shapes(c).values())
    assert port_hybrid.config(ZAMBA).param_count() == 7_356_749_648


TOY = {"hidden_size": 4, "num_hidden_layers": 3, "mamba_expand": 2,
       "n_mamba_heads": 2, "mamba_headdim": 4, "mamba_ngroups": 2,
       "mamba_d_state": 2, "mamba_d_conv": 4, "num_attention_heads": 2,
       "num_key_value_heads": 1, "attention_head_dim": 4,
       "intermediate_size": 6, "vocab_size": 10, "adapter_rank": 1,
       "num_mem_blocks": 2, "hybrid_layer_ids": [1, 2]}


def test_hybrid_counts_by_hand():
    # a mixer: in_proj 4 x (8 + 16 + 2), out_proj 8 x 4
    mm = 4 * 26 + 32
    assert hcounts.mamba_matmul_params(TOY) == mm
    # an application: q 8x8, k and v 8x4 each, o 8x4, the MLP 3 x 4 x 6,
    # the LoRA 4x1 + 1x12, the linear 4x4
    sh = 64 + 64 + 32 + 72 + 16 + 16
    assert hcounts.shared_matmul_params(TOY) == sh
    scan_ops, scan_bytes = hcounts.scan(1, 3, 2, 4, 2, 2)
    assert scan_ops == 4 * 3 * 2 * 4 * 2
    assert scan_bytes == 2 * (2 * 3 * 8 + 3 * 2 + 2 * 3 * 2 * 2) \
        + 4 * (2 * 4 * 2 + 4)
    ops, nbytes = hcounts.prefill(TOY, 1, 3)
    # 2 applications x 4 x hd x 2 heads x 6 live pairs; the last logits
    attn = 2 * 4 * 4 * 2 * 6
    assert ops == 2 * 3 * (3 * mm + 2 * sh) + 3 * scan_ops + attn \
        + 2 * 4 * 10
    state = 3 * (2 * 3 * 16 + 4 * 2 * 4 * 2)
    kv = 2 * 2 * 2 * 1 * 4                  # bf16 x apps x k,v x Hkv x hd
    assert nbytes == (hcounts.weight_bytes(TOY) + 2 * 3 * 4 + 4 * 3
                      + 3 * kv + state + 4 * 10)
    ops, nbytes = hcounts.decode_step(TOY, 2, 5)   # writes position 5
    step_ops, _ = hcounts.scan(2, 1, 2, 4, 2, 2)
    assert ops == 2 * 2 * (3 * mm + 2 * sh + 4 * 10) + 3 * step_ops \
        + 2 * (4 * 4 * 2 * 2 * 6)
    assert nbytes == (hcounts.weight_bytes(TOY) + 2 * 2 * 4 + 4 * 2
                      + 2 * 5 * kv + 2 * kv + 2 * 2 * state + 4 * 2 * 10)


def test_scan_roofline_reads_the_scan_kernels_device_time():
    peak = counts.peaks("NVIDIA H100 80GB HBM3")
    c = ZAMBA
    read = harness.reader(HERE, "scan_roofline.prefill")
    least = c["num_hidden_layers"] * counts.least_seconds(*hcounts.scan(
        1, 4096, 112, 64, 2, 64), peak)

    def rec(issued, S):
        return SimpleNamespace(issued=issued, arrivals=[issued + 1],
                               req=SimpleNamespace(batch=1, prompt_len=S))

    def run(device_s, t_traced=1.0, counted=hcounts):
        tr = SimpleNamespace(device_ops=[
            ["void (anonymous namespace)::mamba_scan_kernel<64, 8>(...)",
             device_s], ["nvjet_gemm", 1.0]])
        # one prefill before the trace began, two inside it
        recs = [rec(0.5, 512), rec(1.5, 4096), rec(2.5, 4096)]
        return harness.Run("c", c, {}, counted, peak, 0.0, 0.0, 3.0, recs,
                           tr, t_traced)
    assert read(run(2 * least * 50)) == pytest.approx(2.0)
    assert read(run(0.0)) is None
    assert read(run(1.0, t_traced=9.0)) is None
    assert read(run(1.0, counted=SimpleNamespace())) is None
