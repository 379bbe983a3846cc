"""The port's spans and counters (``repro_torch.obs``) on the CPU.

A reduced dense config (Mistral-NeMo's ``reduce_for_smoke``: 4 layers,
d_model 64) serves a prefill and three decode steps through
``train.serve``. Recording off costs nothing and leaves nothing; on, it
changes no bit of the output and no aten op, every step is one root
holding one ``layer`` span a layer with the children the serving path
names, the two counters of ``attention_decode`` are what its mask keeps,
and the spans, shifted by ``epoch_offset_ns()``, sit on the profiler's
clock.
"""
from __future__ import annotations

import collections
import dataclasses

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import base, get_config
from repro_torch.models import attention as attn_mod
from repro_torch.models import model
from repro_torch.train import serve

B, S, MAX_SEQ, STEPS = 2, 12, 24, 3
ROOTS = ("serve.prefill", "serve.decode_step")
#: each layer's direct children, as many of each as a layer holds
LAYER_CHILDREN = {
    "serve.prefill": {"norm": 2, "attention.project": 1,
                      "attention.attend": 1, "attention.out": 1, "mlp": 1,
                      "attention.cache_write": 1},
    "serve.decode_step": {"norm": 2, "attention.project": 1,
                          "attention.cache_write": 1, "attention.attend": 1,
                          "attention.out": 1, "mlp": 1},
}


@pytest.fixture
def recording():
    """Recording starts off and empty, and is left so."""
    obs.disable()
    obs.drain()
    yield
    obs.disable()
    obs.drain()


def _cfg(**kw):
    return dataclasses.replace(
        base.reduce_for_smoke(get_config("mistral-nemo-12b")), **kw)


def _serve(cfg, params, tokens):
    """(prefill logits, [each decode step's logits], tokens served)."""
    logits, cache = serve.make_prefill_step(cfg, MAX_SEQ, device="cpu")(
        params, tokens)
    step = serve.make_serve_step(cfg, device="cpu")
    tok = logits[:, -1:].argmax(dim=-1)
    out, toks = [], [tok]
    for k in range(STEPS):
        lg, cache = step(params, cache, tok, S + k)
        tok = lg[:, -1:].argmax(dim=-1)
        out.append(lg)
        toks.append(tok)
    return logits, out, torch.cat(toks, dim=1)


@pytest.fixture(scope="module")
def served():
    cfg = _cfg()
    params = model.init(cfg, torch.Generator().manual_seed(3), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(4))
    return cfg, params, tokens


def _recorded(served):
    obs.enable()
    try:
        out = _serve(*served)
    finally:
        obs.disable()
    return out, obs.drain()


def test_off_records_nothing_and_shares_one_no_op(recording, served):
    assert obs.span("norm") is obs.span("layer")
    _serve(*served)
    obs.count("attention.positions_live", 5)
    got = obs.drain()
    assert len(got) == 0 and got.counts == {}


def test_spans_change_no_bit_of_the_output(recording, served):
    want = _serve(*served)
    got, spans = _recorded(served)
    assert len(spans) > 0
    assert torch.equal(got[0], want[0])
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)
    assert torch.equal(got[2], want[2])


def _children(spans):
    kids = collections.defaultdict(list)
    for i in range(len(spans)):
        if spans.parent[i] >= 0:
            kids[spans.parent[i]].append(i)
    return kids


@pytest.mark.parametrize("root", ROOTS)
def test_each_root_holds_its_layers_and_their_children(recording, served,
                                                       root):
    cfg = served[0]
    _, spans = _recorded(served)
    roots = [i for i in range(len(spans)) if spans.parent[i] < 0]
    assert [spans.named(i) for i in roots] == \
        ["serve.prefill"] + ["serve.decode_step"] * STEPS
    kids = _children(spans)
    for r in (i for i in roots if spans.named(i) == root):
        names = [spans.named(i) for i in kids[r]]
        assert names == ["embed"] + ["layer"] * cfg.n_layers + \
            ["norm", "unembed"]
        for lay in (i for i in kids[r] if spans.named(i) == "layer"):
            got = collections.Counter(spans.named(i) for i in kids[lay])
            assert got == LAYER_CHILDREN[root]
            proj, = (i for i in kids[lay]
                     if spans.named(i) == "attention.project")
            assert [spans.named(i) for i in kids[proj]] == \
                ["attention.rope"] * 2


@pytest.mark.parametrize("root", ROOTS)
def test_parents_hold_children_and_spans_carry_their_root(recording, served,
                                                         root):
    _, spans = _recorded(served)
    for i in range(len(spans)):
        assert spans.start[i] <= spans.end[i]
        p = spans.parent[i]
        if p < 0:
            assert spans.root[i] == i
            continue
        assert spans.start[p] <= spans.start[i] <= spans.end[i] <= \
            spans.end[p]
        assert spans.root[i] == spans.root[p]
    under = [i for i in range(len(spans))
             if spans.named(spans.root[i]) == root]
    # about ten spans a layer, every one inside its own step's root
    assert len(under) >= 10 * served[0].n_layers * (
        STEPS if root == "serve.decode_step" else 1)


def _mask_count(pos, S_max, window):
    """The decode mask's live slots, enumerated as ``attention_decode``
    builds them."""
    ring = window is not None and S_max <= window
    live = 0
    for j in range(S_max):
        if ring:
            live += j <= pos or pos >= S_max
        else:
            live += j <= pos and (window is None or j > pos - window)
    return live


@pytest.mark.parametrize("S_max,window", [(16, None), (16, 4), (8, 8),
                                          (8, 32)])
@pytest.mark.parametrize("pos", [0, 3, 7, 12])
def test_decode_counters_count_what_the_mask_keeps(recording, S_max, window,
                                                   pos):
    cfg = _cfg(sliding_window=window)
    p = attn_mod.init_attention(cfg, torch.Generator().manual_seed(0), "cpu")
    hd = cfg.resolved_head_dim
    ck = torch.zeros(B, cfg.n_kv_heads, S_max, hd)
    cv = torch.zeros_like(ck)
    x = torch.randn(B, 1, cfg.d_model)
    obs.enable()
    attn_mod.attention_decode(p, x, ck, cv, pos, cfg)
    obs.disable()
    counts = obs.drain().counts
    assert counts == {"attention.positions_attended": B * S_max,
                      "attention.positions_live":
                      B * _mask_count(pos, S_max, window)}


def _aten_ops(prof) -> collections.Counter:
    return collections.Counter(e.name() for e in
                               prof.profiler.kineto_results.events()
                               if e.name().startswith("aten::"))


@pytest.mark.parametrize("root", ROOTS)
def test_spans_add_no_aten_op(recording, served, root):
    from torch.profiler import ProfilerActivity, profile
    cfg, params, tokens = served
    prefill = serve.make_prefill_step(cfg, MAX_SEQ, device="cpu")
    step = serve.make_serve_step(cfg, device="cpu")
    _, cache = prefill(params, tokens)
    tok = tokens[:, -1:]

    def once():
        if root == "serve.prefill":
            prefill(params, tokens)
        else:
            step(params, cache, tok, S)

    seen = []
    for on in (False, True, False):
        if on:
            obs.enable()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            once()
        obs.disable()
        seen.append(_aten_ops(prof))
    assert seen[1] == seen[0] == seen[2]
    assert sum(seen[0].values()) > 0


def test_spans_sit_on_the_profilers_clock(recording):
    from torch.profiler import ProfilerActivity, profile, record_function
    tol = 50_000     # ns
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("outside"):
            obs.enable()
            with obs.span("probe"):
                with record_function("inside"):
                    torch.ones(64).add_(1)
            obs.disable()
    spans = obs.drain()
    assert len(spans) == 1
    s = spans.start[0] + spans.epoch_offset_ns
    e = spans.end[0] + spans.epoch_offset_ns
    ev = {x.name(): (x.start_ns(), x.start_ns() + x.duration_ns())
          for x in prof.profiler.kineto_results.events()
          if x.name() in ("outside", "inside")}
    assert ev["outside"][0] - tol <= s <= ev["inside"][0] + tol
    assert ev["inside"][1] - tol <= e <= ev["outside"][1] + tol
    assert spans.epoch_offset_ns == obs.epoch_offset_ns()


def test_drain_refuses_an_open_span(recording):
    obs.enable()
    with obs.span("serve.decode_step"):
        with pytest.raises(RuntimeError):
            obs.drain()
    obs.disable()
    assert [obs.drain().named(0)] == ["serve.decode_step"]


def test_enable_with_names_records_those_alone(recording, served):
    obs.enable(ROOTS)
    try:
        _serve(*served)
    finally:
        obs.disable()
    spans = obs.drain()
    got = [spans.named(i) for i in range(len(spans))]
    assert got == ["serve.prefill"] + ["serve.decode_step"] * STEPS
    assert all(p == -1 for p in spans.parent)
    assert spans.counts["attention.positions_attended"] > 0
    # a plain enable records every span again
    _, every = _recorded(served)
    assert len(every) > 10 * len(spans)
