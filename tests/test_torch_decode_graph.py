"""The decode step with its position as a device tensor, and the serve step
that replays it as a CUDA graph (``repro_torch.train.serve``).

On the CPU: ``attention_decode`` and ``transformer.decode_step`` with a 0-d
int64 tensor ``pos`` give the int route's logits and cache bit for bit
(the tensor route changes where the position is read, not an operation's
values), and the serve step stays eager there. On the card (``cuda``
marker, skipped without one; no JAX is imported here)::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_decode_graph.py

the graph's steps against the eager int-route steps: the same greedy
tokens and the same logits bit for bit (the replay runs the kernels the
eager step launches: a bf16 step's attention in the decode-attention
kernel, an fp32 step's in the plain path over the decode mask), a second
cache copied in mid-way, the graph's counters and the position counters
counted on the host.
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro_torch import obs
from repro_torch.configs import get_config
from repro_torch.configs.base import reduce_for_smoke, with_port_fields
from repro_torch.kernels import mamba2_step as m5
from repro_torch.models import attention as attn, model, transformer
from repro_torch.train import serve

#: window, cache positions asked for, the first decode position
CASES = {
    "causal": (None, 16, 9),
    "window_wider_than_cache": (32, 16, 9),
    "ring_past_its_wrap": (8, 16, 5),        # an 8-slot ring, 5 .. 10
}
STEPS = 6


def _cfg(window, dtype="float32"):
    return dataclasses.replace(reduce_for_smoke(get_config(
        "mistral-nemo-12b")), sliding_window=window, param_dtype=dtype,
        activation_dtype=dtype)


def _clone(cache):
    return {k: {s: t.clone() for s, t in v.items()} for k, v in cache.items()}


def _same_cache(a, b) -> bool:
    return all(torch.equal(a[k][s], b[k][s]) for k in a for s in a[k])


@pytest.fixture(autouse=True)
def _obs_off():
    yield
    obs.disable()
    obs.drain()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tensor_position_equals_int_position_bitwise(case, dtype):
    """One decode attention, then ``STEPS`` decode steps of a prefilled
    model, each through an int ``pos`` and a 0-d int64 tensor ``pos`` on
    twin caches: equal outputs and caches, bit for bit."""
    window, max_seq, pos0 = CASES[case]
    cfg = _cfg(window, dtype)
    params = model.init(cfg, device="cpu")
    g = torch.Generator().manual_seed(3)

    lp = params.layers[0]
    S_alloc = max_seq if window is None else min(max_seq, window)
    shape = (2, cfg.n_kv_heads, S_alloc, cfg.resolved_head_dim)
    dt = lp.attn.wq.dtype
    x = torch.randn((2, 1, cfg.d_model), generator=g).to(dt)
    ck, cv = (torch.randn(shape, generator=g).to(dt) for _ in range(2))
    # a ring wraps at the second position; a causal cache also takes a
    # window narrower than itself (the linear cache's windowed mask)
    runs = ([(cfg, pos0), (cfg, pos0 + S_alloc)] if window else
            [(cfg, pos0), (dataclasses.replace(cfg, sliding_window=4), pos0)])
    for c, pos in runs:
        a = attn.attention_decode(lp.attn, x, ck.clone(), cv.clone(), pos, c)
        b = attn.attention_decode(lp.attn, x, ck.clone(), cv.clone(),
                                  torch.tensor(pos), c)
        for u, w in zip(a, b):
            assert torch.equal(u, w)

    tokens = torch.randint(0, cfg.vocab_size, (2, pos0), generator=g)
    logits, cache = model.prefill(cfg, params, tokens, max_seq, device="cpu")
    twin = _clone(cache)
    tok = logits[:, -1:].argmax(dim=-1)
    for pos in range(pos0, pos0 + STEPS):
        a, cache = transformer.decode_step(params, cache, tok, pos, cfg)
        b, twin = transformer.decode_step(params, twin, tok,
                                          torch.tensor(pos), cfg)
        assert torch.equal(a, b)
        assert _same_cache(cache, twin)
        tok = a[:, -1:].argmax(dim=-1)


def test_serve_step_on_the_cpu_stays_eager():
    """The serve step on the CPU is ``model.decode_step`` with an int
    ``pos``: the same logits and cache, the position counters of every
    layer, and no ``serve.graph_*`` counter."""
    cfg = _cfg(None)
    assert model.decode_graphable(cfg)
    params = model.init(cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 9),
                           generator=torch.Generator().manual_seed(4))
    logits, cache = model.prefill(cfg, params, tokens, 16, device="cpu")
    twin = _clone(cache)
    tok = logits[:, -1:].argmax(dim=-1)
    step = serve.make_serve_step(cfg, device="cpu")
    obs.enable()
    for pos in range(9, 12):
        a, cache = step(params, cache, tok, pos)
        b, twin = model.decode_step(cfg, params, twin, tok, pos,
                                    device="cpu")
        assert torch.equal(a, b) and _same_cache(cache, twin)
        tok = a[:, -1:].argmax(dim=-1)
    obs.disable()
    counts = obs.drain().counts
    assert not [k for k in counts if k.startswith("serve.graph_")]
    layers = 2 * cfg.n_layers                 # the step's and the twin's
    assert counts["attention.positions_attended"] == layers * 3 * 2 * 16
    assert counts["attention.positions_live"] == layers * 2 * (10 + 11 + 12)


def test_tensor_position_is_checked():
    """A tensor ``pos`` must be 0-d int64 on the step's device; a family
    that declares no capturable step takes its value."""
    cfg = _cfg(None)
    params = model.init(cfg, device="cpu")
    _, cache = model.prefill(cfg, params, torch.zeros((1, 3), dtype=torch.long),
                             8, device="cpu")
    tok = torch.zeros((1, 1), dtype=torch.long)
    for bad in (torch.tensor([3]), torch.tensor(3, dtype=torch.int32)):
        with pytest.raises(ValueError, match="0-d int64"):
            model.decode_step(cfg, params, cache, tok, bad, device="cpu")
    assert not model.decode_graphable(reduce_for_smoke(get_config(
        "falcon-mamba-7b")))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA graph has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,window", [("float32", None),
                                          ("bfloat16", None),
                                          ("bfloat16", 48)])
def test_graph_step_equals_the_eager_step_on_the_card(dtype, window):
    """20 steps of B 4 in a 256-position cache (a 48-slot ring with the
    window) through the serve step, a second request's cache passed in
    after 10, against the same steps through ``model.decode_step`` with
    an int ``pos``: equal greedy tokens and logits bit for bit, and equal
    caches at the end; one capture, one cache copy, 18 replays; the
    position counters as the eager steps count them. Another params
    object is captured anew."""
    dev = _card()
    cfg = _cfg(window, dtype)
    B, S, max_seq, half = 4, 40, 256, 10
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    g = torch.Generator().manual_seed(6)
    prompts = [torch.randint(0, cfg.vocab_size, (B, S), generator=g).to(dev)
               for _ in range(2)]
    step = serve.make_serve_step(cfg, device=dev)

    def serve_two(decode):
        out, counts = [], []
        for prompt in prompts:
            logits, cache = model.prefill(cfg, params, prompt, max_seq,
                                          device=dev)
            tok = logits[:, -1:].argmax(dim=-1)
            obs.enable()
            for i in range(half):
                logits, cache = decode(cache, tok, S + i)
                tok = logits[:, -1:].argmax(dim=-1)
                out.append((logits, tok))
            obs.disable()
            counts.append(obs.drain().counts)
        torch.cuda.synchronize()
        return out, cache, counts

    got, got_cache, got_counts = serve_two(
        lambda c, t, p: step(params, c, t, p))
    want, want_cache, want_counts = serve_two(
        lambda c, t, p: model.decode_step(cfg, params, c, t, p, device=dev))
    for (a, ta), (b, tb) in zip(got, want):
        assert torch.equal(ta, tb)
        assert torch.equal(a, b)
    assert _same_cache(got_cache, want_cache)
    graph = {k: sum(c.get(k, 0) for c in got_counts) for k in (
        "serve.graph_captures", "serve.graph_cache_copies",
        "serve.graph_replays")}
    assert graph == {"serve.graph_captures": 1,
                     "serve.graph_cache_copies": 1,
                     "serve.graph_replays": 18}
    for a, b in zip(got_counts, want_counts):
        for k in ("attention.positions_attended", "attention.positions_live"):
            assert a[k] == b[k]

    # other params: captured anew, not replayed on the first params
    other = model.init(cfg, torch.Generator(device=dev).manual_seed(1),
                       device=dev)
    twin = _clone(got_cache)
    tok = got[-1][1]
    obs.enable()
    a, _ = step(other, got_cache, tok, S + half)
    obs.disable()
    b, _ = model.decode_step(cfg, other, twin, tok, S + half, device=dev)
    assert torch.equal(a, b)
    assert obs.drain().counts["serve.graph_captures"] == 1


@pytest.mark.cuda
def test_serve_step_inside_a_callers_capture_is_eager():
    """A call made while the caller captures its own graph (as
    ``chip_smoke.py`` times a step) runs the eager step, which the
    caller's graph holds: its replay gives the eager step's logits."""
    dev = _card()
    cfg = _cfg(None, "bfloat16")
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    prompt = torch.randint(0, cfg.vocab_size, (4, 40),
                           generator=torch.Generator().manual_seed(7))
    logits, cache = model.prefill(cfg, params, prompt.to(dev), 256,
                                  device=dev)
    tok = logits[:, -1:].argmax(dim=-1)
    step = serve.make_serve_step(cfg, device=dev)
    _, cache = step(params, cache, tok, 40)
    twin = _clone(cache)
    outer = torch.cuda.CUDAGraph()
    obs.enable()
    with torch.cuda.graph(outer):
        held, _ = step(params, cache, tok, 41)
    obs.disable()
    assert not [k for k in obs.drain().counts
                if k.startswith("serve.graph_")]
    outer.replay()
    want, _ = model.decode_step(cfg, params, twin, tok, 41, device=dev)
    torch.cuda.synchronize()
    assert torch.equal(held, want)
    assert _same_cache(cache, twin)


def _hybrid(form, dtype):
    """The hybrid at a test's size: the reference's residual form (the
    stand-in) or Zamba2's (two groups, two blocks, a LoRA)."""
    cfg = dataclasses.replace(reduce_for_smoke(get_config("zamba2-7b")),
                              param_dtype=dtype, activation_dtype=dtype)
    if form == "zamba2":
        cfg = with_port_fields(
            cfg, n_layers=7, hidden_act="gelu", mamba_ngroups=2,
            shared_block="zamba2", num_mem_blocks=2, adapter_rank=4,
            hybrid_layer_ids=(1, 4, 5), tie_embeddings=True,
            hybrid_attn_period=0)
    return cfg


def _flat_clone(cache):
    return {k: v.clone() for k, v in cache.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["residual", "zamba2"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_graph_step_equals_the_eager_step_on_the_card(form, dtype):
    """Three requests of B 4 through the serve step against
    ``model.decode_step`` with an int ``pos``: the second's cache passed
    while the first's is alive (copied in), the third's after both were
    dropped (captured anew, the graph holding its cache weakly). Equal
    tokens and logits bit for bit, so the warm-up steps before each
    capture left the conv and SSM state as they found it; 2 captures, 1
    copy, 27 replays; the counters as the eager steps count them, K5
    (``mamba.state_step_kernel``) once a layer and step, and the eager
    steps' K5 calls as many."""
    dev = _card()
    cfg = _hybrid(form, dtype)
    assert model.decode_graphable(cfg)
    B, S, max_seq, n = 4, 24, 64, 10
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    g = torch.Generator().manual_seed(8)
    prompts = [torch.randint(0, cfg.vocab_size, (B, S), generator=g).to(dev)
               for _ in range(3)]
    step = serve.make_serve_step(cfg, device=dev)

    def run(decode):
        out, counts, caches = [], [], []
        for r, prompt in enumerate(prompts):
            if r == 2:
                caches.clear()          # the first two requests dropped
            logits, cache = model.prefill(cfg, params, prompt, max_seq,
                                          device=dev)
            caches.append(cache)
            tok = logits[:, -1:].argmax(dim=-1)
            obs.enable()
            for i in range(n):
                logits, cache = decode(cache, tok, S + i)
                tok = logits[:, -1:].argmax(dim=-1)
                out.append(logits)
            obs.disable()
            counts.append(obs.drain().counts)
            caches[-1] = cache
        torch.cuda.synchronize()
        return out, counts, caches[-1]

    got, got_counts, got_cache = run(lambda c, t, p: step(params, c, t, p))
    before = m5.launches
    want, want_counts, want_cache = run(
        lambda c, t, p: model.decode_step(cfg, params, c, t, p, device=dev))
    assert m5.launches - before == 3 * n * cfg.n_layers
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert all(torch.equal(got_cache[k], want_cache[k]) for k in got_cache)
    graph = {k: sum(c.get(k, 0) for c in got_counts) for k in (
        "serve.graph_captures", "serve.graph_cache_copies",
        "serve.graph_replays")}
    assert graph == {"serve.graph_captures": 2,
                     "serve.graph_cache_copies": 1,
                     "serve.graph_replays": 27}
    for a, b in zip(got_counts, want_counts):
        for k in ("attention.positions_attended", "attention.positions_live",
                  "mamba.state_bytes", "mamba.state_step_kernel"):
            assert a[k] == b[k]
        assert a["mamba.state_step_kernel"] == n * cfg.n_layers
