"""The plain references held to the port at a reduced size, on the CPU
in fp32: the port's forward and its serving path (prefill through the
kernels' plain versions, then decode steps through the cache) against
the reference's logits on the same weights."""
from __future__ import annotations

import pytest
import torch

from perfbench import port, reference, testcells, weights
from perfbench.reference import dense

REFS = {"dense": dense}

CASES = {
    "gqa": testcells.TINY,
    "window": dict(testcells.TINY, sliding_window=6),
    "mha-3-layers": dict(testcells.TINY, num_key_value_heads=4,
                         num_hidden_layers=3, head_dim=8),
}


def _fp32(c):
    return dict(c, torch_dtype="float32")


def _setup(c, seed=3):
    c = _fp32(c)
    W = weights.make(REFS[c["family"]].weight_shapes(c), seed, "cpu",
                     torch.float32)
    cfg, lm = port.build(c, W, "cpu")
    return c, W, cfg, lm


def _reference(c, W, tokens, precision="fp32"):
    return torch.cat([lg for _, lg in REFS[c["family"]].logit_blocks(
        c, W, tokens, precision)])


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_reference_matches_the_ports_forward(case):
    from repro_torch.models import model
    c, W, cfg, lm = _setup(CASES[case])
    tokens = torch.randint(0, c["vocab_size"], (21,),
                           generator=torch.Generator().manual_seed(1))
    got, _ = model.forward(cfg, lm, tokens[None], device="cpu", impl="xla")
    want = _reference(c, W, tokens)
    torch.testing.assert_close(got[0], want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_reference_matches_prefill_then_decode(case):
    from repro_torch.models import model
    from repro_torch.train import serve
    c, W, cfg, lm = _setup(CASES[case], seed=11)
    g = torch.Generator().manual_seed(2)
    prompt = torch.randint(0, c["vocab_size"], (2, 9), generator=g)
    new = torch.randint(0, c["vocab_size"], (2, 4), generator=g)
    # the served path keeps its cache in bf16; here it is fp32, so that
    # every position is held to fp32
    logits, cache = model.prefill(cfg, lm, prompt, 13,
                                  cache_dtype=torch.float32, device="cpu")
    steps = [logits]
    step = serve.make_serve_step(cfg, device="cpu")
    for k in range(4):
        lg, cache = step(lm, cache, new[:, k:k + 1], 9 + k)
        steps.append(lg)
    got = torch.cat(steps, dim=1)
    for row in range(2):
        want = _reference(c, W, torch.cat([prompt[row], new[row]]))
        torch.testing.assert_close(got[row], want, atol=2e-5, rtol=2e-5)


def test_fp8_rounds_each_slice_to_e4m3():
    t = torch.tensor([[1.0, 0.3, -448.0], [2e-3, 1e-3, 0.0]])
    q = reference.fp8(t, -1)
    # each row's absmax lands on e4m3's largest value and comes back
    assert q[0, 2] == -448.0 and q[1, 0] == pytest.approx(2e-3)
    # 3 mantissa bits: 0.3 of 448 rounds to within 1/16 of itself
    assert abs(float(q[0, 1]) - 0.3) <= 0.3 / 16
    assert q[1, 2] == 0.0


def test_control_precision_departs_from_fp32():
    c, W, _, _ = _setup(CASES["gqa"])
    tokens = torch.arange(12) % c["vocab_size"]
    exact = _reference(c, W, tokens)
    low = _reference(c, W, tokens, "fp8")
    err = float((low - exact).abs().max() / exact.abs().max())
    assert 1e-3 < err < 0.5
    with pytest.raises(ValueError):
        reference.linear(exact, W["final_norm"][:, None], "int4")
