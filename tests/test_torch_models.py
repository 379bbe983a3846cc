"""The port's served models against the reference on the CPU.

Reduced configs (``reduce_for_smoke``: 4 layers, d_model 64, fp32) of the
dense family (Mistral-NeMo, plus a sliding-window variant for the ring
cache, Qwen2.5 for the QKV bias, SmolLM for tied embeddings) and of the
Mamba-1 family (Falcon-Mamba). The reference's random weights are carried
into the port by ``repro_torch.convert.model_from_arrays``; token ids come
from numpy. The reference runs with ``attn_impl="flash"``, its Pallas
kernels in interpret mode — the route the port takes everywhere.

Tolerances: logits 1e-4 (several fp32 layers whose matmuls sum in another
order); cache tensors 2e-5 in fp32, and one bf16 ulp (2**-7 relative) in
the default bf16 cache, where an fp32 difference in the last bits can
round the other way. ``greedy_generate`` must give the same tokens.
"""
from __future__ import annotations

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_ALIASES as REF_ALIASES
from repro.configs import get_config as ref_config
from repro.configs import base as ref_base
from repro.models import model as ref_model
from repro.train import serve as ref_serve
from repro_torch.configs import ARCH_ALIASES, get_config
from repro_torch.configs import base
from repro_torch.convert import model_arrays, model_from_arrays
from repro_torch.models import model
from repro_torch.train import serve

LOGITS = dict(atol=1e-4, rtol=1e-4)
F32 = dict(atol=2e-5, rtol=2e-5)
BF16_ULP = dict(atol=1e-6, rtol=2.0 ** -7)
B, S = 2, 12
CASES = {
    "mistral-nemo-12b": {},
    "mistral-nemo-12b+window": {"sliding_window": 8},
    "qwen2.5-14b": {},
    "smollm-360m": {},
    "falcon-mamba-7b": {},
}


def _configs(case):
    arch = case.split("+")[0]
    rcfg = dataclasses.replace(ref_base.reduce_for_smoke(ref_config(arch)),
                               attn_impl="flash", **CASES[case])
    return rcfg, base.ModelConfig(**dataclasses.asdict(rcfg))


@functools.lru_cache(maxsize=None)
def _case(case):
    """(cfg, port model, tokens, reference outputs) for one case."""
    rcfg, cfg = _configs(case)
    params = ref_model.init(rcfg, jax.random.PRNGKey(0))
    if rcfg.qkv_bias:  # nonzero biases, so the bias path shows
        params["layers"]["attn"] = {
            k: (v + 0.05 if k.startswith("b") else v)
            for k, v in params["layers"]["attn"].items()}
    arrays = jax.tree.map(np.asarray, params)
    tokens = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (B, S)).astype(np.int32)
    t = jnp.asarray(tokens)
    out = {"arrays": arrays}
    out["forward"] = np.asarray(ref_model.forward(rcfg, params, t)[0])
    for dt in ("float32", "bfloat16"):
        logits, cache = ref_model.prefill(rcfg, params, t[:, :S - 1], S + 4,
                                          cache_dtype=getattr(jnp, dt))
        out[f"prefill_{dt}"] = (np.asarray(logits),
                                jax.tree.map(np.asarray, cache))
        logits, cache = ref_model.decode_step(rcfg, params, cache,
                                              t[:, S - 1:], jnp.int32(S - 1))
        out[f"decode_{dt}"] = (np.asarray(logits),
                               jax.tree.map(np.asarray, cache))
    out["greedy"] = np.asarray(ref_serve.greedy_generate(rcfg, params, t, 6,
                                                         S + 8))
    port = model_from_arrays(cfg, arrays, device="cpu")
    return cfg, port, tokens, out


def _leaves(cache):
    return jax.tree.leaves(jax.tree.map(
        lambda a: a.float().numpy() if isinstance(a, torch.Tensor) else
        np.asarray(a, np.float32), cache))


def _same_cache(got, want, dt):
    assert (jax.tree.structure(jax.tree.map(lambda a: 0, got))
            == jax.tree.structure(jax.tree.map(lambda a: 0, want)))
    tol = F32 if dt == "float32" else BF16_ULP
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_reference(case):
    cfg, port, tokens, ref = _case(case)
    logits, aux = model.forward(cfg, port, torch.from_numpy(tokens),
                                device="cpu")
    assert logits.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), ref["forward"], **LOGITS)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_prefill_then_decode_match_reference(case, dt):
    cfg, port, tokens, ref = _case(case)
    t = torch.from_numpy(tokens)
    logits, cache = model.prefill(cfg, port, t[:, :S - 1], S + 4,
                                  cache_dtype=getattr(torch, dt),
                                  device="cpu")
    want_logits, want_cache = ref[f"prefill_{dt}"]
    np.testing.assert_allclose(logits.numpy(), want_logits, **LOGITS)
    _same_cache(cache, want_cache, dt)
    logits, cache = model.decode_step(cfg, port, cache, t[:, S - 1:], S - 1,
                                      device="cpu")
    want_logits, want_cache = ref[f"decode_{dt}"]
    np.testing.assert_allclose(logits.numpy(), want_logits, **LOGITS)
    _same_cache(cache, want_cache, dt)


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_generate_gives_the_reference_tokens(case):
    cfg, port, tokens, ref = _case(case)
    got = serve.greedy_generate(cfg, port, torch.from_numpy(tokens), 6,
                                S + 8, device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref["greedy"])


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_decode_matches_forward(case):
    """The serving path against teacher forcing, in the port alone
    (``tests/test_archs.py``'s check)."""
    cfg, port, tokens, _ = _case(case)
    t = torch.from_numpy(tokens)
    full, _ = model.forward(cfg, port, t, device="cpu")
    _, cache = model.prefill(cfg, port, t[:, :S - 1], S + 4,
                             cache_dtype=torch.float32, device="cpu")
    step = serve.make_serve_step(cfg, device="cpu")
    dec, _ = step(port, cache, t[:, S - 1:], S - 1)
    assert float((full[:, -1] - dec[:, 0]).abs().max()) < 2e-2


@pytest.mark.parametrize("case", list(CASES))
def test_model_arrays_round_trip(case):
    """model_arrays(model_from_arrays(arrays)) gives the arrays back."""
    _, port, _, ref = _case(case)
    back = model_arrays(port)
    want = ref["arrays"]
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["mistral-nemo-12b", "falcon-mamba-7b"])
def test_init_mirrors_the_reference_tree(arch):
    """The port's own random init: the reference's parameter names, shapes
    and dtypes; deterministic in the generator's seed; bf16 weights carry
    over through fp32 arrays exactly."""
    cfg = dataclasses.replace(base.reduce_for_smoke(get_config(arch)),
                              param_dtype="bfloat16")
    rcfg = dataclasses.replace(ref_base.reduce_for_smoke(ref_config(arch)),
                               param_dtype="bfloat16")
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    m = model.init(cfg, gen(), device="cpu")
    got = model_arrays(m)
    want = jax.eval_shape(lambda k: ref_model.init(rcfg, k),
                          jax.random.PRNGKey(0))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for name, p in m.named_parameters():
        assert not p.requires_grad, name
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
    dtypes = {n: p.dtype for n, p in m.named_parameters()}
    if cfg.family == "ssm":
        assert dtypes["layers.0.mamba.A_log"] == torch.float32
        assert dtypes["layers.0.mamba.in_proj"] == torch.bfloat16
    again = model_arrays(model.init(cfg, gen(), device="cpu"))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)
    back = model_arrays(model_from_arrays(cfg, got, device="cpu"))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_model_from_arrays_rejects_bad_trees():
    cfg, _, _, ref = _case("falcon-mamba-7b")
    arrays = jax.tree.map(lambda a: a, ref["arrays"])
    del arrays["final_norm"]
    with pytest.raises(KeyError, match="final_norm"):
        model_from_arrays(cfg, arrays, device="cpu")
    arrays = jax.tree.map(lambda a: a, ref["arrays"])
    arrays["layers"]["norm"] = arrays["layers"]["norm"][:2]
    with pytest.raises(ValueError, match="stacked layers"):
        model_from_arrays(cfg, arrays, device="cpu")
    arrays = jax.tree.map(lambda a: a, ref["arrays"])
    arrays["embed"]["tok"] = arrays["embed"]["tok"][:, :3]
    with pytest.raises(ValueError, match="embed.tok"):
        model_from_arrays(cfg, arrays, device="cpu")


@pytest.mark.parametrize("arch", sorted(ARCH_ALIASES))
def test_configs_carry_over_field_for_field(arch):
    ref = ref_config(arch)
    got = get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.param_count() == ref.param_count()
    assert model.text_len(got, 300) == ref_model.text_len(ref, 300)
    assert got.resolved_head_dim == ref.resolved_head_dim
    assert (dataclasses.asdict(base.reduce_for_smoke(got))
            == dataclasses.asdict(ref_base.reduce_for_smoke(ref)))
    for name, shape in ref_base.SHAPES.items():
        assert dataclasses.asdict(base.SHAPES[name]) == \
            dataclasses.asdict(shape)
        assert base.shape_applicable(got, base.SHAPES[name]) == \
            ref_base.shape_applicable(ref, shape)


def test_registry_matches_reference():
    assert ARCH_ALIASES == REF_ALIASES
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("gpt-2")


def test_params_must_be_on_the_requested_device():
    cfg, port, tokens, _ = _case("falcon-mamba-7b")
    elsewhere = copy.deepcopy(port).to("meta")
    with pytest.raises(ValueError, match="not on the requested device"):
        model.forward(cfg, elsewhere, torch.from_numpy(tokens), device="cpu")
