"""The port's MoE, hybrid (Mamba-2), encoder-decoder and VLM families against
the reference on the CPU.

Reduced configs (``reduce_for_smoke``: 4 layers, d_model 64, fp32) of
Mixtral-8x22B (top-2 of 4 experts, its sliding window of 8 under an
11-token prompt, so the ring cache wraps), Kimi-K2 (a first dense layer and
a shared expert), Zamba2-7B (Mamba-2 blocks with a shared attention block
every 2; also with a 5th block as a tail segment), Whisper-large-v3 (2
encoder and 4 decoder layers over 16 stub frames) and InternVL2-76B (8
stub vision tokens before the text). The reference's random weights are
carried into the port by ``repro_torch.convert.model_from_arrays``; token
ids and the stub frames and vision embeddings come from numpy.

The reference runs with ``attn_impl="flash"`` (its Pallas kernels in
interpret mode), except Whisper: with ``"flash"`` the reference's
``attention`` ignores its mask and turns the encoder causal, which the port
does not copy, so the audio family is held to the reference's ``"xla"``
route (its default), which keeps the encoder bidirectional.

Tolerances, as ``tests/test_torch_models.py``: logits (and the MoE load
balance loss) 1e-4; cache tensors 2e-5 in fp32 and one bf16 ulp (2**-7
relative) in the bf16 cache, on top of the fp32 tolerance's 2e-5 absolute:
a decode step reads the cache back in bf16, where a value that rounded the
other way moves the rows it writes by about the fp32 tolerance, which a
value near 0 shows beyond its own ulp. ``greedy_generate`` gives the same
tokens.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.configs import base as ref_base
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro.train import serve as ref_serve
from repro_torch.configs import base, get_config
from repro_torch.convert import model_arrays, model_from_arrays
from repro_torch.models import encdec, model, moe, ssm
from repro_torch.models.mlp import mlp
from repro_torch.train import serve

LOGITS = dict(atol=1e-4, rtol=1e-4)
F32 = dict(atol=2e-5, rtol=2e-5)
BF16_ULP = dict(atol=1e-6, rtol=2.0 ** -7)
BF16_CACHE = dict(atol=2e-5, rtol=2.0 ** -7)
B, S = 2, 12
CASES = {
    "mixtral-8x22b": {},
    "kimi-k2-1t-a32b": {},
    "zamba2-7b": {},
    "zamba2-7b+tail": {"n_layers": 5},
    "whisper-large-v3": {},
    "internvl2-76b": {},
}


def _configs(case):
    arch = case.split("+")[0]
    impl = "xla" if arch == "whisper-large-v3" else "flash"
    rcfg = dataclasses.replace(ref_base.reduce_for_smoke(ref_config(arch)),
                               attn_impl=impl, **CASES[case])
    return rcfg, base.ModelConfig(**dataclasses.asdict(rcfg))


def _extra_arrays(cfg, seed=2) -> dict:
    """The modality stubs as numpy draws (standard normal)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "vlm":
        out["vision_embeds"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return out


def _torch_extra(extra) -> dict:
    return {k: torch.from_numpy(v) for k, v in extra.items()}


def _vision(cfg) -> int:
    return cfg.vision_tokens if cfg.family == "vlm" else 0


@functools.lru_cache(maxsize=None)
def _case(case):
    """(cfg, port model, tokens, extra, reference outputs) for one case."""
    rcfg, cfg = _configs(case)
    params = ref_model.init(rcfg, jax.random.PRNGKey(0))
    arrays = jax.tree.map(np.asarray, params)
    tokens = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (B, S)).astype(np.int32)
    extra = _extra_arrays(rcfg)
    jex = {k: jnp.asarray(v) for k, v in extra.items()}
    t = jnp.asarray(tokens)
    max_seq = _vision(rcfg) + S + 8
    out = {"arrays": arrays}
    logits, aux = ref_model.forward(rcfg, params, t, jex)
    out["forward"] = (np.asarray(logits), float(aux))
    for dt in ("float32", "bfloat16"):
        logits, cache = ref_model.prefill(rcfg, params, t[:, :S - 1],
                                          max_seq, jex,
                                          cache_dtype=getattr(jnp, dt))
        out[f"prefill_{dt}"] = (np.asarray(logits),
                                jax.tree.map(np.asarray, cache))
        pos = _vision(rcfg) + S - 1
        logits, cache = ref_model.decode_step(rcfg, params, cache,
                                              t[:, S - 1:], jnp.int32(pos))
        out[f"decode_{dt}"] = (np.asarray(logits),
                               jax.tree.map(np.asarray, cache))
    out["greedy"] = np.asarray(ref_serve.greedy_generate(
        rcfg, params, t, 6, max_seq, extra=jex))
    port = model_from_arrays(cfg, arrays, device="cpu")
    return cfg, port, tokens, extra, out


def _leaves(cache):
    return jax.tree.leaves(jax.tree.map(
        lambda a: a.float().numpy() if isinstance(a, torch.Tensor) else
        np.asarray(a, np.float32), cache))


def _same_cache(got, want, dt):
    assert (jax.tree.structure(jax.tree.map(lambda a: 0, got))
            == jax.tree.structure(jax.tree.map(lambda a: 0, want)))
    tol = F32 if dt == "float32" else BF16_CACHE
    for g, w in zip(_leaves(got), _leaves(want)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, **tol)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_matches_reference(case):
    cfg, port, tokens, extra, ref = _case(case)
    logits, aux = model.forward(cfg, port, torch.from_numpy(tokens),
                                _torch_extra(extra), device="cpu")
    want_logits, want_aux = ref["forward"]
    assert logits.dtype == torch.float32 and aux.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want_logits, **LOGITS)
    np.testing.assert_allclose(float(aux), want_aux, **LOGITS)
    assert (float(aux) > 0) == (cfg.family == "moe")


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_prefill_then_decode_match_reference(case, dt):
    cfg, port, tokens, extra, ref = _case(case)
    t = torch.from_numpy(tokens)
    max_seq = _vision(cfg) + S + 8
    logits, cache = model.prefill(cfg, port, t[:, :S - 1], max_seq,
                                  _torch_extra(extra),
                                  cache_dtype=getattr(torch, dt),
                                  device="cpu")
    want_logits, want_cache = ref[f"prefill_{dt}"]
    np.testing.assert_allclose(logits.numpy(), want_logits, **LOGITS)
    _same_cache(cache, want_cache, dt)
    logits, cache = model.decode_step(cfg, port, cache, t[:, S - 1:],
                                      _vision(cfg) + S - 1, device="cpu")
    want_logits, want_cache = ref[f"decode_{dt}"]
    np.testing.assert_allclose(logits.numpy(), want_logits, **LOGITS)
    _same_cache(cache, want_cache, dt)


@pytest.mark.parametrize("case", list(CASES))
def test_greedy_generate_gives_the_reference_tokens(case):
    cfg, port, tokens, extra, ref = _case(case)
    got = serve.greedy_generate(cfg, port, torch.from_numpy(tokens), 6,
                                _vision(cfg) + S + 8,
                                extra=_torch_extra(extra), device="cpu")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref["greedy"])


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_decode_matches_forward(case):
    """The serving path against teacher forcing, in the port alone."""
    cfg, port, tokens, extra, _ = _case(case)
    t, ex = torch.from_numpy(tokens), _torch_extra(extra)
    full, _ = model.forward(cfg, port, t, ex, device="cpu")
    prefill = serve.make_prefill_step(cfg, _vision(cfg) + S + 4,
                                      device="cpu")
    _, cache = prefill(port, t[:, :S - 1], ex)
    step = serve.make_serve_step(cfg, device="cpu")
    dec, _ = step(port, cache, t[:, S - 1:], _vision(cfg) + S - 1)
    assert float((full[:, -1] - dec[:, 0]).abs().max()) < 2e-2


@pytest.mark.parametrize("case", list(CASES))
def test_model_arrays_round_trip(case):
    _, port, _, _, ref = _case(case)
    back = model_arrays(port)
    want = ref["arrays"]
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "kimi-k2-1t-a32b",
                                  "zamba2-7b", "whisper-large-v3",
                                  "internvl2-76b"])
def test_init_mirrors_the_reference_tree(arch):
    """The port's own random init: the reference's parameter names, shapes
    and dtypes (fp32 router and SSM constants); deterministic in the
    generator's seed."""
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
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.shape == w.shape
    flat_want = dict(zip(
        (".".join(str(k.key) for k in path) for path, _ in
         jax.tree_util.tree_flatten_with_path(want)[0]),
        jax.tree.leaves(want)))
    for name, p in m.named_parameters():
        assert not p.requires_grad, name
        parts = name.split(".")
        if parts[0].endswith("layers"):
            parts.pop(1)
        want_dt = str(flat_want[".".join(parts)].dtype)
        assert str(p.dtype).removeprefix("torch.") == want_dt, name
    again = model_arrays(model.init(cfg, gen(), device="cpu"))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(again)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------- #
#  The blocks
# ---------------------------------------------------------------------- #
@torch.no_grad()
def _load(module, tree):
    params = dict(module.named_parameters())
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    assert len(flat) == len(params)
    for path, arr in flat:
        params[".".join(str(k.key) for k in path)].copy_(
            torch.tensor(np.asarray(arr)))
    return module


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "kimi-k2-1t-a32b"])
def test_moe_drops_at_tight_capacity_and_matches_reference(arch):
    """capacity_factor 0.25 (``tests/test_archs.py``'s case): C = 2 slots
    per expert for 32 assignments over 4 experts, so most are dropped;
    the port drops the same ones (its output and aux loss equal the
    reference's) and a dropped token's MoE output is the shared expert's
    alone (zero without one)."""
    rcfg = dataclasses.replace(ref_base.reduce_for_smoke(ref_config(arch)),
                               capacity_factor=0.25)
    cfg = base.ModelConfig(**dataclasses.asdict(rcfg))
    p = ref_moe.init_moe(jax.random.PRNGKey(0), rcfg)
    x = np.random.default_rng(1).normal(size=(2, 16, cfg.d_model)).astype(
        np.float32)
    want, want_aux = ref_moe.moe(p, jnp.asarray(x), rcfg)
    mod = _load(moe.MoE(cfg, "cpu"), p)
    got, aux = moe.moe(mod, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    np.testing.assert_allclose(float(aux), float(want_aux), **LOGITS)
    assert moe.capacity(cfg, 16) == 2
    xt = torch.from_numpy(x)
    routed = got if mod.shared is None else got - mlp(mod.shared, xt)
    assert int((routed.abs().amax(dim=-1) == 0).sum()) > 0


def test_moe_sums_each_tokens_outputs_in_expert_order():
    """At k = 8 in bf16 the order of a token's k adds shows in the bits:
    the port adds them in ascending expert id, the order of the
    reference's scatter-add, and equals it bit for bit. The experts are
    made exact so that only the combine's order is left: w_gate = w_down =
    I and w_up = 2**(e % 4) I, with inputs in [17, 64), where SiLU is the
    identity in bf16."""
    rcfg = dataclasses.replace(ref_base.reduce_for_smoke(
        ref_config("kimi-k2-1t-a32b")), n_experts=16, top_k=8,
        n_shared_experts=0, param_dtype="bfloat16",
        activation_dtype="bfloat16")
    cfg = base.ModelConfig(**dataclasses.asdict(rcfg))
    E, D = cfg.n_experts, cfg.d_model
    eye = np.broadcast_to(np.eye(D, dtype=np.float32), (E, D, D))
    scale = 2.0 ** (np.arange(E) % 4)
    rng = np.random.default_rng(6)
    p = {"router": rng.normal(size=(D, E)).astype(np.float32) * 0.1,
         "w_gate": eye, "w_up": eye * scale[:, None, None].astype(np.float32),
         "w_down": eye}
    x = jnp.asarray(rng.uniform(17.0, 64.0, size=(2, 16, D)), jnp.bfloat16)
    want, _ = ref_moe.moe({k: jnp.asarray(v, jnp.bfloat16 if k != "router"
                                          else jnp.float32)
                           for k, v in p.items()}, x, rcfg)
    mod = _load(moe.MoE(cfg, "cpu"), p)
    xt = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    got, _ = moe.moe(mod, xt, cfg)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    # the test has teeth: the top-k order gives other bits
    probs = torch.softmax(xt.float() @ mod.router, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    w = (top_p / top_p.sum(-1, keepdim=True)).bfloat16()
    ye = (xt * xt)[..., None, :] * torch.from_numpy(scale).bfloat16()[
        top_i][..., None]                                  # (B, S, k, D)
    contrib = ye * w[..., None]
    other = contrib[:, :, 0]
    for j in range(1, cfg.top_k):
        other = other + contrib[:, :, j]
    assert not torch.equal(other, got)


@pytest.mark.parametrize("L", [16, 1])
def test_mamba2_block_through_the_scan_kernel_matches_reference(L,
                                                                monkeypatch):
    """L = 16: the port's Mamba-2 prompt goes through the scan kernel's
    wrapper (dt, A and D repeated over each head's channels), the
    reference through its sequential ``mamba2_scan``; L = 1 both take the
    plain recurrence."""
    rcfg, cfg = _configs("zamba2-7b")
    p = ref_ssm.init_mamba(jax.random.PRNGKey(0), rcfg)
    p = {**p, "A_log": p["A_log"] + 0.3,                 # dt, A, D per head
         "dt_bias": jnp.linspace(-1.0, 1.0, p["dt_bias"].shape[0]),
         "D": jnp.linspace(0.5, 1.5, p["D"].shape[0])}
    x = np.random.default_rng(1).normal(size=(2, L, rcfg.d_model)).astype(
        np.float32)
    want, wst = ref_ssm.mamba2_block(p, jnp.asarray(x), rcfg)
    calls = []
    scan = ssm.kops.mamba_scan
    monkeypatch.setattr(ssm.kops, "mamba_scan",
                        lambda *a: calls.append(a) or scan(*a))
    mod = _load(ssm.Mamba2(cfg, "cpu"), p)
    got, st = ssm.mamba2_block(mod, torch.from_numpy(x), cfg)
    assert len(calls) == (L > 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGITS)
    np.testing.assert_allclose(st["conv"].numpy(), np.asarray(wst["conv"]),
                               **F32)
    np.testing.assert_allclose(st["ssm"].numpy(), np.asarray(wst["ssm"]),
                               **F32)


def test_mamba2_scan_matches_reference_from_a_state():
    rng = np.random.default_rng(3)
    Bsz, L, H, Pd, N = 2, 5, 3, 4, 8
    u = rng.normal(size=(Bsz, L, H, Pd)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(Bsz, L, H)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(H,))).astype(np.float32)
    Bm, Cm = (rng.normal(size=(Bsz, L, N)).astype(np.float32)
              for _ in range(2))
    D = rng.normal(size=(H,)).astype(np.float32)
    h0 = rng.normal(size=(Bsz, H, Pd, N)).astype(np.float32)
    want, wh = ref_ssm.mamba2_scan(*map(jnp.asarray, (u, dt, A, Bm, Cm, D,
                                                      h0)))
    got, h = ssm.mamba2_scan(*map(torch.from_numpy, (u, dt, A, Bm, Cm, D,
                                                      h0)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(h.numpy(), np.asarray(wh), **F32)


def test_encoder_is_bidirectional():
    """A change to the last frame moves the first frame's encoder state
    (a causal encoder would leave it as it was)."""
    cfg, port, _, extra, _ = _case("whisper-large-v3")
    frames = torch.from_numpy(extra["frames"])
    moved = frames.clone()        # a shift of every channel would vanish
    moved[:, -1] += torch.linspace(-1.0, 1.0, cfg.d_model)  # in LayerNorm
    a = encdec.encode(port, frames, cfg)
    b = encdec.encode(port, moved, cfg)
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-3
    assert torch.equal(frames, torch.from_numpy(extra["frames"]))


def test_extra_inputs_follow_the_reference():
    for arch in ("internvl2-76b", "whisper-large-v3", "mixtral-8x22b"):
        cfg = base.reduce_for_smoke(get_config(arch))
        rcfg = ref_base.reduce_for_smoke(ref_config(arch))
        for mode in ("train", "prefill", "decode"):
            got = model.extra_inputs(cfg, 3, 20, mode, device="cpu")
            want = ref_model.extra_inputs(rcfg, 3, 20, mode)
            assert sorted(got) == sorted(want)
            for k in want:
                assert tuple(got[k].shape) == want[k].shape
                assert not got[k].any()
        drawn = model.extra_inputs(cfg, 3, 20, "train",
                                   torch.Generator().manual_seed(0),
                                   device="cpu")
        again = model.extra_inputs(cfg, 3, 20, "train",
                                   torch.Generator().manual_seed(0),
                                   device="cpu")
        for k in drawn:
            assert drawn[k].any() and torch.equal(drawn[k], again[k])


def test_extra_inputs_are_required_and_checked():
    cfg, port, tokens, extra, _ = _case("whisper-large-v3")
    t = torch.from_numpy(tokens)
    with pytest.raises(ValueError, match="needs `frames`"):
        model.forward(cfg, port, t, device="cpu")
    with pytest.raises(ValueError, match="extra inputs"):
        model.forward(cfg, port, t, {"vision_embeds": extra["frames"]},
                      device="cpu")
    cfg, port, tokens, _, _ = _case("mixtral-8x22b")
    with pytest.raises(ValueError, match="extra inputs"):
        model.prefill(cfg, port, torch.from_numpy(tokens), 32,
                      {"frames": np.zeros((B, 4, cfg.d_model), np.float32)},
                      device="cpu")


#: (case, tree path of a leaf to break): one per stacked or new subtree
BAD_TREES = [
    ("kimi-k2-1t-a32b", "dense_layers.attn.wq"),
    ("kimi-k2-1t-a32b", "layers.moe.shared.w_up"),
    ("mixtral-8x22b", "layers.moe.router"),
    ("zamba2-7b", "layers.mamba.A_log"),
    ("zamba2-7b", "shared_attn.mlp.w_down"),
    ("whisper-large-v3", "enc_layers.attn_norm.b"),
    ("whisper-large-v3", "dec_layers.cross_attn.wk"),
    ("whisper-large-v3", "enc_final_norm.w"),
]


def _at(tree, path):
    *parents, leaf = path.split(".")
    for key in parents:
        tree = tree[key]
    return tree, leaf


@pytest.mark.parametrize("case,path", BAD_TREES,
                         ids=[p for _, p in BAD_TREES])
def test_model_from_arrays_rejects_bad_trees(case, path):
    """A missing leaf, a wrong stack depth and a wrong shape each raise,
    naming the parameter."""
    cfg, _, _, _, ref = _case(case)
    name = path.split(".")[-1]
    stacked = path.split(".")[0].endswith("layers")
    arrays = jax.tree.map(lambda a: a, ref["arrays"])
    node, leaf = _at(arrays, path)
    del node[leaf]
    with pytest.raises(KeyError, match=name):
        model_from_arrays(cfg, arrays, device="cpu")
    arrays = jax.tree.map(lambda a: a, ref["arrays"])
    node, leaf = _at(arrays, path)
    if stacked:
        node[leaf] = np.concatenate([node[leaf], node[leaf][:1]])
        with pytest.raises(ValueError, match="stacked layers"):
            model_from_arrays(cfg, arrays, device="cpu")
        arrays = jax.tree.map(lambda a: a, ref["arrays"])
        node, leaf = _at(arrays, path)
        node[leaf] = node[leaf][..., :1]
    else:
        node[leaf] = node[leaf][:1]
    with pytest.raises(ValueError, match=name):
        model_from_arrays(cfg, arrays, device="cpu")
