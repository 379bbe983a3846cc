"""The port's training substrate against the reference on the CPU: the data
pipeline, AdamW (fp32 and int8 state), checkpoints, the restartable
runner, the plain attention route and a train step of every reduced
architecture.

The reference's random weights (``reduce_for_smoke``: 4 layers, d_model
64, fp32) are carried into the port by ``repro_torch.convert``; batches
come from the data pipeline (bit-equal in both packages), the modality
stubs from numpy. Both packages train on their differentiable route: the
reference's default ``attn_impl="xla"``, the port's ``impl="xla"``.

Tolerances:

* data batches, checkpoints (round trip and across the packages), the
  optimizer-state conversion and the restarted run: bit for bit;
* AdamW on identical params and grads, 5 steps, clipping off (so the
  clipped grads are identical too): params, m and v within 2 fp32 ulp
  (the same fp32 operations in the same order); int8 ``q`` equal on
  >= 99.9 % of the entries and within 1 elsewhere (an m within its ulps
  can round to the other side of a half), ``scale`` within 1e-6
  relative; ``lr_at`` 1e-6 relative; ``grad_norm`` 1e-6 relative (the
  two packages sum the squares in another order). With clipping on, the
  clip factor inherits that rounding, and a moment near 0 then differs by
  many of its own ulps: params within 1e-4 lr, m and v within 1e-6 of
  each leaf's max, ``q`` and ``scale`` as above;
* a train step: loss, ce, aux and grad_norm 1e-5 relative; every grad
  leaf within 1e-4 of its max |g|; new params within 2 lr of the
  reference's (AdamW's step is about lr sign(g) at step 1, so a grad near
  0 that differs in sign moves its param by up to 2 lr) and within 1e-5 on
  >= 99.9 % of the entries;
* ``_sdpa_chunked`` and the Mamba scans' gradients at 512 steps (two
  rematerialised chunks): 1e-5;
* ``remat="full"`` against ``"none"`` in the port: bit for bit;
  ``microbatches=2`` against one batch of the same rows: 1e-5.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as ref_ckpt
from repro.configs import get_config as ref_config
from repro.configs import base as ref_base
from repro.data import pipeline as ref_pipeline
from repro.models import attention as ref_attention
from repro.models import model as ref_model
from repro.models import ssm as ref_ssm
from repro.optim import adamw as ref_adamw
from repro.train import step as ref_step
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.configs import ARCH_IDS, base, get_config
from repro_torch.convert import (model_arrays, model_from_arrays,
                                 opt_state_arrays, opt_state_from_arrays)
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist import (FailureInjector, RunnerConfig,
                              SimulatedFailure, TrainingRunner)
from repro_torch.models import attention, model, ssm
from repro_torch.optim import adamw
from repro_torch.train import step as train_step

B, S = 2, 12
LR = 1e-3
OPT = dict(lr=LR, warmup_steps=1, total_steps=50)
REL = dict(rtol=1e-5, atol=0.0)


def _np(t) -> np.ndarray:
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


# ---------------------------------------------------------------------- #
#  Data
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("kw,hosts", [
    (dict(vocab_size=300, seq_len=24, global_batch=4, order=1), 1),
    (dict(vocab_size=49152, seq_len=16, global_batch=3, seed=5), 1),
    (dict(vocab_size=1000, seq_len=8, global_batch=8, seed=2), 4),
], ids=["order1-small-vocab", "order2-hashed", "4-hosts"])
def test_batches_bit_equal_to_the_reference(kw, hosts):
    ours = SyntheticLM(DataConfig(**kw))
    theirs = ref_pipeline.SyntheticLM(ref_pipeline.DataConfig(**kw))
    for step in (0, 3):
        for h in range(hosts):
            a = ours.batch(step, host_index=h, host_count=hosts)
            b = theirs.batch(step, host_index=h, host_count=hosts)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------- #
#  Optimizer, on identical params and grads
# ---------------------------------------------------------------------- #
SHAPES = {"w": (4, 256), "k": (3, 2, 128), "b": (7,), "n": (5, 96)}


def _opt_inputs(seed=0, steps=5):
    rng = np.random.default_rng(seed)
    params = {n: rng.standard_normal(s).astype(np.float32)
              for n, s in SHAPES.items()}
    grads = [{n: (rng.standard_normal(s) * 0.1).astype(np.float32)
              for n, s in SHAPES.items()} for _ in range(steps)]
    return params, grads


def _same_q(m, rm_):
    q, rq = m.q.numpy().astype(int), np.asarray(rm_.q, int)
    assert m.q.dtype == torch.int8
    assert np.mean(q == rq) >= 0.999
    assert np.abs(q - rq).max() <= 1
    np.testing.assert_allclose(m.scale.numpy(), np.asarray(rm_.scale),
                               rtol=1e-6)


def _within_max(got, want, frac):
    want = np.asarray(want, np.float32)
    assert np.abs(_np(got) - want).max() <= frac * np.abs(want).max()


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_adamw_clipped_matches_reference(state_dtype):
    params, grads = _opt_inputs(seed=2)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1.0,
              state_dtype=state_dtype)
    rcfg, cfg = ref_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    rp = {n: jnp.asarray(a) for n, a in params.items()}
    rs = ref_adamw.init(rp, rcfg)
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    ts = adamw.init(tp, cfg)
    for g in grads:
        rp, rs, rm = ref_adamw.update(rp, {n: jnp.asarray(a) for n, a in
                                           g.items()}, rs, rcfg)
        tm = adamw.update(tp, {n: torch.from_numpy(a) for n, a in
                               g.items()}, ts, cfg)
        assert float(rm["grad_norm"]) > 1.0               # clipping is on
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        for n in SHAPES:
            d = np.abs(tp[n].numpy() - np.asarray(rp[n])).max()
            assert d <= 1e-4 * kw["lr"], (n, d)
            _within_max(ts.v[n], rs.v[n], 1e-6)
            if isinstance(ts.m[n], adamw.QuantState):
                _same_q(ts.m[n], rs.m[n])
            else:
                _within_max(ts.m[n], rs.m[n], 1e-6)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_adamw_matches_reference_on_identical_grads(state_dtype):
    params, grads = _opt_inputs()
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=1e3,
              state_dtype=state_dtype)
    rcfg, cfg = ref_adamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    rp = {n: jnp.asarray(a) for n, a in params.items()}
    rs = ref_adamw.init(rp, rcfg)
    tp = {n: torch.from_numpy(a.copy()) for n, a in params.items()}
    ts = adamw.init(tp, cfg)
    for g in grads:
        rp, rs, rm = ref_adamw.update(rp, {n: jnp.asarray(a) for n, a in
                                           g.items()}, rs, rcfg)
        tm = adamw.update(tp, {n: torch.from_numpy(a) for n, a in
                               g.items()}, ts, cfg)
        np.testing.assert_allclose(float(tm["lr"]), float(rm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-6)
        for n in SHAPES:
            np.testing.assert_array_max_ulp(tp[n].numpy(),
                                            np.asarray(rp[n]), maxulp=2)
            v = ts.v[n]
            assert v.dtype == (torch.bfloat16 if state_dtype == "int8"
                               and adamw.quantizable(SHAPES[n])
                               else torch.float32)
            np.testing.assert_array_max_ulp(
                _np(v), np.asarray(rs.v[n], np.float32),
                maxulp=2 if v.dtype == torch.float32 else 0)
            m, rm_ = ts.m[n], rs.m[n]
            if isinstance(m, adamw.QuantState):
                _same_q(m, rm_)
            else:
                np.testing.assert_array_max_ulp(m.numpy(), np.asarray(rm_),
                                                maxulp=2)
    assert int(ts.step) == int(rs.step) == len(grads)


def test_int8_state_layout_and_bytes():
    params, _ = _opt_inputs()
    tp = {n: torch.from_numpy(a) for n, a in params.items()}
    st = adamw.init(tp, adamw.AdamWConfig(state_dtype="int8"))
    assert isinstance(st.m["w"], adamw.QuantState)
    assert st.m["w"].q.shape == (4, 256) and st.m["w"].scale.shape == (4, 2)
    assert st.m["k"].scale.shape == (3, 2, 1)
    assert st.m["b"].dtype == st.m["n"].dtype == torch.float32
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 256)).astype(np.float32))
    back = adamw._dequantize(adamw._quantize(x))
    assert float((back - x).abs().max()) <= float(x.abs().max()) / 127


@pytest.mark.parametrize("step", [0, 1, 5, 10, 55, 100, 150])
def test_lr_at_matches_reference(step):
    kw = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    got = adamw.lr_at(step, adamw.AdamWConfig(**kw))
    want = ref_adamw.lr_at(jnp.int32(step), ref_adamw.AdamWConfig(**kw))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    expect = {5: 0.5, 10: 1.0, 100: 0.1}
    if step in expect:
        assert float(got) == pytest.approx(expect[step])


def test_grad_clip_matches_reference():
    kw = dict(lr=1e-3, grad_clip=1.0, warmup_steps=0)
    tp = {"w": torch.zeros(3)}
    m = adamw.update(tp, {"w": torch.full((3,), 100.0)},
                     adamw.init(tp, adamw.AdamWConfig(**kw)),
                     adamw.AdamWConfig(**kw))
    rp = {"w": jnp.zeros(3)}
    rp, _, rm = ref_adamw.update(rp, {"w": jnp.full(3, 100.0)},
                                 ref_adamw.init(rp, ref_adamw.AdamWConfig(
                                     **kw)), ref_adamw.AdamWConfig(**kw))
    assert float(m["grad_norm"]) > 100
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(rm["grad_norm"]), rtol=1e-6)
    np.testing.assert_array_max_ulp(tp["w"].numpy(), np.asarray(rp["w"]),
                                    maxulp=2)


# ---------------------------------------------------------------------- #
#  Checkpoints
# ---------------------------------------------------------------------- #
def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.linspace(-2, 3, 4).to(torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32),
            "q": torch.arange(-5, 5, dtype=torch.int8)}


def _ref_tree():
    t = _tree()
    return {"params": {"w": jnp.asarray(t["params"]["w"].numpy()),
                       "b": jnp.asarray(t["params"]["b"].float().numpy(),
                                        jnp.bfloat16)},
            "step": jnp.int32(7), "q": jnp.asarray(t["q"].numpy())}


def _leaves_equal(a, b):
    fa, fb = list(ckpt._flatten(a)), list(ckpt._flatten(b))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (p, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, p
        assert torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                           else x, y.view(torch.int16)
                           if y.dtype == torch.bfloat16 else y), p


def test_checkpoint_round_trip_bit_exact(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 7, tree, extra={"note": "x"})
    back, manifest = ckpt.restore(str(tmp_path), tree)
    _leaves_equal(tree, back)
    assert manifest["step"] == 7 and manifest["extra"] == {"note": "x"}
    live = _tree()
    for leaf in (live["params"]["w"], live["params"]["b"], live["step"]):
        leaf.zero_()
    ckpt.restore_into(str(tmp_path), live)
    _leaves_equal(tree, live)


def test_checkpoint_module_and_int8_state_round_trip(tmp_path):
    cfg = base.reduce_for_smoke(get_config("smollm-360m"))
    params = model.init(cfg, device="cpu")
    opt = adamw.init(params, adamw.AdamWConfig(state_dtype="int8"))
    name = "layers.0.mlp.w_gate"
    assert isinstance(opt.m[name], adamw.QuantState)
    opt.m[name].q.copy_(torch.randint(-127, 128, opt.m[name].q.shape))
    opt.v[name].copy_(torch.rand(opt.v[name].shape))
    tree = {"params": params, "opt": opt}
    path = ckpt.save(str(tmp_path), 3, tree)
    assert os.path.exists(os.path.join(
        path, f"opt__m__{name}__q.npy"))
    restored, _ = ckpt.restore(str(tmp_path), tree)
    assert torch.equal(restored["params"]["layers"]["0"]["mlp"]["w_gate"],
                       params.layers[0].mlp.w_gate)
    assert isinstance(restored["opt"].m[name], adamw.QuantState)
    fresh = {"params": model.init(cfg, torch.Generator().manual_seed(9),
                                  device="cpu"),
             "opt": adamw.init(params, adamw.AdamWConfig(
                 state_dtype="int8"))}
    ckpt.restore_into(str(tmp_path), fresh)
    _leaves_equal(tree, fresh)


def test_checkpoint_written_by_the_reference_restores_here(tmp_path):
    ref_ckpt.save(str(tmp_path), 2, _ref_tree())
    back, manifest = ckpt.restore(str(tmp_path), _tree())
    _leaves_equal(_tree(), back)
    assert back["params"]["b"].dtype == torch.bfloat16
    assert manifest["step"] == 2


def test_checkpoint_written_here_restores_in_the_reference(tmp_path):
    ckpt.save(str(tmp_path), 4, _tree())
    back, _ = ref_ckpt.restore(str(tmp_path), _ref_tree())
    for a, b in zip(jax.tree.leaves(_ref_tree()), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).reshape(-1).view(
            np.uint8), np.asarray(b).reshape(-1).view(np.uint8))
    # the same files, byte for byte, as the reference writes
    ref_ckpt.save(str(tmp_path / "ref"), 4, _ref_tree())
    ours, theirs = tmp_path / "step_00000004", tmp_path / "ref" / \
        "step_00000004"
    for f in sorted(os.listdir(theirs)):
        if f.endswith(".npy"):
            assert (ours / f).read_bytes() == (theirs / f).read_bytes(), f


def test_checkpoint_corruption_detected(tmp_path):
    path = ckpt.save(str(tmp_path), 1, _tree())
    victim = sorted(f for f in os.listdir(path) if f.endswith(".npy"))[0]
    arr = np.load(os.path.join(path, victim))
    flat = arr.reshape(-1).copy()
    flat[0] += 1
    np.save(os.path.join(path, victim), flat.reshape(arr.shape))
    with pytest.raises(IOError):
        ckpt.restore(str(tmp_path), _tree(), step=1)
    with pytest.raises(IOError):
        ckpt.restore_into(str(tmp_path), _tree(), step=1)


def test_async_checkpointer_keeps_the_latest(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        saver.save(s, _tree())
    saver.wait()
    assert ckpt.latest_step(str(tmp_path)) == 4
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]
    back, _ = ckpt.restore(str(tmp_path), _tree())
    _leaves_equal(_tree(), back)


# ---------------------------------------------------------------------- #
#  Restartable runner
# ---------------------------------------------------------------------- #
def _runner_setup():
    cfg = base.reduce_for_smoke(get_config("smollm-360m"))
    params = model.init(cfg, device="cpu", trainable=True)
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=50)
    step = train_step.make_train_step(cfg, ocfg, device="cpu")
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=4, seed=0))

    def fresh():
        p = copy.deepcopy(params)
        return p, adamw.init(p, ocfg)
    return fresh, step, data.batch


def test_restart_is_bit_exact(tmp_path):
    fresh, step, data_fn = _runner_setup()
    clean = TrainingRunner(RunnerConfig(str(tmp_path / "a"),
                                        ckpt_interval=4), step, data_fn)
    p_clean, o_clean, m_clean = clean.run(*fresh(), 0, 10)
    faulty = TrainingRunner(RunnerConfig(str(tmp_path / "b"),
                                         ckpt_interval=4), step, data_fn,
                            injector=FailureInjector(fail_at=(6,)))
    p_fault, o_fault, m_fault = faulty.run(*fresh(), 0, 10)
    assert clean.restarts == 0 and faulty.restarts == 1
    _leaves_equal({"p": p_clean, "o": o_clean}, {"p": p_fault, "o": o_fault})
    assert int(o_fault.step) == 10
    assert float(m_clean["loss"]) == float(m_fault["loss"])


def test_exceeding_max_restarts_raises(tmp_path):
    fresh, step, data_fn = _runner_setup()
    runner = TrainingRunner(
        RunnerConfig(str(tmp_path / "c"), ckpt_interval=100, max_restarts=1),
        step, data_fn, injector=FailureInjector(fail_at=(2, 3)))
    with pytest.raises(SimulatedFailure):
        runner.run(*fresh(), 0, 6)
    assert runner.restarts == 2


# ---------------------------------------------------------------------- #
#  The plain routes
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("window", [None, 6])
def test_sdpa_chunked_matches_reference(window):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    rcfg = dataclasses.replace(ref_base.reduce_for_smoke(
        ref_config("mixtral-8x22b")), sliding_window=window)
    want = ref_attention._sdpa_chunked(*map(jnp.asarray, (q, k, v)), rcfg,
                                       chunk=4)
    cfg = base.ModelConfig(**dataclasses.asdict(rcfg))
    got = attention._sdpa_chunked(*map(torch.from_numpy, (q, k, v)), cfg,
                                  chunk=4)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).reshape(2, 16, 32),
                               rtol=1e-5, atol=1e-5)
    mask = attention.causal_mask(16, 16, window)[0]
    plain = attention._plain_gqa(torch.from_numpy(q),
                                 torch.from_numpy(k).transpose(1, 2),
                                 torch.from_numpy(v).transpose(1, 2), mask)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("version", [1, 2])
def test_chunked_scan_gradients_match_reference(version):
    """512 steps: two rematerialised 256-step chunks on both sides."""
    rng = np.random.default_rng(version)
    Bz, L, N = 1, 512, 4
    if version == 1:
        Di = 6
        arrs = dict(u=(Bz, L, Di), dt=(Bz, L, Di), Bm=(Bz, L, N),
                    Cm=(Bz, L, N))
        A = -np.exp(rng.standard_normal((Di, N))).astype(np.float32)
        D = rng.standard_normal(Di).astype(np.float32)
        ref_fn, fn = ref_ssm.mamba1_scan, ssm.mamba1_scan
    else:
        H, Pd = 2, 3
        arrs = dict(u=(Bz, L, H, Pd), dt=(Bz, L, H), Bm=(Bz, L, N),
                    Cm=(Bz, L, N))
        A = -np.exp(rng.standard_normal(H)).astype(np.float32)
        D = rng.standard_normal(H).astype(np.float32)
        ref_fn, fn = ref_ssm.mamba2_scan, ssm.mamba2_scan
    x = {k: rng.standard_normal(s).astype(np.float32) for k, s in
         arrs.items()}
    x["dt"] = np.abs(x["dt"]) * 0.1
    w = rng.standard_normal(arrs["u"]).astype(np.float32)

    def ref_loss(u, dt, Bm, Cm):
        y, h = ref_fn(u, dt, jnp.asarray(A), Bm, Cm, jnp.asarray(D))
        return jnp.sum(y * w) + jnp.sum(h)
    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(x[k]) for k in ("u", "dt", "Bm", "Cm")))
    ts = {k: torch.from_numpy(a).requires_grad_(True) for k, a in x.items()}
    y, h = fn(ts["u"], ts["dt"], torch.from_numpy(A), ts["Bm"], ts["Cm"],
              torch.from_numpy(D))
    (torch.sum(y * torch.from_numpy(w)) + torch.sum(h)).backward()
    for k, g in zip(("u", "dt", "Bm", "Cm"), want):
        np.testing.assert_allclose(ts[k].grad.numpy(), np.asarray(g),
                                   rtol=1e-5, atol=1e-5 * float(
                                       np.abs(np.asarray(g)).max()))


# ---------------------------------------------------------------------- #
#  A train step of every reduced architecture
# ---------------------------------------------------------------------- #
def _batch(cfg, seed=1, rows=B):
    S_text = S
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=S_text, global_batch=rows,
                                  seed=seed))
    batch = dict(data.batch(0))
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (rows, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        batch["frames"] = rng.standard_normal(
            (rows, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


@functools.lru_cache(maxsize=None)
def _reference(arch):
    """The reference's grads and train step from its random weights."""
    rcfg = ref_base.reduce_for_smoke(ref_config(arch))
    params = ref_model.init(rcfg, jax.random.PRNGKey(0))
    batch = _batch(rcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    ocfg = ref_adamw.AdamWConfig(**OPT)
    train = ref_step.make_train_step(rcfg, ocfg)

    def grads_and_step(p, b):          # one compile for both
        (loss, aux), grads = jax.value_and_grad(
            lambda p: ref_step.loss_fn(p, b, rcfg), has_aux=True)(p)
        new_p, _, metrics = train(p, ref_adamw.init(p, ocfg), b)
        return loss, aux, grads, new_p, metrics
    loss, aux, grads, new_p, metrics = jax.jit(grads_and_step)(params, jb)
    host = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"cfg": base.ModelConfig(**dataclasses.asdict(rcfg)),
            "arrays": host(params), "batch": batch, "loss": float(loss),
            "aux": {k: float(v) for k, v in aux.items()},
            "grads": host(grads), "new_params": host(new_p),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _port(ref, **cfg_changes):
    cfg = dataclasses.replace(ref["cfg"], **cfg_changes)
    params = model_from_arrays(cfg, ref["arrays"], device="cpu")
    return cfg, params.requires_grad_(True)


def _port_grads(cfg, params, batch):
    loss, aux = train_step.loss_fn(params, batch, cfg, device="cpu")
    named = dict(params.named_parameters())
    gs = torch.autograd.grad(loss, list(named.values()))
    return loss, aux, dict(zip(named, gs))


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_matches_reference(arch):
    ref = _reference(arch)
    cfg, params = _port(ref)
    loss, aux, grads = _port_grads(cfg, params, ref["batch"])
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], **REL)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(float(aux[k].detach()), ref["aux"][k],
                                   **REL)
    want = dict(model_from_arrays(cfg, ref["grads"],
                                  device="cpu").named_parameters())
    for name, g in grads.items():
        w = want[name].numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g.numpy() - w).max())
        assert err <= 1e-4 * scale, (name, err, scale)

    ocfg = adamw.AdamWConfig(**OPT)
    step = train_step.make_train_step(cfg, ocfg, device="cpu")
    _, opt, metrics = step(params, adamw.init(params, ocfg), ref["batch"])
    assert int(opt.step) == 1
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(metrics[k]), ref["metrics"][k],
                                   err_msg=k, **REL)
    new = dict(model_from_arrays(cfg, ref["new_params"],
                                 device="cpu").named_parameters())
    close = total = 0
    for name, p in params.named_parameters():
        d = np.abs(p.detach().numpy() - new[name].numpy())
        assert float(d.max()) <= 2 * LR * (1 + 1e-3), (name, float(d.max()))
        close += int((d <= 1e-5).sum())
        total += d.size
    assert close >= 0.999 * total, (close, total)


def test_remat_full_equals_none():
    ref = _reference("zamba2-7b")
    out = {}
    for remat in ("none", "full"):
        cfg, params = _port(ref, remat=remat)
        out[remat] = _port_grads(cfg, params, ref["batch"])
    assert float(out["none"][0].detach()) == float(out["full"][0].detach())
    for name, g in out["none"][2].items():
        assert torch.equal(g, out["full"][2][name]), name


@pytest.mark.parametrize("arch", ["smollm-360m", "falcon-mamba-7b"])
def test_remat_full_train_step_equals_none(arch):
    ref = _reference(arch)
    ocfg = adamw.AdamWConfig(**OPT)
    got = {}
    for remat in ("none", "full"):
        cfg, params = _port(ref, remat=remat)
        step = train_step.make_train_step(cfg, ocfg, device="cpu")
        _, _, m = step(params, adamw.init(params, ocfg), ref["batch"])
        got[remat] = (model_arrays(params), float(m["loss"]))
    assert got["none"][1] == got["full"][1]
    for a, b in zip(jax.tree.leaves(got["none"][0]),
                    jax.tree.leaves(got["full"][0])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["smollm-360m", "kimi-k2-1t-a32b"])
def test_two_microbatches_equal_one_batch(arch):
    """Two microbatches: the step's loss and update are the mean of the two
    halves' (computed here by hand); without an aux loss that is one batch
    of the same rows. The MoE's load-balance loss is a product of batch
    means, so its halves do not sum to the whole batch's."""
    ref = _reference(arch)
    ocfg = adamw.AdamWConfig(**OPT)
    batch = _batch(ref["cfg"], seed=4, rows=4)
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()}
              for i in range(2)]
    cfg, params = _port(ref)
    parts = [_port_grads(cfg, params, h) for h in halves]
    loss = float((parts[0][0] + parts[1][0]).detach() / 2)
    grads = {n: (parts[0][2][n] + parts[1][2][n]) / 2 for n in parts[0][2]}
    by_hand = dict(params.named_parameters())
    opt = adamw.init(by_hand, ocfg)
    adamw.update(by_hand, grads, opt, ocfg)
    cfg, params = _port(ref)
    step = train_step.make_train_step(cfg, ocfg, microbatches=2,
                                      device="cpu")
    _, _, m = step(params, adamw.init(params, ocfg), batch)
    np.testing.assert_allclose(float(m["loss"]), loss, rtol=1e-6)
    assert float(m["ce"]) == float(m["loss"]) and float(m["aux"]) == 0.0
    for name, p in params.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   by_hand[name].detach().numpy(),
                                   rtol=0, atol=2 * LR, err_msg=name)
    if cfg.family == "moe":
        return
    cfg, whole = _port(ref)
    full_loss, _, full_grads = _port_grads(cfg, whole, batch)
    np.testing.assert_allclose(loss, float(full_loss.detach()), rtol=1e-5)
    for n, g in full_grads.items():
        np.testing.assert_allclose(grads[n].numpy(), g.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(g.abs().max()),
                                   err_msg=n)
    step1 = train_step.make_train_step(cfg, ocfg, device="cpu")
    _, _, m1 = step1(whole, adamw.init(whole, ocfg), batch)
    np.testing.assert_allclose(float(m["loss"]), float(m1["loss"]),
                               rtol=1e-5)
    for name, p in params.named_parameters():
        d = np.abs(p.detach().numpy()
                   - dict(whole.named_parameters())[name].detach().numpy())
        assert float(d.max()) <= 2 * LR and np.mean(d <= 1e-5) >= 0.999


def test_flash_route_with_grad_raises():
    ref = _reference("smollm-360m")
    cfg, params = _port(ref)
    with pytest.raises(ValueError, match="forward-only"):
        model.forward(cfg, params, ref["batch"]["tokens"], device="cpu")
    with pytest.raises(ValueError, match="forward-only"):
        train_step.make_train_step(dataclasses.replace(cfg,
                                                       attn_impl="flash"),
                                   adamw.AdamWConfig(), device="cpu")
    with pytest.raises(ValueError, match="impl"):
        model.forward(cfg, params, ref["batch"]["tokens"], device="cpu",
                      impl="pallas")


def test_frozen_params_refuse_to_train():
    ref = _reference("smollm-360m")
    cfg = ref["cfg"]
    params = model_from_arrays(cfg, ref["arrays"], device="cpu")
    step = train_step.make_train_step(cfg, adamw.AdamWConfig(),
                                      device="cpu")
    with pytest.raises(ValueError, match="requires_grad_"):
        step(params, adamw.init(params, adamw.AdamWConfig()), ref["batch"])


def test_serving_a_trained_model_needs_no_no_grad():
    """prefill and decode_step run without autograd, so a trainable model
    serves through the kernels' route as it is."""
    ref = _reference("smollm-360m")
    cfg, params = _port(ref)
    tokens = ref["batch"]["tokens"]
    logits, cache = model.prefill(cfg, params, tokens, S + 4, device="cpu")
    assert not logits.requires_grad
    logits, _ = model.decode_step(cfg, params, cache, tokens[:, -1:], S,
                                  device="cpu")
    assert not logits.requires_grad


# ---------------------------------------------------------------------- #
#  Optimizer state carried across the packages
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
def test_opt_state_round_trips_the_reference(state_dtype):
    arch = "kimi-k2-1t-a32b"
    rcfg = dataclasses.replace(ref_base.reduce_for_smoke(ref_config(arch)),
                               d_model=128)
    params = ref_model.init(rcfg, jax.random.PRNGKey(0))
    ocfg = ref_adamw.AdamWConfig(state_dtype=state_dtype, **OPT)
    rng = np.random.default_rng(0)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32)), params)
    _, state, _ = jax.jit(lambda p, g: ref_adamw.update(
        p, g, ref_adamw.init(p, ocfg), ocfg))(params, grads)
    cfg = base.ModelConfig(**dataclasses.asdict(rcfg))
    port = model_from_arrays(cfg, jax.tree.map(np.asarray, params),
                             device="cpu")
    st = opt_state_from_arrays(port, jax.tree.map(np.asarray, state))
    quantized = [n for n, m in st.m.items()
                 if isinstance(m, adamw.QuantState)]
    assert bool(quantized) == (state_dtype == "int8")
    assert "layers.0.moe.w_down" in quantized or state_dtype == "float32"
    back = opt_state_arrays(port, st)
    assert int(back["step"]) == 1
    is_q = lambda x: isinstance(x, tuple)  # noqa: E731
    want = jax.tree.leaves({"m": state.m, "v": state.v}, is_leaf=is_q)
    got = jax.tree.leaves({"m": back["m"], "v": back["v"]}, is_leaf=is_q)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        for a, b in zip(w if is_q(w) else (w,), g if is_q(g) else (g,)):
            assert a.shape == b.shape
            np.testing.assert_array_equal(np.asarray(a, b.dtype), b)


def test_reference_run_continues_in_the_port():
    """One reference step, the params and the optimizer state carried
    across, then the second step in both packages."""
    ref = _reference("smollm-360m")
    rcfg = ref_base.reduce_for_smoke(ref_config("smollm-360m"))
    ocfg = ref_adamw.AdamWConfig(**OPT)
    step = jax.jit(ref_step.make_train_step(rcfg, ocfg))
    params = jax.tree.map(jnp.asarray, ref["arrays"])
    b0 = {k: jnp.asarray(v) for k, v in ref["batch"].items()}
    b1 = _batch(rcfg, seed=7)
    params, state, _ = step(params, ref_adamw.init(params, ocfg), b0)
    cfg = ref["cfg"]
    port = model_from_arrays(cfg, jax.tree.map(np.asarray, params),
                             device="cpu").requires_grad_(True)
    st = opt_state_from_arrays(port, jax.tree.map(np.asarray, state))
    params, state, rm = step(params, state,
                             {k: jnp.asarray(v) for k, v in b1.items()})
    _, st, tm = train_step.make_train_step(cfg, adamw.AdamWConfig(**OPT),
                                           device="cpu")(port, st, b1)
    assert int(st.step) == int(state.step) == 2
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(rm[k]), **REL)
    new = dict(model_from_arrays(cfg, jax.tree.map(np.asarray, params),
                                 device="cpu").named_parameters())
    for name, p in port.named_parameters():
        d = float((p.detach() - new[name]).abs().max())
        assert d <= 2 * LR, (name, d)
