"""Distribution in the port against the reference, on the CPU.

* The spec trees: for each of the ten architectures, the port's sanitized
  specs on a stand-in 16x16 and 2x16x16 mesh equal the reference's
  ``sanitize_spec`` output leaf for leaf — parameters (``podify_fsdp``'d
  where ``fsdp_over_pod``), the podified cache, the batch and the AdamW
  state at fp32 and int8. The reference stacks its layers, so its spec is
  read with the leading layer entry dropped. ``sanitize_spec`` reads only
  ``mesh.shape``: no 512-device JAX is needed.
* On 8 gloo ranks (one spawned job, ``GLOO_SCRIPT``): ``compressed_psum``
  with a pod axis of 2 on the reference's multi-device inputs (mean
  within 1e-6 relative of the reference's, residual bit-equal, the
  reference's two bounds, and five rounds of error feedback closing in
  on the exact mean); ``moe_sharded`` on reduced Kimi-K2 in the 4x2
  expert-sharded, 1x8 F-sharded and batch-1 layouts, within the
  reference's own 2e-4 of its ``moe`` and of the port's; the elastic
  restore from a 4x2 mesh to 2x2, exact, and checkpoints crossing between
  the packages both ways; a reduced Zamba2 Mamba-2 block on the 4x2 mesh
  through the scan wrapper (serving's route: once a rank, on its heads),
  equal to the meshless block; and the model path on the 4x2 mesh (parameters,
  AdamW state, batch and cache as DTensors by their specs) for reduced
  SmolLM, Mixtral, Falcon-Mamba, Whisper and Zamba2, Whisper with 15
  encoder frames (split unevenly over ``model``) and SmolLM with 3 query
  heads on 1 KV head (query-parallel attention): the forward, a prefill
  and a decode step against the port with no mesh, and a train step (loss,
  grads, updated params) against both the port with no mesh and the
  reference's train step, at the train tests' tolerances (each test
  states its own).

The reference's multi-device results come from one subprocess with 8
host devices, as its own tests run them.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as RP

from repro.ckpt import checkpoint as r_ckpt
from repro.configs import get_config as r_config
from repro.configs.base import SHAPES as R_SHAPES
from repro.configs.base import reduce_for_smoke as r_reduce
from repro.models import model as r_model
from repro.models import moe as r_moe
from repro.optim import adamw as r_adamw
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import dryrun as dr
from repro_torch.models import model
from repro_torch.models.common import P, podify, sanitize_spec
from repro_torch.optim import adamw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_dryrun():
    """The reference's dry-run module. Importing it sets XLA_FLAGS for 512
    host devices, which only takes effect before JAX starts: start JAX
    first, and put the variable back."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as rdr
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return rdr


RDR = _reference_dryrun()
MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}
_STACKS = ("layers", "dense_layers", "enc_layers", "dec_layers")


def _mesh(axes):
    return types.SimpleNamespace(shape=dict(axes))


def _port_shapes(cfg) -> dict:
    """{parameter name: shape} of the port's model, on the meta device."""
    mod = model._family_module(cfg).LM(cfg, "meta")
    return {n: tuple(p.shape) for n, p in mod.named_parameters()}


def _ref_leaf(tree, name):
    node = tree
    for part in name.split("."):
        if not part.isdigit():
            node = node[part]
    return node


def _stacked(name) -> bool:
    return name.split(".")[0] in _STACKS


def _ref_sanitized(spec, shape, name, mesh):
    """The reference's sanitized spec of a parameter-shaped leaf, its
    layer entry dropped for a stacked one."""
    if _stacked(name):
        out = RDR.sanitize_spec(spec, (2,) + tuple(shape), mesh)
        assert tuple(out)[0] is None
        return tuple(out)[1:]
    return tuple(RDR.sanitize_spec(spec, tuple(shape), mesh))


def _param_specs(arch, mesh_axes):
    cfg = get_config(arch)
    p_port = model.param_specs(cfg)
    p_ref = r_model.param_specs(r_config(arch))
    if cfg.fsdp_over_pod and "pod" in mesh_axes:
        p_port, p_ref = dr.podify_fsdp(p_port), RDR.podify_fsdp(p_ref)
    return p_port, p_ref


CASES = [(arch, mesh) for arch in ARCH_IDS for mesh in MESHES]


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_param_specs_equal_reference(arch, mesh_name):
    cfg = get_config(arch)
    axes = MESHES[mesh_name]
    mesh = _mesh(axes)
    p_port, p_ref = _param_specs(arch, axes)
    shapes = _port_shapes(cfg)
    named = model.named_specs(p_port, shapes)
    assert set(named) == set(shapes)
    for name, shape in shapes.items():
        got = tuple(sanitize_spec(named[name], shape, axes))
        want = _ref_sanitized(_ref_leaf(p_ref, name), shape, name, mesh)
        assert got == want, (name, got, want)


@pytest.mark.parametrize("state_dtype", ["float32", "int8"])
@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_state_specs_equal_reference(arch, mesh_name, state_dtype):
    cfg = get_config(arch)
    axes = MESHES[mesh_name]
    mesh = _mesh(axes)
    p_port, p_ref = _param_specs(arch, axes)
    shapes = _port_shapes(cfg)
    named = model.named_specs(p_port, shapes)
    s_port = adamw.state_specs(named, shapes,
                               adamw.AdamWConfig(state_dtype=state_dtype))
    rcfg = r_adamw.AdamWConfig(state_dtype=state_dtype)
    assert tuple(s_port.step) == tuple(RP()) == ()
    n_quant = 0
    for name, shape in shapes.items():
        ref_spec = _ref_leaf(p_ref, name)
        ref_shape = ((2,) + shape) if _stacked(name) else shape
        one = r_adamw.state_specs({"x": ref_spec}, {"x": ref_shape}, rcfg)
        m_ref, v_ref = one.m["x"], one.v["x"]
        m_port, v_port = s_port.m[name], s_port.v[name]
        assert tuple(sanitize_spec(v_port, shape, axes)) == \
            _ref_sanitized(v_ref, shape, name, mesh)
        if isinstance(m_ref, r_adamw.QuantState):
            n_quant += 1
            assert isinstance(m_port, adamw.QuantState), name
            scale = shape[:-1] + (shape[-1] // adamw.BLOCK,)
            assert tuple(sanitize_spec(m_port.q, shape, axes)) == \
                _ref_sanitized(m_ref.q, shape, name, mesh)
            assert tuple(sanitize_spec(m_port.scale, scale, axes)) == \
                _ref_sanitized(m_ref.scale, scale, name, mesh)
        else:
            assert not isinstance(m_port, adamw.QuantState), name
            assert tuple(sanitize_spec(m_port, shape, axes)) == \
                _ref_sanitized(m_ref, shape, name, mesh)
    assert (n_quant > 0) == (state_dtype == "int8")


def _flat_specs(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat_specs(v, prefix + (k,))
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_cache_and_batch_specs_equal_reference(arch, mesh_name):
    cfg = get_config(arch)
    axes = MESHES[mesh_name]
    mesh = _mesh(axes)
    c_port = podify(model.cache_specs(cfg))
    c_ref = RDR.podify(r_model.cache_specs(r_config(arch)))
    shape = SHAPES["decode_32k"]
    cache = model._family_module(cfg).init_cache(
        cfg, shape.global_batch, shape.seq_len, torch.bfloat16, "meta")
    flat_port = dict(_flat_specs(c_port))
    flat_ref = dict(_flat_specs(c_ref))
    assert set(flat_port) == set(flat_ref)
    for path, spec in flat_port.items():
        leaf = cache
        for k in path:
            leaf = leaf[k]
        assert tuple(sanitize_spec(spec, tuple(leaf.shape), axes)) == \
            tuple(RDR.sanitize_spec(flat_ref[path], tuple(leaf.shape),
                                    mesh)), path
    rcfg = r_config(arch)
    for name, shp in SHAPES.items():
        b_port = dr.batch_specs(cfg, shp)
        b_ref = RDR.batch_specs(rcfg, R_SHAPES[name])
        d_port = dr.input_specs(cfg, shp)
        d_ref = RDR.input_specs(rcfg, R_SHAPES[name])
        assert set(b_port) == set(b_ref) == set(d_port) == set(d_ref)
        for k in b_port:
            assert tuple(d_port[k].shape) == tuple(d_ref[k].shape)
            assert tuple(sanitize_spec(b_port[k], d_port[k].shape, axes)) \
                == tuple(RDR.sanitize_spec(b_ref[k], d_ref[k].shape, mesh))


def test_sanitize_spec_reference_cases():
    """The reference's own two cases (tests/test_dryrun.py) and a few
    more, against its ``sanitize_spec``."""
    mesh = {"data": 4, "model": 2}
    cases = [(("model", "data"), (51867, 64)),
             ((("pod", "data"), None), (128, 4)),
             ((("data", "model"), None), (8, 3)),
             ((("data", "model"), None), (12, 3)),
             ((("model", "data"), "pod"), (6, 7)),
             ((None, ("pod", "data", "model")), (3, 64))]
    assert tuple(sanitize_spec(P("model", "data"), (51867, 64), mesh)) == \
        (None, "data")
    assert tuple(sanitize_spec(P(("pod", "data"), None), (128, 4),
                               mesh)) == ("data", None)
    for spec, shape in cases:
        for axes in (mesh, MESHES["2x16x16"]):
            assert tuple(sanitize_spec(P(*spec), shape, axes)) == tuple(
                RDR.sanitize_spec(RP(*spec), shape, _mesh(axes)))


# ---------------------------------------------------------------------- #
#  8 gloo ranks against the reference's 8 host devices
# ---------------------------------------------------------------------- #
def arch_config(get_config, reduce_for_smoke, arch):
    """The reduced config of ``arch``: a name, or ``name:field=value+...``
    with integer fields of the reduced config overridden (the scripts
    below carry this function's source)."""
    import dataclasses
    name, _, over = arch.partition(":")
    return dataclasses.replace(reduce_for_smoke(get_config(name)), **{
        k: int(v) for k, v in (o.split("=") for o in over.split("+") if o)})


REF_SCRIPT = inspect.getsource(arch_config) + textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    from functools import partial
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from repro.dist.collectives import compressed_psum
    from repro.launch.mesh import make_mesh
    from repro.models.common import shard_map

    mesh = make_mesh((2, 4), ("pod", "data"))
    g = jax.random.normal(jax.random.PRNGKey(0), (2, 256))

    @partial(shard_map, mesh=mesh, in_specs=(P("pod"), P("pod")),
             out_specs=(P("pod"), P("pod")))
    def reduce_fn(g_local, err):
        out, new_err = compressed_psum({"g": g_local}, "pod", {"g": err})
        return out["g"], new_err["g"]

    err = jnp.zeros_like(g)
    outs, errs = [], []
    for _ in range(5):
        out, err = reduce_fn(g, err)
        outs.append(np.asarray(out))
        errs.append(np.asarray(err))
    res = dict(g=np.asarray(g), outs=np.stack(outs), errs=np.stack(errs))

    # the expert-parallel MoE in the three layouts (its own test's)
    import dataclasses as dc
    from repro.configs import get_config
    from repro.configs.base import reduce_for_smoke
    from repro.launch.mesh import set_mesh
    from repro.models.moe import init_moe, moe_sharded
    cfg = dc.replace(reduce_for_smoke(get_config("kimi-k2-1t-a32b")),
                     capacity_factor=4.0)
    p = init_moe(jax.random.PRNGKey(0), cfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model),
                          jnp.float32)
    mesh42 = make_mesh((4, 2), ("data", "model"))
    mesh18 = make_mesh((1, 8), ("data", "model"))
    for tag, m, xx in (("e", mesh42, x), ("f", mesh18, x),
                       ("b1", mesh42, x[:1])):
        with set_mesh(m):
            out, aux = jax.jit(lambda p, x: moe_sharded(p, x, cfg))(p, xx)
        res["moe_" + tag] = np.asarray(out)
        res["aux_" + tag] = np.asarray(aux)
    np.savez(sys.argv[1], **res)

    # a train step of each reduced model of MODEL_ARCHS: meshless, and
    # for the MoE on the 4x2 mesh (its load-balance loss is then the
    # mean of the batch shards', as its moe_sharded computes it)
    import pickle
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.models import model as rm
    from repro.optim import adamw
    from repro.train import step as rs
    host = lambda t: jax.tree.map(np.asarray, t)
    models = {}
    for arch in sys.argv[2].split(","):
        cfg = arch_config(get_config, reduce_for_smoke, arch)
        params = rm.init(cfg, jax.random.PRNGKey(0))
        batch = dict(SyntheticLM(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=int(sys.argv[3]),
            global_batch=int(sys.argv[4]), seed=1)).batch(0))
        rng = np.random.default_rng(1)
        if cfg.family == "audio":
            batch["frames"] = rng.standard_normal(
                (len(batch["tokens"]), cfg.encoder_seq, cfg.d_model)
            ).astype(np.float32)
        ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=50)
        train = rs.make_train_step(cfg, ocfg)

        def grads_and_step(p, b):
            (loss, aux), grads = jax.value_and_grad(
                lambda p: rs.loss_fn(p, b, cfg), has_aux=True)(p)
            new_p, _, metrics = train(p, adamw.init(p, ocfg), b)
            return loss, aux, grads, new_p, metrics
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        if cfg.family == "moe":
            with set_mesh(mesh42):
                out = jax.jit(grads_and_step)(params, jb)
        else:
            out = jax.jit(grads_and_step)(params, jb)
        loss, aux, grads, new_p, metrics = host(out)
        models[arch] = dict(arrays=host(params), batch=batch, loss=loss,
                            aux=aux, grads=grads, new_params=new_p,
                            metrics=metrics)
    with open(sys.argv[1] + ".models.pkl", "wb") as f:
        pickle.dump(models, f)
    print("REF_OK")
""")

GLOO_SCRIPT = inspect.getsource(arch_config) + textwrap.dedent("""
    import os, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp


    def work(rank, out_dir, world):
        torch.set_num_threads(1)
        dist.init_process_group("gloo", init_method=f"file://{out_dir}/store",
                                rank=rank, world_size=world)
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.ckpt import checkpoint as ckpt
        from repro_torch.configs import get_config
        from repro_torch.configs.base import reduce_for_smoke
        from repro_torch.dist.collectives import compressed_psum, init_error
        from repro_torch.launch.mesh import make_mesh, set_mesh
        from repro_torch.models import moe as moe_mod
        from repro_torch.models.common import P, placements
        import dataclasses as dc
        res = {}
        inp = np.load(f"{out_dir}/inputs.npz")

        # --- compressed psum over the pod axis, 5 rounds -------------
        mesh = make_mesh((2, 4), ("pod", "data"), "cpu")
        pod = mesh.get_local_rank("pod")
        g = {"g": torch.from_numpy(inp["g"][pod:pod + 1].copy())}
        err = init_error(g)
        outs, errs = [], []
        for _ in range(5):
            out, err = compressed_psum(g, (mesh, "pod"), err)
            outs.append(out["g"].numpy())
            errs.append(err["g"].numpy())
        res["psum_outs"] = np.stack(outs)
        res["psum_errs"] = np.stack(errs)

        # --- expert-parallel MoE in three layouts ----------------------
        cfg = dc.replace(reduce_for_smoke(get_config("kimi-k2-1t-a32b")),
                         capacity_factor=4.0)
        p = moe_mod.MoE(cfg, "cpu")
        with torch.no_grad():
            for name, t in p.named_parameters():
                t.copy_(torch.from_numpy(inp["moe." + name]))
        x = torch.from_numpy(inp["x"])
        mesh42 = make_mesh((4, 2), ("data", "model"), "cpu")
        mesh18 = make_mesh((1, 8), ("data", "model"), "cpu")
        for tag, m, xx in (("e", mesh42, x), ("f", mesh18, x),
                           ("b1", mesh42, x[:1])):
            with torch.no_grad(), set_mesh(m):
                out, aux = moe_mod.moe(p, xx, cfg)
            res["moe_" + tag] = out.full_tensor().numpy()
            res["aux_" + tag] = np.asarray(aux.full_tensor().item())

        # --- elastic restore: save on 4x2, restore on 2x2 ---------------
        w = torch.arange(64.0).reshape(8, 8)
        w8 = distribute_tensor(w, mesh42, placements(mesh42,
                                                     P("data", "model")))
        ckpt.save(f"{out_dir}/port_ckpt", 0, {"w": w8})
        mesh4 = make_mesh((2, 2), ("data", "model"), "cpu", ranks=range(4))
        if rank < 4:
            spec = {"w": P("data", "model")}
            got, _ = ckpt.restore(f"{out_dir}/port_ckpt", {"w": w},
                                  mesh=mesh4, specs=spec)
            res["elastic_local"] = got["w"].to_local().numpy()
            res["elastic_full"] = got["w"].full_tensor().numpy()
            res["elastic_coord"] = np.asarray(mesh4.get_coordinate())
            ref, _ = ckpt.restore(f"{out_dir}/ref_ckpt", {"w": w},
                                  mesh=mesh4, specs=spec)
            res["ref_local"] = ref["w"].to_local().numpy()

        # --- the Mamba-2 block's serving route on the 4x2 mesh ----------
        from torch.distributed.tensor.experimental import \
            implicit_replication
        from repro_torch.kernels import ops as kops
        from repro_torch.models import ssm
        from repro_torch.models.common import sanitize_spec, to_dtensor
        cfg = dc.replace(reduce_for_smoke(get_config("zamba2-7b")),
                         param_dtype="float32")
        p = ssm.Mamba2(cfg, "cpu")
        p.reset_parameters(torch.Generator().manual_seed(3))
        dp = ssm.Mamba2(cfg, "meta")
        specs = ssm.spec_mamba(cfg)
        for name, t in p.named_parameters():
            dp._parameters[name] = torch.nn.Parameter(to_dtensor(
                t, mesh42, sanitize_spec(specs[name], tuple(t.shape),
                                         mesh42)), requires_grad=False)
        x = torch.from_numpy(inp["m2_x"])
        scans = []
        scan = kops.mamba_scan

        def counted(*a):
            scans.append(tuple(a[0].shape))
            return scan(*a)
        kops.mamba_scan = counted
        with torch.no_grad():
            want, want_st = ssm.mamba2_block(p, x, cfg)
            del scans[:]
            with implicit_replication(), set_mesh(mesh42):
                got, st = ssm.mamba2_block(
                    dp, to_dtensor(x, mesh42, P("data", None, None)), cfg)
        kops.mamba_scan = scan
        res["m2_scans"] = np.asarray(scans)
        res["m2_plain"], res["m2_mesh"] = want.numpy(), \
            got.full_tensor().numpy()
        res["m2_state"], res["m2_mesh_state"] = want_st["ssm"].numpy(), \
            st["ssm"].full_tensor().numpy()
        np.savez(f"{out_dir}/rank{rank}.npz", **res)

        # --- the model path on the 4x2 mesh and without one -------------
        with open(f"{out_dir}/ref.npz.models.pkl", "rb") as f:
            ref_models = pickle.load(f)
        for arch, ref in ref_models.items():
            got = model_path(arch, ref, mesh42)
            if rank == 0:
                np.savez(f"{out_dir}/model_{arch}.npz", **got)
        dist.barrier()
        dist.destroy_process_group()


    def _flat(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from _flat(v, f"{prefix}/{k}")
        else:
            yield prefix, tree


    def _on_mesh(tree, specs, mesh):
        '''A tree of tensors as DTensors laid out by ``specs``.'''
        from torch.distributed.tensor import distribute_tensor
        from repro_torch.models.common import placements, sanitize_spec
        if isinstance(tree, dict):
            return {k: _on_mesh(v, specs[k], mesh) for k, v in tree.items()}
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*(_on_mesh(v, s, mesh)
                                for v, s in zip(tree, specs)))
        spec = sanitize_spec(specs, tuple(tree.shape), mesh)
        return distribute_tensor(tree.detach().clone(), mesh,
                                 placements(mesh, spec))


    def model_path(arch, ref, mesh):
        '''Forward, prefill, a decode step and a train step of the
        reduced ``arch`` with no mesh and on ``mesh`` (parameters,
        optimizer state, batch and cache as DTensors by their specs),
        from the reference's weights; every result as a global array.'''
        import copy
        from torch import nn
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import \
            implicit_replication
        from repro_torch.configs import get_config
        from repro_torch.configs.base import SHAPES, reduce_for_smoke
        from repro_torch.convert import model_from_arrays
        from repro_torch.launch import dryrun as dr
        from repro_torch.launch.mesh import set_mesh
        from repro_torch.models import model
        from repro_torch.models.common import podify
        from repro_torch.optim import adamw
        from repro_torch.train import serve, step as ts

        def full(t):
            t = t.full_tensor() if isinstance(t, DTensor) else t
            return t.detach().float().numpy()

        cfg = arch_config(get_config, reduce_for_smoke, arch)
        batch = {k: torch.from_numpy(np.asarray(v))
                 for k, v in ref["batch"].items()}
        extra = {k: v for k, v in batch.items()
                 if k not in ("tokens", "labels")}
        B, S = batch["tokens"].shape
        params = model_from_arrays(cfg, ref["arrays"], device="cpu")
        specs = model.named_specs(model.param_specs(cfg), params)
        dparams = copy.deepcopy(params)
        for mname, m in dparams.named_modules():
            for pname, p in list(m._parameters.items()):
                name = f"{mname}.{pname}" if mname else pname
                m._parameters[pname] = nn.Parameter(
                    _on_mesh(p, specs[name], mesh), requires_grad=False)
        dbatch = _on_mesh(batch, dr.batch_specs(cfg, SHAPES["train_4k"]),
                          mesh)
        dextra = {k: v for k, v in dbatch.items() if k in extra}
        c_specs = podify(model.cache_specs(cfg))
        out = {}

        # serving: no grad, the weights as given
        pre = serve.make_prefill_step(cfg, max_seq=S + 4, device="cpu",
                                      impl="xla")
        dec = serve.make_serve_step(cfg, device="cpu")
        with torch.no_grad():
            logits, _ = model.forward(cfg, params, batch["tokens"], extra,
                                      device="cpu", impl="xla")
            p_logits, cache = pre(params, batch["tokens"], extra)
            p_cache = copy.deepcopy(cache)
            tok = p_logits[:, -1:].argmax(-1).to(torch.int32)
            # the decode step on the mesh starts from the same cache
            m_cache = _on_mesh(cache, c_specs, mesh)
            d_logits, d_cache = dec(params, cache, tok, S)
        with torch.no_grad(), implicit_replication(), set_mesh(mesh):
            m_logits, _ = model.forward(cfg, dparams, dbatch["tokens"],
                                        dextra, device="cpu", impl="xla")
            mp_logits, mp_cache = pre(dparams, dbatch["tokens"], dextra)
            dtok = _on_mesh(tok, dr.batch_specs(
                cfg, SHAPES["decode_32k"])["tokens"], mesh)
            md_logits, md_cache = dec(dparams, m_cache, dtok, S)
        out["logits"], out["m.logits"] = full(logits), full(m_logits)
        out["prefill"], out["m.prefill"] = full(p_logits), full(mp_logits)
        out["decode"], out["m.decode"] = full(d_logits), full(md_logits)
        for key, tree in (("pcache", p_cache), ("m.pcache", mp_cache),
                          ("dcache", d_cache), ("m.dcache", md_cache)):
            for path, t in _flat(tree):
                bf16 = "@bf16" if t.dtype == torch.bfloat16 else ""
                out[key + path + bf16] = full(t)

        # training, fp32 AdamW state (and int8 for the dense model)
        kinds = ("float32", "int8") if cfg.family == "dense" else \
            ("float32",)
        for state in kinds:
            tag = "" if state == "float32" else "int8."
            ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1,
                                     total_steps=50, state_dtype=state)
            p = copy.deepcopy(params).requires_grad_(True)
            dp = copy.deepcopy(dparams).requires_grad_(True)
            opt = adamw.init(p, ocfg)
            shapes = {n: t.shape for n, t in p.named_parameters()}
            d_opt = _on_mesh(opt, adamw.state_specs(specs, shapes, ocfg),
                             mesh)
            loss, aux, grads = _meshless_grads(cfg, p, batch, mesh)
            metrics = adamw.update(p, grads, opt, ocfg)
            with implicit_replication(), set_mesh(mesh):
                m_loss, m_aux = ts.loss_fn(dp, dbatch, cfg, device="cpu")
                named = dict(dp.named_parameters())
                m_grads = dict(zip(named, torch.autograd.grad(
                    m_loss, list(named.values()))))
                step = ts.make_train_step(cfg, ocfg, device="cpu")
                _, _, m_metrics = step(dp, d_opt, dbatch)
            out[tag + "loss"], out[tag + "m.loss"] = full(loss), full(m_loss)
            for k in ("ce", "aux"):
                out[tag + k] = full(aux[k])
                out[tag + "m." + k] = full(m_aux[k])
            for k in ("grad_norm", "lr"):
                out[tag + k] = full(metrics[k])
                out[tag + "m." + k] = full(m_metrics[k])
            for n, g in grads.items():
                out[tag + "grad." + n] = full(g)
                out[tag + "m.grad." + n] = full(m_grads[n])
            d_named = dict(dp.named_parameters())
            for n, t in p.named_parameters():
                out[tag + "new." + n] = full(t)
                out[tag + "m.new." + n] = full(d_named[n])
        return out


    def _meshless_grads(cfg, params, batch, mesh):
        '''(loss, {ce, aux}, grads) of the train step with no mesh. Under
        a mesh the MoE's load-balance loss is the mean of the batch
        shards' (the reference's ``moe_sharded`` takes the same mean):
        here that is the mean of the loss of each shard's rows.'''
        from repro_torch.models import model
        from repro_torch.train import step as ts
        loss, aux = ts.loss_fn(params, batch, cfg, device="cpu")
        if cfg.family == "moe":
            n = mesh.shape[mesh.mesh_dim_names.index("data")]
            b = len(batch["tokens"]) // n
            shards = [model.forward(cfg, params,
                                    batch["tokens"][i * b:(i + 1) * b],
                                    device="cpu", impl="xla")[1]
                      for i in range(n)]
            aux = {"ce": aux["ce"], "aux": torch.stack(shards).mean()}
            loss = aux["ce"] + 0.01 * aux["aux"]
        named = dict(params.named_parameters())
        grads = dict(zip(named, torch.autograd.grad(
            loss, list(named.values()))))
        return loss, aux, grads


    if __name__ == "__main__":
        mp.spawn(work, args=(sys.argv[1], 8), nprocs=8, join=True)
        print("GLOO_OK")
""")


#: the model path on the 4x2 gloo mesh: these reduced models (an
#: ``arch:field=value+...`` entry overrides fields of the reduced config:
#: Whisper with 15 encoder frames, which the 2-way ``model`` axis splits
#: unevenly, and SmolLM with 3 query heads, which it does not divide:
#: query-parallel attention), a batch of MODEL_BATCH rows (one a
#: ``data`` shard) of MODEL_SEQ tokens
MODEL_ARCHS = ("smollm-360m", "mixtral-8x22b", "falcon-mamba-7b",
               "whisper-large-v3", "zamba2-7b",
               "whisper-large-v3:encoder_seq=15",
               "smollm-360m:n_heads=3+n_kv_heads=1")
MODEL_SEQ, MODEL_BATCH = 12, 4
LR = 1e-3


def _run(script, path, *args, timeout=600):
    """Run ``script`` (written to ``path``: spawned workers re-import
    it) with ``args``; returns its standard output."""
    with open(path, "w") as f:
        f.write(script)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, path, *args],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=timeout)
    assert r.returncode == 0, r.stderr[-4000:]
    return r.stdout


def _kimi():
    cfg = dataclasses.replace(r_reduce(r_config("kimi-k2-1t-a32b")),
                              capacity_factor=4.0)
    p = r_moe.init_moe(jax.random.PRNGKey(0), cfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (4, 16, cfg.d_model),
                          jnp.float32)
    return cfg, p, x


@functools.lru_cache(maxsize=1)
def _gloo_results(tmp):
    """Both packages' multi-device results, computed once."""
    out = os.path.join(tmp, "gloo")
    os.makedirs(out, exist_ok=True)
    assert "REF_OK" in _run(REF_SCRIPT, os.path.join(out, "ref.py"),
                            os.path.join(out, "ref.npz"),
                            ",".join(MODEL_ARCHS), str(MODEL_SEQ),
                            str(MODEL_BATCH))
    ref = dict(np.load(os.path.join(out, "ref.npz")))
    cfg, p, x = _kimi()
    m2 = r_config("zamba2-7b")
    arrays = {"g": ref["g"], "x": np.asarray(x),
              "m2_x": np.random.default_rng(4).standard_normal(
                  (MODEL_BATCH, MODEL_SEQ, r_reduce(m2).d_model)).astype(
                      np.float32)}
    flat = {"router": p["router"], "w_gate": p["w_gate"], "w_up": p["w_up"],
            "w_down": p["w_down"]}
    for k, v in p["shared"].items():
        flat["shared." + k] = v
    arrays.update({"moe." + k: np.asarray(v, np.float32)
                   for k, v in flat.items()})
    np.savez(os.path.join(out, "inputs.npz"), **arrays)
    r_ckpt.save(os.path.join(out, "ref_ckpt"), 0,
                {"w": jnp.arange(64.0).reshape(8, 8)})
    assert "GLOO_OK" in _run(GLOO_SCRIPT, os.path.join(out, "gloo.py"), out)
    ranks = [dict(np.load(os.path.join(out, f"rank{r}.npz")))
             for r in range(8)]
    return out, ref, ranks


@functools.lru_cache(maxsize=None)
def _model_results(out, arch):
    """(the port's results on the mesh and without one, the reference's
    train step) for ``arch``; ``m.``-prefixed keys are the mesh's."""
    import pickle
    got = dict(np.load(os.path.join(out, f"model_{arch}.npz")))
    with open(os.path.join(out, "ref.npz.models.pkl"), "rb") as f:
        return got, pickle.load(f)[arch]


@pytest.fixture(scope="module")
def gloo(tmp_path_factory):
    return _gloo_results(str(tmp_path_factory.mktemp("dist")))


def test_compressed_psum_matches_reference(gloo):
    _, ref, ranks = gloo
    g = ref["g"]
    for rank, res in enumerate(ranks):
        pod = rank // 4        # mesh (pod=2, data=4), rank-major
        want = ref["outs"][:, pod:pod + 1]
        got = res["psum_outs"]
        rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
        assert rel <= 1e-6, rel
        # the residual is computed on the rank alone: bit for bit
        np.testing.assert_array_equal(res["psum_errs"],
                                      ref["errs"][:, pod:pod + 1])
        exact = g.mean(axis=0, keepdims=True)
        assert np.max(np.abs(got[0] - exact)) / np.max(np.abs(exact)) < 0.05
        assert np.max(np.abs(res["psum_errs"][0])) <= \
            np.max(np.abs(g)) / 127 + 1e-6


def test_compressed_psum_error_feedback_converges(gloo):
    """Error feedback: the mean of the first r rounds' outputs closes in
    on the exact mean (the residual carried forward is bounded)."""
    _, ref, ranks = gloo
    exact = ref["g"].mean(axis=0, keepdims=True)
    outs = ranks[0]["psum_outs"]
    errs = [np.max(np.abs(outs[:r].mean(axis=0) - exact))
            for r in range(1, 6)]
    assert errs[-1] < errs[0] / 2, errs
    bound = np.max(np.abs(ref["g"])) / 127
    for r, e in enumerate(errs, start=1):
        assert e <= bound / r + 1e-6, (r, e)


@pytest.mark.parametrize("layout", ["e", "f", "b1"])
def test_moe_sharded_matches_reference(gloo, layout):
    """4x2 expert-sharded (E=4 over tp=2), 1x8 F-sharded (tp=8 > E=4),
    and batch 1 on 4x2: within the reference's 2e-4 of its meshless
    ``moe``, of the port's, and of the reference's ``moe_sharded``. The
    load-balance loss is the mean over the batch shards of each shard's
    (the reference's ``pmean``), so it is held to the reference's
    ``moe_sharded``, and equals the meshless one where the batch is not
    split."""
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.models import moe as moe_mod
    _, ref, ranks = gloo
    cfg, p, x = _kimi()
    xx = x[:1] if layout == "b1" else x
    want, want_aux = r_moe.moe(p, xx, cfg)
    pcfg = dataclasses.replace(reduce_for_smoke(get_config(
        "kimi-k2-1t-a32b")), capacity_factor=4.0)
    pm = moe_mod.MoE(pcfg, "cpu")
    inp = np.load(os.path.join(gloo[0], "inputs.npz"))
    with torch.no_grad():
        for name, t in pm.named_parameters():
            t.copy_(torch.from_numpy(inp["moe." + name]))
        port, port_aux = moe_mod.moe(pm, torch.from_numpy(np.array(xx)),
                                     pcfg)
    for res in ranks:
        got = res["moe_" + layout]
        assert np.max(np.abs(got - np.asarray(want))) < 2e-4
        assert np.max(np.abs(got - port.numpy())) < 2e-4
        assert np.max(np.abs(got - ref["moe_" + layout])) < 2e-4
        aux = float(res["aux_" + layout])
        assert abs(aux - float(ref["aux_" + layout])) < 2e-4
        if layout != "e":     # one batch shard: the meshless loss
            assert abs(aux - float(want_aux)) < 2e-4
            assert abs(aux - float(port_aux)) < 2e-4


def test_elastic_restore_4x2_to_2x2(gloo):
    _, _, ranks = gloo
    w = np.arange(64.0, dtype=np.float32).reshape(8, 8)
    for rank in range(4):
        res = ranks[rank]
        np.testing.assert_array_equal(res["elastic_full"], w)
        i, j = res["elastic_coord"]
        np.testing.assert_array_equal(res["elastic_local"],
                                      w[4 * i:4 * i + 4, 4 * j:4 * j + 4])
        # the reference's checkpoint restores in the port, shard by shard
        np.testing.assert_array_equal(res["ref_local"],
                                      w[4 * i:4 * i + 4, 4 * j:4 * j + 4])
    for rank in range(4, 8):
        assert "elastic_local" not in ranks[rank]


def test_mamba2_block_on_mesh_takes_the_scan_route(gloo):
    """The Mamba-2 block's serving route (``impl="flash"``) on the 4x2
    mesh: each rank runs the scan wrapper once, on its batch row and its
    half of the heads (the kernel on the card; its plain version here),
    and the block equals the meshless one: output within 1e-5 of its
    max, the final state within 1e-5 of its max."""
    _, _, ranks = gloo
    from repro_torch.configs.base import reduce_for_smoke
    cfg = reduce_for_smoke(get_config("zamba2-7b"))
    for res in ranks:
        np.testing.assert_array_equal(
            res["m2_scans"], [[1, MODEL_SEQ, cfg.d_inner // 2]])
    _close(ranks[0]["m2_mesh"], ranks[0]["m2_plain"], 1e-5, "output")
    _close(ranks[0]["m2_mesh_state"], ranks[0]["m2_state"], 1e-5, "state")


def test_port_checkpoint_of_a_dtensor_restores_in_reference(gloo):
    out, _, _ = gloo
    got, _ = r_ckpt.restore(os.path.join(out, "port_ckpt"),
                            {"w": jnp.zeros((8, 8))})
    np.testing.assert_array_equal(
        np.asarray(got["w"]), np.arange(64.0, dtype=np.float32).reshape(8, 8))


def _close(got, want, frac, what):
    err = float(np.max(np.abs(got - want)))
    scale = max(float(np.max(np.abs(want))), 1e-30)
    assert err <= frac * scale, (what, err, scale)


def _port_names(cfg, tree) -> dict:
    """A reference parameter-shaped tree by the port's parameter names."""
    from repro_torch.convert import model_from_arrays
    return {n: p.detach().numpy() for n, p in model_from_arrays(
        cfg, tree, device="cpu").named_parameters()}


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_mesh_serving_matches_meshless(gloo, arch):
    """Forward, prefill and one decode step (from the same cache) on the
    4x2 mesh against the port with no mesh: logits within 1e-5 of their
    max; bf16 cache entries within one bf16 ulp (2**-7 of the entry: the
    fp32 values they round differ in the last bits) plus 1e-6 of the
    leaf's max (entries near 0, whose ulp is below that fp32 difference),
    fp32 ones (the SSM states) within 1e-5 of their max."""
    got, _ = _model_results(gloo[0], arch)
    for k in ("logits", "prefill", "decode"):
        _close(got["m." + k], got[k], 1e-5, k)
    n_cache = 0
    for key in [k for k in got if k.startswith(("pcache/", "dcache/"))]:
        a, b = got["m." + key], got[key]
        if key.endswith("@bf16"):
            bound = 2.0 ** -7 * np.abs(b) + 1e-6 * np.max(np.abs(b))
            assert np.all(np.abs(a - b) <= bound), key
        else:
            _close(a, b, 1e-5, key)
        n_cache += 1
    assert n_cache >= 4


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_mesh_train_step_matches_meshless_and_reference(gloo, arch):
    """One train step on the 4x2 mesh (FSDP over ``data``, tensor
    parallelism over ``model``: the Megatron products, the vocab-parallel
    embedding and loss, key-parallel attention, the expert-parallel MoE,
    AdamW on sharded state), each result gathered, against the port with
    no mesh and against the reference's train step, at the train tests'
    tolerances: loss, ce, aux and grad_norm 1e-5 relative, every grad
    leaf within 1e-4 of its max, new params within 2 lr and within 1e-5
    on >= 99.9 % of the entries. The MoE's load-balance loss is the mean
    of the batch shards' under a mesh, in both packages: the meshless
    port computes that mean from each shard's rows, and the reference
    runs its train step on the same 4x2 mesh. The dense model also runs
    with int8 AdamW state, against the meshless int8 step."""
    from repro_torch.configs.base import reduce_for_smoke
    got, ref = _model_results(gloo[0], arch)
    cfg = arch_config(get_config, reduce_for_smoke, arch)
    rel = dict(rtol=1e-5, atol=0.0)
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(got["m." + k], got[k], err_msg=k, **rel)
    np.testing.assert_allclose(got["m.loss"], ref["loss"], **rel)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(got["m." + k], ref["aux"][k],
                                   err_msg=k, **rel)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(got["m." + k], ref["metrics"][k],
                                   err_msg=k, **rel)
    ref_grads = _port_names(cfg, ref["grads"])
    ref_new = _port_names(cfg, ref["new_params"])
    names = [k[len("grad."):] for k in got if k.startswith("grad.")]
    assert set(names) == set(ref_grads)
    for n in names:
        _close(got["m.grad." + n], got["grad." + n], 1e-4, n)
        _close(got["m.grad." + n], ref_grads[n], 1e-4, n)

    def new_params_close(tag, want):
        close = total = 0
        for n in names:
            d = np.abs(got[tag + "m.new." + n] - want[n])
            assert float(d.max()) <= 2 * LR * (1 + 1e-3), (n, d.max())
            close += int((d <= 1e-5).sum())
            total += d.size
        assert close >= 0.999 * total, (tag, close, total)
    new_params_close("", {n: got["new." + n] for n in names})
    new_params_close("", ref_new)
    if cfg.family == "dense":
        np.testing.assert_allclose(got["int8.m.grad_norm"],
                                   got["int8.grad_norm"], **rel)
        new_params_close("int8.", {n: got["int8.new." + n] for n in names})
