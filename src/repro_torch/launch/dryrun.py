"""Multi-pod dry run: trace every (architecture x input-shape) cell on the
production meshes, report memory and costs per device, and the roofline
terms.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2.5-14b \\
      --shape train_4k [--multi-pod] [--device cpu] [--out out.json]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The port of the reference's ``repro/launch/dryrun.py``. Where the
reference AOT-compiles each cell for 256 or 512 TPU devices, this runs the
step once on a fake process group of that many ranks
(:func:`repro_torch.launch.mesh.init_fake_world`): parameters, optimizer
state, batch and cache are fake tensors (``FakeTensorMode``: shapes and
dtypes, no memory) laid out as DTensors by the sanitized spec trees (an
axis that does not divide an argument's dim is dropped, as the
reference drops it; the activations' constraints keep it and split
unevenly, :func:`repro_torch.models.common.split_spec`), and a
:class:`~repro_torch.roofline.analysis.Recorder` counts what this rank
(rank 0) computes, moves and holds. Train runs forward, backward and the
AdamW update; prefill and decode run ``train/serve.py``'s steps. The
recorder counts FLOPs and bytes as XLA's cost analysis does on the CPU
backend the reference compiles for (elementwise FLOPs, fused bytes;
:mod:`repro_torch.roofline.analysis`), so the roofline terms and the
dominant one read as the reference's. The model
runs its differentiable ``impl="xla"`` route: the hand kernels are
CUDA-only and forward-only, and the reference's dry run lowers the same
plain path. A prompt's Mamba recurrence runs as a stand-in of its shapes
(:func:`repro_torch.models.ssm.scan_stand_in`: a step loop would take
minutes a layer to trace), its modelled cost added as the reference
adds it; the SSM cells' memory figures are the stand-in's. A failure
here (a sharding the model cannot run, a dim that does not divide) is a
bug in the distribution config.

Costs come from two shallow traces extrapolated linearly in depth
(:func:`_depth_plan`), as the reference's; eager tracing counts every
layer exactly, so the extrapolation equals a trace at full depth, except
hybrid's shared attention block (13.5 applications counted for 13, the
reference's documented overcount). Memory comes from the trace at full
depth. ``--device`` (default ``cuda``) places the fake tensors and the
mesh; the counts do not depend on it. One process opens one process group,
so a process traces the cells of one mesh.
"""
from __future__ import annotations

import argparse
import dataclasses as dc
import json
import math
import os
import time
import traceback

import torch
from torch import nn

from ..configs import ARCH_ALIASES, get_config
from ..configs.base import SHAPES, ShapeSpec, shape_applicable
from ..device import resolve_device
from ..models import model as model_lib
from ..models import ssm
from ..models.common import (P, batch_spec, dtype_of, local_shape,
                             map_specs, mesh_axes, placements, podify,
                             sanitize_spec, sharded)
from ..optim import adamw
from ..roofline import analysis as roofline
from ..train.serve import make_prefill_step, make_serve_step
from ..train.step import make_train_step
from .mesh import (init_fake_world, make_production_mesh, production_shape,
                   set_mesh)

__all__ = ["ShapeDtype", "batch_specs", "input_specs", "named", "podify",
           "podify_fsdp", "run_cell", "sanitize_spec", "main"]


# ---------------------------------------------------------------------- #
#  Sharding utilities
# ---------------------------------------------------------------------- #
def named(mesh, spec_tree, shape_tree):
    """spec tree + shape tree → DTensor placements tree (sanitized).
    ``shape_tree`` holds shapes (or anything with ``.shape``)."""
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v, shape_tree[k]) for k, v in
                spec_tree.items()}
    if isinstance(spec_tree, tuple) and hasattr(spec_tree, "_fields") \
            and not isinstance(spec_tree, P):
        return type(spec_tree)(*(named(mesh, s, getattr(shape_tree, f))
                                 for s, f in zip(spec_tree,
                                                 spec_tree._fields)))
    shape = getattr(shape_tree, "shape", shape_tree)
    return placements(mesh, sanitize_spec(spec_tree, shape, mesh))


def podify_fsdp(spec_tree):
    """ZeRO-3 over the slow links: extend every FSDP ('data') entry in the
    param/opt specs to ('data','pod') — used when ``cfg.fsdp_over_pod``
    (Kimi-K2: 1T params cannot fit 2 pods with pod-replicated state).
    DTensor shards a dim over its mesh dims in mesh order, so this runs as
    ('pod','data'): the same local shapes and collective bytes."""
    def one(s):
        out = []
        for entry in s:
            if entry == "data":
                out.append(("data", "pod"))
            elif isinstance(entry, tuple) and "data" in entry and \
                    "pod" not in entry:
                out.append(tuple(entry) + ("pod",))
            else:
                out.append(entry)
        return P(*out)
    return map_specs(one, spec_tree)


# ---------------------------------------------------------------------- #
#  input_specs: shape/dtype stand-ins for every model input
# ---------------------------------------------------------------------- #
@dc.dataclass(frozen=True)
class ShapeDtype:
    shape: tuple
    dtype: torch.dtype


def input_specs(cfg, shape: ShapeSpec) -> dict:
    """Shape/dtype stand-ins for the *data* inputs of the traced step."""
    B, S = shape.global_batch, shape.seq_len
    act = dtype_of(cfg.activation_dtype)
    i32 = torch.int32
    if shape.mode in ("train", "prefill"):
        S_text = model_lib.text_len(cfg, S)
        d = {"tokens": ShapeDtype((B, S_text), i32)}
        if shape.mode == "train":
            d["labels"] = ShapeDtype((B, S_text), i32)
        if cfg.family == "vlm":
            d["vision_embeds"] = ShapeDtype((B, cfg.vision_tokens,
                                             cfg.d_model), act)
        if cfg.family == "audio":
            d["frames"] = ShapeDtype((B, cfg.encoder_seq, cfg.d_model), act)
        return d
    # decode: one new token against a seq_len KV cache
    return {"tokens": ShapeDtype((B, 1), i32), "pos": ShapeDtype((), i32)}


def batch_specs(cfg, shape: ShapeSpec) -> dict:
    dp = batch_spec()
    if shape.mode in ("train", "prefill"):
        d = {"tokens": P(dp, None)}
        if shape.mode == "train":
            d["labels"] = P(dp, None)
        if cfg.family == "vlm":
            d["vision_embeds"] = P(dp, None, None)
        if cfg.family == "audio":
            d["frames"] = P(dp, None, None)
        return d
    return {"tokens": P(dp, None), "pos": P()}


# ---------------------------------------------------------------------- #
def _depth_plan(cfg):
    """(l1, l2, n_units, make) for linear-in-depth cost extrapolation:
    traces at depths l1 < l2 give the per-layer cost. hybrid traces at
    whole-period depths, but the slope is PER LAYER and n_units is the
    layer count (the shared attention block rides along at 1/period per
    layer: 81/6 = 13.5 vs 13 true applications, ≈3.8% overcount of that
    block, as the reference documents); audio scales encoder and decoder
    together."""
    if cfg.family == "hybrid":
        p = cfg.hybrid_attn_period
        return (p, 2 * p, cfg.n_layers,
                lambda n: dc.replace(cfg, n_layers=n, scan_layers=False))
    if cfg.family == "audio":
        return (1, 2, cfg.n_layers,
                lambda n: dc.replace(cfg, n_layers=n, n_encoder_layers=n,
                                     scan_layers=False))
    if cfg.family == "moe" and cfg.first_dense_layers:
        d = cfg.first_dense_layers
        return (d + 1, d + 2, cfg.n_layers - d,
                lambda n: dc.replace(cfg, n_layers=n, scan_layers=False))
    return (1, 2, cfg.n_layers,
            lambda n: dc.replace(cfg, n_layers=n, scan_layers=False))


# ---------------------------------------------------------------------- #
#  The traced step
# ---------------------------------------------------------------------- #
def _fake(shape, dtype, mesh, spec, device, requires_grad=False):
    """A DTensor of global ``shape`` laid out by ``spec`` (sanitized) whose
    local shard is a fake tensor (call under ``FakeTensorMode``)."""
    spec = sanitize_spec(spec, tuple(shape), mesh)
    t = sharded(torch.empty(local_shape(shape, spec, mesh), dtype=dtype,
                            device=device), shape, mesh, spec)
    return nn.Parameter(t, requires_grad=True) if requires_grad else t


def _like(tree, spec_tree, mesh, device):
    """Fake DTensors shaped as the (meta) tensors of ``tree``."""
    if isinstance(tree, dict):
        return {k: _like(v, spec_tree[k], mesh, device)
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        specs = (spec_tree if isinstance(spec_tree, tuple) and not
                 isinstance(spec_tree, P) else (spec_tree,) * len(tree))
        return type(tree)(*(_like(v, s, mesh, device)
                            for v, s in zip(tree, specs)))
    return _fake(tree.shape, tree.dtype, mesh, spec_tree, device)


def _params(cfg, mesh, device, trainable: bool):
    """The model's module with every parameter a fake DTensor."""
    mod = model_lib._family_module(cfg).LM(cfg, device)
    specs = model_lib.param_specs(cfg)
    if cfg.fsdp_over_pod and "pod" in mesh_axes(mesh):
        specs = podify_fsdp(specs)
    by_name = model_lib.named_specs(specs, mod)
    for mname, m in mod.named_modules():
        for pname, p in list(m._parameters.items()):
            if p is None:
                continue
            full = f"{mname}.{pname}" if mname else pname
            m._parameters[pname] = _fake(p.shape, p.dtype, mesh,
                                         by_name[full], device, trainable)
    return mod, by_name


def _build(cfg, shape, mesh, microbatches, device):
    """(step, args, alias tree): the step to trace on fake DTensors, its
    arguments, and what the reference donates to its outputs (params and
    optimizer state in train, the cache in decode)."""
    train = shape.mode == "train"
    params, p_specs = _params(cfg, mesh, device, trainable=train)
    data = input_specs(cfg, shape)
    b_specs = batch_specs(cfg, shape)
    if train:
        ocfg = adamw.AdamWConfig(state_dtype=cfg.opt_state_dtype)
        meta = {n: torch.empty(p.shape, device="meta")
                for n, p in params.named_parameters()}
        with torch.utils._python_dispatch._disable_current_modes():
            opt_meta = adamw.init(meta, ocfg)
        o_specs = adamw.state_specs(p_specs, {n: t.shape for n, t in
                                              meta.items()}, ocfg)
        opt = _like(opt_meta, o_specs, mesh, device)
        batch = {k: _fake(v.shape, v.dtype, mesh, b_specs[k], device)
                 for k, v in data.items()}
        step = make_train_step(cfg, ocfg, microbatches=microbatches,
                               device=device)
        return step, (params, opt, batch), (params, opt)
    if shape.mode == "decode":
        with torch.utils._python_dispatch._disable_current_modes():
            meta = model_lib._family_module(cfg).init_cache(
                cfg, shape.global_batch, shape.seq_len, torch.bfloat16,
                "meta")
        cache = _like(meta, podify(model_lib.cache_specs(cfg)), mesh,
                      device)
        tokens = _fake(data["tokens"].shape, data["tokens"].dtype, mesh,
                       b_specs["tokens"], device)
        serve = make_serve_step(cfg, device=device)
        return (serve, (params, cache, tokens, shape.seq_len - 1),
                (cache,))
    prefill = make_prefill_step(cfg, max_seq=shape.seq_len, device=device,
                                impl="xla")
    batch = {k: _fake(v.shape, v.dtype, mesh, b_specs[k], device)
             for k, v in data.items()}
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    return prefill, (params, batch["tokens"], extra), ()


def _trace(cfg, shape, mesh, microbatches, device) -> roofline.Trace:
    """Trace one step of ``cfg`` at ``shape`` on ``mesh``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    with FakeTensorMode(allow_non_fake_inputs=True), \
            implicit_replication(), set_mesh(mesh), ssm.scan_stand_in():
        step, args, alias = _build(cfg, shape, mesh, microbatches, device)
        argument_bytes = roofline.local_bytes(args)
        with roofline.Recorder(args) as rec:
            out = step(*args)
            rec.outputs(out)
        trace = rec.trace
        trace.argument_bytes = argument_bytes
        trace.output_bytes = roofline.local_bytes(out)
        trace.alias_bytes = roofline.local_bytes(alias)
    return trace


def _compile(cfg, shape, mesh, microbatches, device="cuda"):
    """The counterpart of the reference's ``_compile``: the step's trace
    (a :class:`~repro_torch.roofline.analysis.Trace`)."""
    return _trace(cfg, shape, mesh, microbatches, resolve_device(device))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             microbatches: int = 1, remat: str = None,
             opt_override: str = None, verbose: bool = True,
             analyze_costs: bool = True, cfg_override=None,
             device="cuda", mesh=None) -> dict:
    """One (arch, shape) cell on the production mesh (``mesh``: one made
    already on this process's fake world, else one is made)."""
    cfg = cfg_override or get_config(arch)
    if remat is not None:
        cfg = dc.replace(cfg, remat=remat)
    if opt_override is not None:
        cfg = dc.replace(cfg, opt_state_dtype=opt_override)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": why}

    dev = resolve_device(device)
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=dev.type)
    n_chips = mesh.size()

    # 1) the full-depth trace: launchability + per-device memory
    t0 = time.time()
    full = _trace(cfg, shape, mesh, microbatches, dev)
    t_full = time.time() - t0
    mem = roofline.memory_stats(full)
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips, "status": "ok",
        "compile_s": round(t_full, 1),
        "params_b": cfg.param_count() / 1e9,
        "active_params_b": cfg.active_param_count() / 1e9,
        "microbatches": microbatches,
        "memory_per_device": mem,
        "fits_hbm": mem["total_bytes"] < 16e9,
        "memory_analysis": str(mem),
        "cost_analysis_scanned": {
            k: v for k, v in roofline.cost_analysis(full).items()
            if k in ("flops", "bytes accessed")},
    }
    if verbose:
        print(f"[{arch} / {shape_name} / {result['mesh']}] "
              f"trace={t_full:.0f}s "
              f"mem/dev={mem['total_bytes']/1e9:.2f}GB "
              f"fits={result['fits_hbm']}")
        print(f"  memory_analysis: {result['memory_analysis']}")

    # 2) roofline costs via depth extrapolation
    if analyze_costs:
        l1, l2, n_units, mk = _depth_plan(cfg)
        t1 = time.time()
        c1 = roofline.costs_of(_trace(mk(l1), shape, mesh, 1, dev))
        c2 = roofline.costs_of(_trace(mk(l2), shape, mesh, 1, dev))
        costs = roofline.extrapolate_costs(c1, c2, l1, l2, n_units)
        extra_f, extra_b = roofline.ssm_scan_correction(cfg, shape, n_chips)
        costs["flops"] += extra_f
        costs["bytes"] += extra_b
        mf = roofline.model_flops(cfg, shape, n_chips)
        rl = roofline.make_roofline(
            costs["flops"], costs["bytes"], costs["coll_raw"],
            costs["coll_modeled"], costs["coll_counts"], mem, mf)
        result["roofline"] = rl.to_dict()
        result["coll_by_kind"] = _by_kind(c1, c2, l1, l2, n_units)
        result["analysis_compile_s"] = round(time.time() - t1, 1)
        if verbose:
            print(f"  cost_analysis (depth-extrapolated): "
                  f"flops={rl.flops:.3e} bytes={rl.bytes_accessed:.3e} "
                  f"coll={rl.coll_bytes_modeled:.3e}B")
            print(f"  roofline: compute={rl.compute_s:.4f}s "
                  f"memory={rl.memory_s:.4f}s coll={rl.collective_s:.4f}s "
                  f"→ {rl.dominant}-bound; useful={rl.useful_ratio:.2f}")
            print(f"  collectives: {rl.coll_counts}")
    return result


def _by_kind(c1, c2, l1, l2, n_units) -> dict:
    """Modeled collective bytes by kind, depth-extrapolated."""
    out = {}
    for kind in set(c1["coll_by_kind"]) | set(c2["coll_by_kind"]):
        a = c1["coll_by_kind"].get(kind, 0.0)
        b = c2["coll_by_kind"].get(kind, 0.0)
        slope = (b - a) / (l2 - l1)
        out[kind] = max(a - l1 * slope, 0.0) + n_units * slope
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCH_ALIASES), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default=None)
    ap.add_argument("--opt-dtype", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="where the fake tensors live: cuda (default) or "
                         "cpu; the counts do not depend on it")
    ap.add_argument("--no-analysis", action="store_true",
                    help="the full-depth trace only (launchability and "
                         "memory)")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in sorted(ARCH_ALIASES)
                 for shape in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    dev = resolve_device(args.device)
    init_fake_world(math.prod(production_shape(args.multi_pod)[0]))
    mesh = make_production_mesh(multi_pod=args.multi_pod,
                                device_type=dev.type)
    results = []
    t0 = time.time()
    for arch, shape in cells:
        try:
            r = run_cell(arch, shape, args.multi_pod,
                         microbatches=args.microbatches, remat=args.remat,
                         opt_override=args.opt_dtype,
                         analyze_costs=not args.no_analysis,
                         device=dev, mesh=mesh)
        except Exception as e:
            traceback.print_exc()
            r = {"arch": arch, "shape": shape, "status": "error",
                 "error": f"{type(e).__name__}: {e}"}
        results.append(r)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                        exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = len(results) - n_ok - n_skip
    print(f"wall: {time.time() - t0:.1f}s for {len(cells)} cells")
    print(f"\nDRY-RUN SUMMARY: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
