"""The port's dry run and roofline analysis against the reference, on the
CPU.

* The roofline arithmetic: ``make_roofline`` and ``extrapolate_costs``
  equal the reference's on the same dicts, and the ring model of
  ``collectives_of`` equals the reference's ``parse_collectives`` on
  synthetic HLO lines of each collective kind and group size.
* ``_depth_plan`` covers every architecture as the reference's does.
* The dry run itself, in one subprocess on a fake process group of 8
  ranks (a 4x2 ``data`` x ``model`` mesh; a process opens one group), at
  the reference's small-mesh shapes (``tests/test_dryrun.py``): reduced
  SmolLM, Mixtral and Falcon-Mamba, train and decode, trace with FLOPs
  and memory above zero and FSDP all-gathers in train; reduced SmolLM
  train's per-device matmul FLOPs equal a hand count from the config;
  the depth extrapolation of two shallow traces equals a direct trace at
  depth 4; and the recorder's DTensor route counts a product's FLOPs as
  its local shapes give them, row-sharded, column-sharded and
  replicated.
"""
from __future__ import annotations

import functools
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import pytest

import jax

from repro.configs import get_config as r_config
from repro.roofline import analysis as RA
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import dryrun as dr
from repro_torch.roofline import analysis as PA

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_dryrun():
    """Import the reference's dry run after JAX has started (its import
    sets XLA_FLAGS for 512 host devices), and put the variable back."""
    jax.devices()
    before = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as rdr
    if before is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = before
    return rdr


RDR = _reference_dryrun()


# ---------------------------------------------------------------------- #
#  Roofline arithmetic
# ---------------------------------------------------------------------- #
C1 = {"flops": 3.5e12, "bytes": 1.25e11, "coll_raw": 4.0e9,
      "coll_modeled": 6.5e9, "coll_counts": {"all-gather": 7,
                                             "all-reduce": 12}}
C2 = {"flops": 5.0e12, "bytes": 1.75e11, "coll_raw": 6.5e9,
      "coll_modeled": 9.0e9, "coll_counts": {"all-gather": 11,
                                             "all-reduce": 20,
                                             "reduce-scatter": 4}}


@pytest.mark.parametrize("l1,l2,n", [(1, 2, 32), (2, 3, 60), (6, 12, 81)])
def test_extrapolate_costs_equals_reference(l1, l2, n):
    assert PA.extrapolate_costs(C1, C2, l1, l2, n) == \
        RA.extrapolate_costs(C1, C2, l1, l2, n)


def test_make_roofline_equals_reference():
    mem = {"argument_bytes": 1, "output_bytes": 2, "temp_bytes": 3,
           "alias_bytes": 1, "total_bytes": 5}
    for c in (C1, C2, dict(C1, flops=0.0)):
        got = PA.make_roofline(c["flops"], c["bytes"], c["coll_raw"],
                               c["coll_modeled"], c["coll_counts"], mem,
                               1e12).to_dict()
        want = RA.make_roofline(c["flops"], c["bytes"], c["coll_raw"],
                                c["coll_modeled"], c["coll_counts"], mem,
                                1e12).to_dict()
        assert got == want
    assert (PA.PEAK_FLOPS, PA.HBM_BW, PA.LINK_BW) == \
        (RA.PEAK_FLOPS, RA.HBM_BW, RA.LINK_BW)


_HLO_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
              "collective-permute")


@pytest.mark.parametrize("kind", _HLO_KINDS)
def test_ring_model_equals_reference_parse(kind):
    """One synthetic HLO line per (dtype, shape, group size): the port's
    records (result bytes, group size) give the reference's numbers."""
    lines, records = [], []
    for dt, nbytes in (("bf16", 2), ("f32", 4)):
        for dims in ((1024, 512), (7, 3, 5)):
            for n in (2, 16, 32):
                shape = ",".join(map(str, dims))
                lines.append(
                    f"  %x = {dt}[{shape}]{{1,0}} {kind}(%y), "
                    f"replica_groups=[{512 // n},{n}]<=[512]")
                size = nbytes
                for d in dims:
                    size *= d
                records.append((kind, float(size), n))
    want = RA.parse_collectives("\n".join(lines))
    got = PA.collectives_of(records)
    assert got.counts == want.counts
    assert got.raw_bytes == want.raw_bytes
    assert got.modeled_bytes == pytest.approx(want.modeled_bytes, rel=1e-12)
    assert got.by_kind == pytest.approx(want.by_kind, rel=1e-12)


def test_depth_plan_covers_all_archs_as_reference():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        l1, l2, n_units, mk = dr._depth_plan(cfg)
        r1, r2, r_units, _ = RDR._depth_plan(r_config(arch))
        assert (l1, l2, n_units) == (r1, r2, r_units)
        assert l2 > l1 >= 1 and n_units > 0
        c1 = mk(l1)
        assert c1.n_layers == l1 and not c1.scan_layers


# ---------------------------------------------------------------------- #
#  The dry run on a fake 4x2 mesh (one subprocess)
# ---------------------------------------------------------------------- #
SCRIPT = textwrap.dedent("""
    import dataclasses as dc, json, sys
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec, reduce_for_smoke
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import init_fake_world, make_mesh
    from repro_torch.roofline import analysis as roofline

    init_fake_world(8)
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    out = {"cells": {}}
    shapes = (ShapeSpec("t", 128, 8, "train"), ShapeSpec("d", 256, 8,
                                                          "decode"))
    for arch in ("smollm-360m", "mixtral-8x22b", "falcon-mamba-7b"):
        cfg = dc.replace(reduce_for_smoke(get_config(arch)),
                         param_dtype="bfloat16", remat="full")
        for shape in shapes:
            tr = dr._compile(cfg, shape, mesh, 1, device="cpu")
            out["cells"][f"{arch}/{shape.mode}"] = {
                "flops": tr.flops, "matmul_flops": tr.matmul_flops,
                "mem": roofline.memory_stats(tr),
                "coll": roofline.costs_of(tr)["coll_counts"],
                "records": [list(r) for r in tr.collectives]}

    # extrapolation from depths 1 and 2 against a trace at depth 4
    cfg = dc.replace(reduce_for_smoke(get_config("smollm-360m")),
                     param_dtype="bfloat16", remat="full")
    l1, l2, n, mk = dr._depth_plan(cfg)
    c1, c2, c4 = (roofline.costs_of(dr._compile(mk(d), shapes[0], mesh, 1,
                                                device="cpu"))
                  for d in (l1, l2, n))
    out["extrapolated"] = roofline.extrapolate_costs(c1, c2, l1, l2, n)
    out["direct"] = c4

    # the DTensor counting route against local-shape counts
    M, K, N = 64, 32, 48
    layouts = {
        "row": ([Shard(0), Shard(1)], [Replicate(), Shard(0)],
                2 * (M // 4) * (K // 2) * N),
        "col": ([Shard(0), Replicate()], [Replicate(), Shard(1)],
                2 * (M // 4) * K * (N // 2)),
        "replicated": ([Replicate(), Replicate()],
                       [Replicate(), Replicate()], 2 * M * K * N)}
    out["route"] = {}
    with FakeTensorMode():
        for name, (px, pw, want) in layouts.items():
            x = distribute_tensor(torch.empty(M, K), mesh, px)
            w = distribute_tensor(torch.empty(K, N), mesh, pw)
            with roofline.Recorder((x, w)) as rec:
                rec.outputs(x @ w)
            out["route"][name] = [rec.trace.flops, want]

    # AdamW on a replicated parameter whose gradient is a partial sum
    # over both mesh axes: the gradient is all-reduced once
    from torch.distributed.tensor import DTensor, Partial
    from repro_torch.optim import adamw
    with FakeTensorMode():
        p = torch.nn.Parameter(distribute_tensor(
            torch.empty(64, 32), mesh, [Replicate(), Replicate()]))
        g = DTensor.from_local(torch.empty(64, 32), mesh,
                               [Partial(), Partial()], run_check=False)
        ocfg = adamw.AdamWConfig()
        with torch.utils._python_dispatch._disable_current_modes():
            meta = adamw.init({"w": torch.empty(64, 32, device="meta")},
                              ocfg)
        state = type(meta)(*(
            distribute_tensor(torch.empty(t.shape, dtype=t.dtype), mesh,
                              [Replicate(), Replicate()])
            if isinstance(t, torch.Tensor) else
            {k: distribute_tensor(torch.empty(v.shape, dtype=v.dtype),
                                  mesh, [Replicate(), Replicate()])
             for k, v in t.items()} for t in meta))
        with roofline.Recorder(({"w": p}, g, state)) as rec:
            adamw.update({"w": p}, {"w": g}, state, ocfg)
    out["adamw"] = [list(r) for r in rec.trace.collectives]

    json.dump(out, open(sys.argv[1], "w"))
    print("DRYRUN_OK")
""")


@functools.lru_cache(maxsize=1)
def _results(tmp):
    path = os.path.join(tmp, "dryrun.json")
    script = os.path.join(tmp, "dryrun_small.py")
    with open(script, "w") as f:
        f.write(SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, script, path], capture_output=True,
                       text=True, cwd=ROOT, env=env, timeout=900)
    assert r.returncode == 0, r.stderr[-4000:]
    assert "DRYRUN_OK" in r.stdout
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    return _results(str(tmp_path_factory.mktemp("dryrun")))


@pytest.mark.parametrize("cell", [
    f"{a}/{m}" for a in ("smollm-360m", "mixtral-8x22b", "falcon-mamba-7b")
    for m in ("train", "decode")])
def test_small_mesh_cells_trace(small, cell):
    c = small["cells"][cell]
    assert c["flops"] > 0
    assert c["mem"]["total_bytes"] > 0
    assert c["mem"]["argument_bytes"] > 0
    if cell.endswith("train"):
        # FSDP: the weights' data shards are gathered, their grads
        # reduce-scattered
        assert c["coll"].get("all-gather", 0) > 0
        assert c["coll"].get("reduce-scatter", 0) > 0
        assert c["mem"]["alias_bytes"] > 0


def test_smollm_train_flops_equal_hand_count(small):
    """Reduced SmolLM (d 64, 4 heads of 16, 2 kv heads, d_ff 128, vocab
    256 tied, 4 layers), batch 8 x 128 on data 4 x model 2: each device
    runs 256 tokens. Column-parallel wq and the MLP's up/gate split their
    output over ``model``, row-parallel wo and w_down their input; wk/wv
    stay whole (2 kv heads do not divide 16: the reference's spec leaves
    them unsharded over ``model``), and each ``model`` rank projects the
    key rows it attends over only; attention splits the keys over
    ``model``; the tied unembedding splits the vocab. Train: forward,
    the rematerialised forward (which stops before each layer's last
    product, w_down, whose output the backward does not need — XLA drops
    it alike) and the backward (two products per forward one)."""
    T, B, S, tp = 256, 2, 128, 2
    d, hq, hd, kv, ff, V = 64, 4, 16, 2, 128, 256
    proj = 2 * T * (d * hq * hd // tp + 2 * d * kv * hd // tp
                    + hq * hd // tp * d)
    attn = 2 * (2 * B * hq * S * (S // tp) * hd)
    mlp = 2 * T * 3 * d * ff // tp
    w_down = 2 * T * ff // tp * d
    layer = proj + attn + mlp
    unembed = 2 * T * d * V // tp
    want = 4 * (4 * layer - w_down) + 3 * unembed
    cell = small["cells"]["smollm-360m/train"]
    assert cell["matmul_flops"] == want
    assert cell["flops"] > want          # the elementwise work on top


def test_extrapolation_equals_direct_trace(small):
    ext, direct = small["extrapolated"], small["direct"]
    for k in ("flops", "bytes", "coll_raw", "coll_modeled"):
        assert ext[k] == pytest.approx(direct[k], rel=1e-9), k
    assert ext["coll_counts"] == direct["coll_counts"]


@pytest.mark.parametrize("layout", ["row", "col", "replicated"])
def test_dtensor_route_counts_local_shapes(small, layout):
    got, want = small["route"][layout]
    assert got == want


def test_mamba_split_moves_halves_not_the_whole_projection(small):
    """Mamba-1's ``in_proj`` output is split over ``model`` into x and z.
    The port once sliced the DTensor, and DTensor gathered the whole
    projection over ``model`` for each slice (Falcon-Mamba train's
    collective bytes were 1.96x the reference's). Now one all-to-all over
    ``model`` a pass moves what changes rank, as the reference's
    partitioner does, and nothing is gathered over ``model``."""
    recs = small["cells"]["falcon-mamba-7b/train"]["records"]
    model = [r for r in recs if r[2] == 2]
    assert not [r for r in model if r[0] == "all-gather"]
    # 4 layers: forward, rematerialised forward, backward
    assert sum(r[0] == "all-to-all" for r in model) == 4 * 3


def test_adamw_reduces_a_partial_gradient_once(small):
    """A replicated parameter's gradient, a partial sum over both axes,
    is all-reduced once before the update (it was reduced again at each
    use: the moments, the square, the step and each state write)."""
    kinds = [r[0] for r in small["adamw"]]
    assert kinds == ["all-reduce", "all-reduce"]      # one per mesh axis


# ---------------------------------------------------------------------- #
#  The depth-extrapolated costs against the reference's, six cells
# ---------------------------------------------------------------------- #
def _compare_script():
    spec = importlib.util.spec_from_file_location(
        "_dryrun_small_vs_reference",
        os.path.join(ROOT, "scripts", "dryrun_small_vs_reference.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=1)
def _comparison():
    return _compare_script().compare()


SIX = [f"{a} {m}" for a in ("smollm-360m", "mixtral-8x22b",
                            "falcon-mamba-7b") for m in ("train", "decode")]


@pytest.mark.parametrize("cell", SIX)
def test_small_mesh_dominant_term_equals_reference(cell):
    c = _comparison()[cell]
    assert c["port"]["dominant"] == c["reference"]["dominant"]


# Falcon-Mamba train is held to the reference run with the port's scan
# stand-in: XLA's count of the reference's scan (its while body once, its
# stacked operands read and results written whole by each dynamic slice
# and update) is not the recurrence's cost, and the port has no loop to
# count (PERF.md section 7)
BYTES_CELLS = [c for c in SIX if c != "falcon-mamba-7b train"] + [
    "falcon-mamba-7b train stand-in"]


@pytest.mark.parametrize("cell", BYTES_CELLS)
def test_small_mesh_bytes_within_reference(cell):
    assert 0.67 <= _comparison()[cell]["ratio"]["bytes"] <= 1.5


def test_mamba_train_bytes_gap_is_the_scan_loop():
    """Without the scan's loop the reference counts 20-40 % fewer bytes;
    the port lies on the stand-in side of that gap."""
    real = _comparison()["falcon-mamba-7b train"]
    fake = _comparison()["falcon-mamba-7b train stand-in"]
    assert fake["reference"]["bytes"] < 0.8 * real["reference"]["bytes"]
    assert real["ratio"]["bytes"] < fake["ratio"]["bytes"]


@pytest.mark.parametrize("cell", SIX + ["falcon-mamba-7b train stand-in"])
def test_small_mesh_flops_within_reference(cell):
    """FLOPs less casts within x1.25 on every cell; the train cells'
    FLOPs with casts too. In decode most of the reference's FLOPs are
    converts: XLA on the CPU casts a stacked parameter or cache whole
    each time a layer uses its slice (PERF.md section 7)."""
    q = _comparison()[cell]["ratio"]
    assert 0.8 <= q["net"] <= 1.25
    if "train" in cell:
        assert 0.8 <= q["flops"] <= 1.25


@pytest.mark.parametrize("cell", SIX)
def test_small_mesh_collectives_within_reference(cell):
    """Collective bytes near the reference's: Falcon-Mamba train's (1.96x
    before its port fault was repaired) within x1.1; the others within
    [0.65, 1.25], where the two partitioners choose different
    collectives for the same specs (PERF.md section 7): Mixtral decode
    moves its experts' weights over ``data`` in bf16 as the reference's
    source writes it, where XLA casts them to f32 first (2x the bytes);
    the train cells reduce-scatter FSDP gradients where XLA all-reduces
    them, and gather the input's gradient over ``model`` where the K/V
    projections ran on key shards."""
    q = _comparison()[cell]["ratio"]["coll"]
    if cell == "falcon-mamba-7b train":
        assert 1 / 1.1 <= q <= 1.1
    else:
        assert 0.65 <= q <= 1.25


# ---------------------------------------------------------------------- #
#  Calibration: one op class at a time against XLA's cost analysis (CPU)
# ---------------------------------------------------------------------- #
_JD = {"f32": "float32", "bf16": "bfloat16", "i32": "int32", "bool": "bool"}
_X, _XB = ((1024, 1024), "f32"), ((1024, 1024), "bf16")
_W = ((1024,), "f32")


def _probes():
    import jax.numpy as jnp
    import torch
    import torch.nn.functional as F
    rms = (lambda x, w: x * jax.lax.rsqrt(
        (x * x).mean(-1, keepdims=True) + 1e-6) * w,
        lambda x, w: x * torch.rsqrt(
            (x * x).mean(-1, keepdim=True) + 1e-6) * w)
    # name: (jax fn, torch fn, inputs, bytes tolerance, flops tolerance)
    return {
        "mul": (lambda x: x * 2, lambda x: x * 2, [_X], 0, 0),
        "add": (lambda x, y: x + y, lambda x, y: x + y, [_X, _X], 0, 0),
        "fused_chain_exp": (lambda x: jnp.exp(x * 2 + 1),
                            lambda x: torch.exp(x * 2 + 1), [_X], 0, 0),
        "where": (lambda c, x, y: jnp.where(c, x, y), torch.where,
                  [((1024, 1024), "bool"), _X, _X], 0, 0),
        "compare": (lambda x, y: x > y, lambda x, y: x > y, [_X, _X], 0, 0),
        "cast": (lambda x: x.astype(jnp.bfloat16),
                 lambda x: x.to(torch.bfloat16), [_X], 0, 0),
        "bf16_cast_chain": (
            lambda x: (x.astype(jnp.float32) * 2).astype(jnp.bfloat16),
            lambda x: (x.float() * 2).to(torch.bfloat16), [_XB], 0, 0),
        "rsqrt": (jax.lax.rsqrt, torch.rsqrt, [_X], 0, 0),
        "tanh": (jnp.tanh, torch.tanh, [_X], 0, 0),
        "sigmoid": (jax.nn.sigmoid, torch.sigmoid, [_X], 0, 0),
        "silu": (jax.nn.silu, F.silu, [_X], 0, 0),
        "softplus": (jax.nn.softplus, F.softplus, [_X], 0, 0),
        "integer_power": (lambda x: x ** 2, lambda x: x ** 2, [_X], 0, 0),
        "broadcast": (lambda x, w: x * w[None, :],
                      lambda x, w: x * w[None, :], [_X, _W], 0, 0),
        "transpose": (lambda x: (x * 2).T + 1, lambda x: (x * 2).T + 1,
                      [_X], 0, 0),
        "slices": (lambda x: x[:, :512] * x[:, 512:],
                   lambda x: x[:, :512] * x[:, 512:], [_X], 0, 0),
        # XLA's row reductions also write and read a partial-sum buffer
        # of 1/16 of the input; one FLOP an input element (XLA: n - 1)
        "row_sum": (lambda x: x.sum(-1), lambda x: x.sum(-1), [_X],
                    0.06, 1e-3),
        "row_max": (lambda x: x.max(-1), lambda x: x.amax(-1), [_X],
                    0.06, 1e-3),
        "reduce_unfused": (lambda x: (x * x).sum(-1),
                           lambda x: (x * x).sum(-1), [_X], 0.03, 1e-3),
        "softmax": (lambda x: jax.nn.softmax(x, -1),
                    lambda x: torch.softmax(x, -1), [_X], 0.03, 1e-3),
        "log_softmax": (lambda x: jax.nn.log_softmax(x, -1),
                        lambda x: torch.log_softmax(x, -1), [_X], 0.03,
                        1e-3),
        "rmsnorm": (*rms, [_X, _W], 0.03, 0),
        "product_f32": (lambda a, b: a @ b, lambda a, b: a @ b, [_X, _X],
                        0, 0),
        "product_bf16": (lambda a, b: a @ b, lambda a, b: a @ b,
                         [_XB, _XB], 0, 0),
        "product_bf16_into_f32": (
            lambda a, b: jnp.matmul(a, b,
                                    preferred_element_type=jnp.float32),
            lambda a, b: torch.mm(a, b, out_dtype=torch.float32),
            [_XB, _XB], 0, 0),
        # XLA fuses a*2 into the operand's cast and counts one convert
        # fewer than the recorder's cast of a then a*2 (1e-3)
        "bf16_ew_into_product": (lambda a, b: (a * 2) @ b,
                                 lambda a, b: (a * 2) @ b, [_XB, _XB], 0,
                                 1e-3),
        "product_into_bf16_ew": (lambda a, b: (a @ b) * 2,
                                 lambda a, b: (a @ b) * 2, [_XB, _XB], 0,
                                 1e-3),
        "ew_product_ew": (lambda a, b: jnp.exp((a * 2) @ b + 1),
                          lambda a, b: torch.exp((a * 2) @ b + 1),
                          [_X, _X], 0, 0),
        "take": (lambda x, i: x[i], lambda x, i: x[i],
                 [_X, ((512,), "i32")], 1e-3, None),
        "concat": (lambda x, y: jnp.concatenate([x, y], -1),
                   lambda x, y: torch.cat([x, y], -1), [_X, _X], 0, 0),
        "cache_write": (lambda x, y: jax.lax.dynamic_update_slice(
            x, y, (0, 0)), _write_rows, [_X, ((16, 1024), "f32")], 1e-5,
            0),
    }


def _write_rows(x, y):
    x[:16] = y
    return x


def _xla_costs(fn, inputs):
    import jax.numpy as jnp
    args = [jax.ShapeDtypeStruct(s, getattr(jnp, _JD[d]))
            for s, d in inputs]
    c = RA.cost_analysis(jax.jit(fn).lower(*args).compile())
    return [float(c.get(k) or 0.0) for k in ("flops", "bytes accessed",
                                             "transcendentals")]


def _recorded_costs(fn, inputs):
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    dt = {"f32": torch.float32, "bf16": torch.bfloat16, "i32": torch.int64,
          "bool": torch.bool}
    with FakeTensorMode():
        args = [torch.empty(s, dtype=dt[d]) for s, d in inputs]
        with PA.Recorder(args) as rec:
            rec.outputs(fn(*args))
    c = PA.cost_analysis(rec.trace)
    return [c["flops"], c["bytes accessed"], c["transcendentals"]]


@pytest.mark.parametrize("name", sorted(_probes()))
def test_recorder_counts_as_xla_cost_analysis(name):
    jfn, tfn, inputs, btol, ftol = _probes()[name]
    want = _xla_costs(jfn, inputs)
    got = _recorded_costs(tfn, inputs)
    assert got[1] == pytest.approx(want[1], rel=btol, abs=0), "bytes"
    if ftol is not None:
        assert got[0] == pytest.approx(want[0], rel=ftol, abs=0), "flops"
    assert got[2] == want[2], "transcendentals"


def test_shared_cheap_producer_is_written_once():
    """The one probe the recorder does not follow: XLA copies a cheap
    producer with two consumers into both fusions (x read twice, 1.68e7
    bytes); the recorder writes it once and reads it twice (2.52e7)."""
    f = lambda x: (lambda y: (y + 1, y * 3))(x * 2 + 1)    # noqa: E731
    want = _xla_costs(f, [_X])
    got = _recorded_costs(f, [_X])
    assert want[1] == pytest.approx(4 * 4 * 2 ** 20, abs=64)
    assert got[1] == 6 * 4 * 2 ** 20
