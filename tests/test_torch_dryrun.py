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
                "flops": tr.flops, "mem": roofline.memory_stats(tr),
                "coll": roofline.costs_of(tr)["coll_counts"]}

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
                x @ w
            out["route"][name] = [rec.trace.flops, want]
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
    them unsharded over ``model``); attention splits the keys over
    ``model``; the tied unembedding splits the vocab. Train: forward,
    the rematerialised forward (which stops before each layer's last
    product, w_down, whose output the backward does not need — XLA drops
    it alike) and the backward (two products per forward one)."""
    T, B, S, tp = 256, 2, 128, 2
    d, hq, hd, kv, ff, V = 64, 4, 16, 2, 128, 256
    proj = 2 * T * (d * hq * hd // tp + 2 * d * kv * hd
                    + hq * hd // tp * d)
    attn = 2 * (2 * B * hq * S * (S // tp) * hd)
    mlp = 2 * T * 3 * d * ff // tp
    w_down = 2 * T * ff // tp * d
    layer = proj + attn + mlp
    unembed = 2 * T * d * V // tp
    want = 4 * (4 * layer - w_down) + 3 * unembed
    assert small["cells"]["smollm-360m/train"]["flops"] == want


def test_extrapolation_equals_direct_trace(small):
    ext, direct = small["extrapolated"], small["direct"]
    for k in ("flops", "bytes", "coll_raw", "coll_modeled"):
        assert ext[k] == pytest.approx(direct[k], rel=1e-9), k
    assert ext["coll_counts"] == direct["coll_counts"]


@pytest.mark.parametrize("layout", ["row", "col", "replicated"])
def test_dtensor_route_counts_local_shapes(small, layout):
    got, want = small["route"][layout]
    assert got == want
