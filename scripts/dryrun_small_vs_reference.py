#!/usr/bin/env python3
"""The dry run's small-mesh cells in both packages, side by side.

The reference's ``tests/test_dryrun.py`` cells — reduced SmolLM, Mixtral
and Falcon-Mamba (bf16 params, remat "full"), train 8 x 128 and decode 8
against a 256-token cache, on a 4x2 ``data`` x ``model`` mesh — through
each package's own cost path: ``_depth_plan`` picks two shallow depths,
each is compiled (the reference: XLA on 8 host devices) or traced (the
port: fake tensors on a fake 8-rank process group), and
``extrapolate_costs`` carries their costs to the config's depth, plus
``ssm_scan_correction``. That is what ``run_cell`` reports as the
roofline, so both sides count every layer; a scanned compile counts a
scanned body once and is not compared. Each package runs in a process of
its own.

Prints one line a cell: the port / reference ratio of FLOPs, of FLOPs
less casts (the reference's converts counted in its HLO; XLA on the CPU
casts a stacked parameter or cache whole where a layer uses one slice of
it), of bytes and of modeled collective bytes, and both dominant terms
(the v5e data model). A Mamba-1 train cell is printed twice: against the
reference as it is, and against the reference with its prompt's
recurrence replaced by the port's stand-in (``... stand-in``), which
leaves out what XLA counts for the scan's while loop (its body once,
each stacked operand read whole by each dynamic-slice, each stacked
result written whole by each dynamic-update-slice).
``--detail`` adds each side's absolute numbers and, per traced depth,
the collective counts and modeled bytes by kind. ``--by-op`` adds, for
the port, each collective's modeled bytes by the op that moves it: the
forward's last model frames, or in the backward the autograd node and
the forward line that made it (anomaly mode, so slower). ``--route key``
runs the port with every full-sequence attention key-parallel (the
query-parallel route off), to compare the two routes' collectives. ``--memory`` adds the
production (scanned) compile's and the full-depth trace's memory fields:
argument, output, temp and alias bytes.

``--mesh-cells`` runs the cells of ``MESH_CELLS`` in place of the six:
reduced Whisper with 15 encoder frames, Zamba2, and SmolLM with 3 query
heads on 1 KV head (~35 s). ``--production ARCH/SHAPE ...`` runs those
cells at full size on the 16x16 mesh in place of the small ones (256
host devices for the reference, a fake group of 256 ranks for the
port): their depth-extrapolated costs (whisper-large-v3/decode_32k ~7 s,
smollm-360m/train_4k ~10 s, zamba2-7b/train_4k ~60 s), or with
``--memory`` the full-depth compile's and trace's memory fields alone,
both ``fits_hbm`` verdicts (total below 16e9 bytes) and, for the
reference, its two largest converts from the HLO. ``--production all``
takes every cell that applies, 33 (~17 min with ``--memory``, the
port's full-depth traces).

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/dryrun_small_vs_reference.py [--detail] [--memory] [--json out.json]
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/dryrun_small_vs_reference.py --mesh-cells [--detail | --by-op]
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/dryrun_small_vs_reference.py --production whisper-large-v3/train_4k --route key
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/dryrun_small_vs_reference.py --production whisper-large-v3/decode_32k [--detail]
    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/dryrun_small_vs_reference.py --production all --memory --json mem.json
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("smollm-360m", "mixtral-8x22b", "falcon-mamba-7b")
#: the small-mesh cells of the mesh path's repairs, (label, arch,
#: overrides of the reduced config): Whisper with an encoder the 2-way
#: ``model`` axis does not divide, Zamba2's Mamba-2 blocks, and SmolLM
#: with query heads that do not divide it
MESH_CELLS = (("whisper-large-v3 enc15", "whisper-large-v3",
               {"encoder_seq": 15}),
              ("zamba2-7b", "zamba2-7b", {}),
              ("smollm-360m h3", "smollm-360m",
               {"n_heads": 3, "n_kv_heads": 1}))

_HLO_CASTS = """
    import re

    def hlo_casts(text):
        # XLA's FLOPs of its converts: one an element of every convert
        # reached from the entry computation (fusions, while bodies)
        comps, cur = {}, None
        for line in text.splitlines():
            m = re.match(r"^(?:ENTRY )?%(\\S+) .*\\{$", line)
            if m:
                cur = m.group(1)
                comps[cur] = []
            elif line.startswith("}"):
                cur = None
            elif cur:
                comps[cur].append(line)

        def walk(name):
            total = 0
            for line in comps.get(name, []):
                m = re.match(r"\\s*(?:ROOT )?%\\S+ = (\\S+) ([a-z-]+)\\(", line)
                if m and m.group(2) == "convert":
                    dims = re.match(r"[a-z0-9]+\\[([0-9,]*)\\]", m.group(1))
                    n = 1
                    for d in dims.group(1).split(","):
                        n *= int(d) if d else 1
                    total += n
                for key in ("calls", "body"):
                    c = re.search(key + r"=%([A-Za-z0-9_.-]+)", line)
                    if c:
                        total += walk(c.group(1))
            return total
        entry = next(k for k in comps if k.startswith("main"))
        return walk(entry)

    def hlo_big_converts(text, n=2):
        # the n largest converts' results: [bytes, "type[dims]"]
        width = {"f32": 4, "bf16": 2, "f16": 2, "s32": 4, "s8": 1, "u8": 1,
                 "pred": 1}
        out = []
        for line in text.splitlines():
            m = re.match(r"\\s*(?:ROOT )?%\\S+ = (\\w+)\\[([0-9,]*)\\]\\S* "
                         r"convert\\(", line)
            if m:
                size = width.get(m.group(1), 4)
                for d in m.group(2).split(","):
                    size *= int(d) if d else 1
                out.append([size, f"{m.group(1)}[{m.group(2)}]"])
        return sorted(out, reverse=True)[:n]
"""

_COMMON = """
    def cell_costs(dr, roofline, cfg, shape, compile_at, by_kind, casts,
                   memory, n_chips, by_op=None):
        l1, l2, n, mk = dr._depth_plan(cfg)
        depths = {}
        for depth in (l1, l2):
            art = compile_at(mk(depth), shape)
            c = roofline.costs_of(art)
            depths[depth] = dict(counts=c["coll_counts"], by_kind=by_kind(art),
                                 flops=c["flops"], bytes=c["bytes"],
                                 casts=casts(art))
            if by_op is not None:
                depths[depth]["by_op"] = by_op(art)
            if depth == l1:
                c1 = c
            else:
                c2 = c
        costs = roofline.extrapolate_costs(c1, c2, l1, l2, n)
        a, b = depths[l1]["casts"], depths[l2]["casts"]
        slope = (b - a) / (l2 - l1)
        cast = max(a - l1 * slope, 0.0) + n * slope
        extra_f, extra_b = roofline.ssm_scan_correction(cfg, shape, n_chips)
        costs["flops"] += extra_f
        costs["bytes"] += extra_b
        rl = roofline.make_roofline(
            costs["flops"], costs["bytes"], costs["coll_raw"],
            costs["coll_modeled"], costs["coll_counts"], {}, 0.0)
        out = dict(flops=rl.flops, casts=cast, net=rl.flops - cast,
                   bytes=rl.bytes_accessed,
                   coll=rl.coll_bytes_modeled, counts=rl.coll_counts,
                   dominant=rl.dominant,
                   terms=[rl.compute_s, rl.memory_s, rl.collective_s],
                   depths={str(k): v for k, v in depths.items()})
        if memory:
            out["mem"] = roofline.memory_stats(compile_at(cfg, shape))
        return out

    def run(get_config, ShapeSpec, SHAPES, reduce_for_smoke, dr, roofline,
            compile_at, by_kind, casts, n_chips, stand_in=None,
            big_casts=None, by_op=None):
        req = json.loads(sys.argv[1])
        out = {}
        for label, arch, over in req["cells"]:
            cfg = dc.replace(reduce_for_smoke(get_config(arch)),
                             param_dtype="bfloat16", remat="full", **over)
            for shape in (ShapeSpec("t", 128, 8, "train"),
                          ShapeSpec("d", 256, 8, "decode")):
                key = f"{label} {shape.mode}"
                out[key] = cell_costs(dr, roofline, cfg, shape, compile_at,
                                      by_kind, casts, req["memory"], n_chips,
                                      by_op)
                if stand_in is not None and cfg.family == "ssm" and \
                        shape.mode == "train":
                    with stand_in():
                        out[key + " stand-in"] = cell_costs(
                            dr, roofline, cfg, shape, compile_at, by_kind,
                            casts, False, n_chips)
        for arch, name in req["production"]:
            cfg, shape = get_config(arch), SHAPES[name]
            if req["memory"]:     # the full-depth compile or trace alone
                art = compile_at(cfg, shape)
                out[f"{arch} {name}"] = {"mem": roofline.memory_stats(art)}
                if big_casts is not None:
                    out[f"{arch} {name}"]["big_casts"] = big_casts(art)
            else:
                out[f"{arch} {name}"] = cell_costs(
                    dr, roofline, cfg, shape, compile_at, by_kind, casts,
                    False, n_chips, by_op)
        print(json.dumps(out))
"""

REFERENCE = textwrap.dedent("""
    import os
    # as many host devices as the reference's dry run sets on import
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import dataclasses as dc, json, sys
    from repro.configs import get_config
    from repro.configs.base import SHAPES, ShapeSpec, reduce_for_smoke
    from repro.launch import dryrun as dr
    from repro.launch.mesh import make_mesh, make_production_mesh
    from repro.roofline import analysis as roofline
""") + textwrap.dedent(_HLO_CASTS) + textwrap.dedent(_COMMON) + textwrap.dedent("""
    import contextlib
    import jax.numpy as jnp
    import repro.models.ssm as rssm

    @contextlib.contextmanager
    def stand_in():
        # the reference with a prompt's Mamba-1 recurrence replaced by
        # the port's dry-run stand-in (repro_torch.models.ssm.
        # _scan_stand_in): the same model but for the scan's while loop
        scan = rssm.mamba1_scan

        def fake(u, dt, A, Bm, Cm, D, h0=None):
            if h0 is not None or u.shape[1] == 1:
                return scan(u, dt, A, Bm, Cm, D, h0)
            f32 = jnp.float32
            bc = (Bm.astype(f32) * Cm.astype(f32)).sum(-1, keepdims=True)
            y = u.astype(f32) * (dt.astype(f32) * A.mean(-1) + D) + bc
            h = jnp.exp(A)[None] * (u[:, -1, :, None].astype(f32)
                                    * Bm[:, -1, None, :].astype(f32))
            return y, h
        rssm.mamba1_scan = fake
        try:
            yield
        finally:
            rssm.mamba1_scan = scan

    if json.loads(sys.argv[1])["production"]:
        mesh = make_production_mesh()
    else:
        mesh = make_mesh((4, 2), ("data", "model"))
    run(get_config, ShapeSpec, SHAPES, reduce_for_smoke, dr, roofline,
        lambda cfg, shape: dr._compile(cfg, shape, mesh, 1),
        lambda c: roofline.parse_collectives(c.as_text()).by_kind,
        lambda c: hlo_casts(c.as_text()), mesh.size, stand_in,
        lambda c: hlo_big_converts(c.as_text()))
""")

PORT = textwrap.dedent("""
    import dataclasses as dc, json, sys
    from repro_torch.configs import get_config
    from repro_torch.configs.base import SHAPES, ShapeSpec, reduce_for_smoke
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import (init_fake_world, make_mesh,
                                         make_production_mesh)
    from repro_torch.roofline import analysis as roofline
""") + textwrap.dedent(_COMMON) + textwrap.dedent("""
    import re, traceback
    import torch

    def origin():
        # ("fwd", the last model frames) or, in the backward, the autograd
        # node that runs the collective and the forward line that made it
        # (anomaly mode keeps the forward's traceback)
        node = torch._C._current_autograd_node()
        stack, tag = traceback.extract_stack(), "fwd"
        if node is not None:
            tag = "bwd:" + node.name()
            stack = node.metadata.get("traceback_") or []
        if stack and isinstance(stack[0], str):       # formatted frames
            frames = [f"{m[1].split('/')[-1]}:{m[2]}:{m[3]}" for m in (
                re.search(r'File "(.*)", line (\\d+), in (\\S+)', f)
                for f in stack if "repro_torch/models" in f) if m]
        else:
            frames = [f"{f.filename.split('/')[-1]}:{f.lineno}:{f.name}"
                      for f in stack if "repro_torch/models" in f.filename]
        return f"{tag} {' | '.join(frames[-3:])}"

    def tag_collectives():
        # each collective the recorder counts gets its origin
        # (trace.origins, beside trace.collectives); returns the table
        # of a trace: "kind n=group origin" -> [count, modeled bytes]
        dispatch = roofline.Recorder.__torch_dispatch__

        def tagged(self, func, types, args=(), kwargs=None):
            n = len(self.trace.collectives)
            out = dispatch(self, func, types, args, kwargs)
            if len(self.trace.collectives) > n:
                where = origin()
                origins = self.trace.__dict__.setdefault("origins", [])
                origins += [where] * (len(self.trace.collectives) - n)
            return out
        roofline.Recorder.__torch_dispatch__ = tagged
        # its NaN check off: DTensor has no rule for _is_any_true
        torch.autograd.set_detect_anomaly(True, check_nan=False)

        def table(t):
            rows = {}
            for (kind, size, group), where in zip(
                    t.collectives, t.__dict__.get("origins", [])):
                r = rows.setdefault(f"{kind} n={group} {where}", [0, 0.0])
                r[0] += 1
                r[1] += roofline.ring_traffic(kind, size, group)
            return rows
        return table

    req = json.loads(sys.argv[1])
    if req["route"] == "key":
        # every full-sequence attention key-parallel under the mesh
        from repro_torch.models import attention
        attention._queries_split = lambda *a, **k: None
    if req["production"]:
        init_fake_world(256)
        mesh = make_production_mesh(device_type="cpu")
    else:
        init_fake_world(8)
        mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    run(get_config, ShapeSpec, SHAPES, reduce_for_smoke, dr, roofline,
        lambda cfg, shape: dr._compile(cfg, shape, mesh, 1, device="cpu"),
        lambda t: roofline.costs_of(t)["coll_by_kind"],
        lambda t: t.cast_flops, mesh.size(),
        by_op=tag_collectives() if req["by_op"] else None)
""")


def _run(code: str, request: dict) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code, json.dumps(request)],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=1800)
    if r.returncode:
        raise RuntimeError(r.stderr[-4000:])
    return json.loads(r.stdout.strip().splitlines()[-1])


def compare(memory: bool = False, cells=None, production=(),
            by_op: bool = False, route: str = "auto") -> dict:
    """{cell: {"reference": costs, "port": costs, "ratio": {...}}}, the
    two packages run at once. ``cells``: (label, arch, overrides) of the
    small-mesh cells (default the six of ``CELLS``); ``production``:
    (arch, shape name) cells on 16x16 in place of them, their costs, or
    with ``memory`` their full-depth memory fields alone. ``by_op``: the
    port's collectives per traced depth by origin too (``by_op``);
    ``route="key"``: the port with every full-sequence attention
    key-parallel (no query-parallel route)."""
    from concurrent.futures import ThreadPoolExecutor
    if cells is None:
        cells = [] if production else [(a, a, {}) for a in CELLS]
    request = {"cells": [list(c) for c in cells], "memory": memory,
               "production": [list(c) for c in production],
               "by_op": by_op, "route": route}
    with ThreadPoolExecutor(2) as pool:
        ref, port = pool.map(lambda c: _run(c, request), (REFERENCE, PORT))
    out = {}
    for cell in ref:
        r, p = ref[cell], port[cell.replace(" stand-in", "")]
        keys = ("flops", "net", "bytes", "coll") if "flops" in r else ()
        ratio = {k: (p[k] / r[k] if r[k] else float("nan")) for k in keys}
        if "mem" in r:
            for k in ("total_bytes", "temp_bytes"):
                ratio["mem." + k] = (p["mem"][k] / r["mem"][k]
                                     if r["mem"][k] else float("nan"))
        out[cell] = {"reference": r, "port": p, "ratio": ratio}
    return out


def _all_cells():
    """Every (arch, shape) cell of the dry run that applies (``--production
    all``): the seven quadratic-attention archs skip long_500k."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import ARCH_ALIASES, get_config
    from repro_torch.configs.base import SHAPES, shape_applicable
    return [(a, s) for a in sorted(ARCH_ALIASES) for s in SHAPES
            if shape_applicable(get_config(a), SHAPES[s])[0]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--detail", action="store_true",
                    help="absolute numbers and collectives per depth")
    ap.add_argument("--memory", action="store_true",
                    help="the scanned compile's / full trace's memory "
                         "fields too; with --production those alone")
    ap.add_argument("--mesh-cells", action="store_true",
                    help="the cells of MESH_CELLS in place of the six")
    ap.add_argument("--production", nargs="+", default=(),
                    metavar="ARCH/SHAPE",
                    help="these cells on 16x16 in place of the small ones")
    ap.add_argument("--by-op", action="store_true",
                    help="--detail, and the port's collectives by the op "
                         "that moves them")
    ap.add_argument("--route", choices=("auto", "key"), default="auto",
                    help="key: the port with every full-sequence "
                         "attention key-parallel")
    ap.add_argument("--json", default=None, help="write the results here")
    args = ap.parse_args(argv)
    production = [tuple(c.split("/")) for c in args.production
                  if c != "all"]
    if "all" in args.production:
        production = _all_cells()
    args.detail = args.detail or args.by_op
    res = compare(args.memory, MESH_CELLS if args.mesh_cells else None,
                  production, args.by_op, args.route)
    print(f"{'cell':30s} port/reference: flops  flops-casts    bytes  "
          "collective  dominant reference / port")
    for cell, c in res.items():
        q = c["ratio"]
        if "flops" in q:
            print(f"{cell:30s} {q['flops']:16.4f} {q['net']:12.4f} "
                  f"{q['bytes']:8.4f} {q['coll']:11.4f}  "
                  f"{c['reference']['dominant']} / {c['port']['dominant']}")
        if "mem.total_bytes" in q:
            r, p = c["reference"]["mem"], c["port"]["mem"]
            fits = [m["total_bytes"] < 16e9 for m in (r, p)]
            print(f"{cell:30s} memory total {q['mem.total_bytes']:.4f} "
                  f"temp {q['mem.temp_bytes']:.4f}  fits_hbm reference / "
                  f"port {fits[0]} / {fits[1]}"
                  + ("" if fits[0] == fits[1] else "  DIFFERS"))
    if args.detail or args.memory:
        for cell, c in res.items():
            for side in ("reference", "port"):
                s = c[side]
                line = f"{cell:30s} {side:9s}"
                if "flops" in s:
                    line += (f" flops {s['flops']:.6e} casts "
                             f"{s['casts']:.6e} bytes "
                             f"{s['bytes']:.6e} coll {s['coll']:.6e} "
                             f"{s['counts']} compute/memory/collective s "
                             f"{'/'.join(f'{t:.6e}' for t in s['terms'])}")
                if "mem" in s:
                    line += f" memory {s['mem']}"
                if s.get("big_casts"):
                    line += f" largest converts {s['big_casts']}"
                print(line)
                if args.detail and "depths" in s:
                    for depth, d in s["depths"].items():
                        print(f"{'':30s} {side:9s} depth {depth}: flops "
                              f"{d['flops']:.6e} bytes {d['bytes']:.6e} "
                              f"counts {d['counts']} by kind "
                              f"{ {k: round(v, 1) for k, v in d['by_kind'].items()} }")
                        for where, (count, b) in sorted(
                                d.get("by_op", {}).items(),
                                key=lambda e: -e[1][1]):
                            print(f"{'':40s} {b:14.0f} {count:4d}x {where}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
