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
the collective counts and modeled bytes by kind. ``--memory`` adds the
production (scanned) compile's and the full-depth trace's memory fields:
argument, output, temp and alias bytes.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/dryrun_small_vs_reference.py [--detail] [--memory] [--json out.json]
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
"""

_COMMON = """
    def cell_costs(dr, roofline, cfg, shape, compile_at, by_kind, casts,
                   memory):
        l1, l2, n, mk = dr._depth_plan(cfg)
        depths = {}
        for depth in (l1, l2):
            art = compile_at(mk(depth), shape)
            c = roofline.costs_of(art)
            depths[depth] = dict(counts=c["coll_counts"], by_kind=by_kind(art),
                                 flops=c["flops"], bytes=c["bytes"],
                                 casts=casts(art))
            if depth == l1:
                c1 = c
            else:
                c2 = c
        costs = roofline.extrapolate_costs(c1, c2, l1, l2, n)
        a, b = depths[l1]["casts"], depths[l2]["casts"]
        slope = (b - a) / (l2 - l1)
        cast = max(a - l1 * slope, 0.0) + n * slope
        extra_f, extra_b = roofline.ssm_scan_correction(cfg, shape, 8)
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

    def run(get_config, ShapeSpec, reduce_for_smoke, dr, roofline,
            compile_at, by_kind, casts, stand_in=None):
        archs, memory = json.loads(sys.argv[1]), sys.argv[2] == "1"
        out = {}
        for arch in archs:
            cfg = dc.replace(reduce_for_smoke(get_config(arch)),
                             param_dtype="bfloat16", remat="full")
            for shape in (ShapeSpec("t", 128, 8, "train"),
                          ShapeSpec("d", 256, 8, "decode")):
                key = f"{arch} {shape.mode}"
                out[key] = cell_costs(dr, roofline, cfg, shape, compile_at,
                                      by_kind, casts, memory)
                if stand_in is not None and cfg.family == "ssm" and \
                        shape.mode == "train":
                    with stand_in():
                        out[key + " stand-in"] = cell_costs(
                            dr, roofline, cfg, shape, compile_at, by_kind,
                            casts, False)
        print(json.dumps(out))
"""

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses as dc, json, sys
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec, reduce_for_smoke
    from repro.launch import dryrun as dr
    from repro.launch.mesh import make_mesh
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

    mesh = make_mesh((4, 2), ("data", "model"))
    run(get_config, ShapeSpec, reduce_for_smoke, dr, roofline,
        lambda cfg, shape: dr._compile(cfg, shape, mesh, 1),
        lambda c: roofline.parse_collectives(c.as_text()).by_kind,
        lambda c: hlo_casts(c.as_text()), stand_in)
""")

PORT = textwrap.dedent("""
    import dataclasses as dc, json, sys
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec, reduce_for_smoke
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import init_fake_world, make_mesh
    from repro_torch.roofline import analysis as roofline
""") + textwrap.dedent(_COMMON) + textwrap.dedent("""
    init_fake_world(8)
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    run(get_config, ShapeSpec, reduce_for_smoke, dr, roofline,
        lambda cfg, shape: dr._compile(cfg, shape, mesh, 1, device="cpu"),
        lambda t: roofline.costs_of(t)["coll_by_kind"],
        lambda t: t.cast_flops)
""")


def _run(code: str, memory: bool) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code, json.dumps(CELLS),
                        "1" if memory else "0"],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=1800)
    if r.returncode:
        raise RuntimeError(r.stderr[-4000:])
    return json.loads(r.stdout.strip().splitlines()[-1])


def compare(memory: bool = False) -> dict:
    """{cell: {"reference": costs, "port": costs, "ratio": {...}}}, the
    two packages run at once."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(2) as pool:
        ref, port = pool.map(lambda c: _run(c, memory), (REFERENCE, PORT))
    out = {}
    for cell in ref:
        r, p = ref[cell], port[cell.replace(" stand-in", "")]
        out[cell] = {"reference": r, "port": p, "ratio": {
            k: (p[k] / r[k] if r[k] else float("nan"))
            for k in ("flops", "net", "bytes", "coll")}}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--detail", action="store_true",
                    help="absolute numbers and collectives per depth")
    ap.add_argument("--memory", action="store_true",
                    help="the scanned compile's / full trace's memory "
                         "fields too")
    ap.add_argument("--json", default=None, help="write the results here")
    args = ap.parse_args(argv)
    res = compare(args.memory)
    print(f"{'cell':24s} port/reference: flops  flops-casts    bytes  "
          "collective  dominant reference / port")
    for cell, c in res.items():
        q = c["ratio"]
        print(f"{cell:24s} {q['flops']:16.4f} {q['net']:12.4f} "
              f"{q['bytes']:8.4f} {q['coll']:11.4f}  "
              f"{c['reference']['dominant']} / {c['port']['dominant']}")
    if args.detail or args.memory:
        for cell, c in res.items():
            for side in ("reference", "port"):
                s = c[side]
                line = (f"{cell:24s} {side:9s} flops {s['flops']:.6e} casts "
                        f"{s['casts']:.6e} bytes "
                        f"{s['bytes']:.6e} coll {s['coll']:.6e} "
                        f"{s['counts']} compute/memory/collective s "
                        f"{'/'.join(f'{t:.6e}' for t in s['terms'])}")
                if args.memory:
                    line += f" memory {s['mem']}"
                print(line)
                if args.detail:
                    for depth, d in s["depths"].items():
                        print(f"{'':24s} {side:9s} depth {depth}: flops "
                              f"{d['flops']:.6e} bytes {d['bytes']:.6e} "
                              f"counts {d['counts']} by kind "
                              f"{ {k: round(v, 1) for k, v in d['by_kind'].items()} }")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
