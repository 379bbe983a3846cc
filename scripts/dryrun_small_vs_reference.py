#!/usr/bin/env python3
"""The dry run's small-mesh cells in both packages, side by side.

The reference's ``tests/test_dryrun.py`` cells — reduced SmolLM, Mixtral
and Falcon-Mamba (bf16 params, remat "full"), train 8 x 128 and decode 8
against a 256-token cache, on a 4x2 ``data`` x ``model`` mesh — through
the reference's ``_compile`` (8 host devices, XLA's cost and memory
analysis of the production, scanned compile) and through the port's
(a fake 8-rank process group, fake tensors), each package in a process
of its own. Prints one line a cell: FLOPs, bytes and memory per device,
the collectives by kind, and the three roofline terms (the v5e data
model) with the dominant one.

XLA counts a scanned layer stack's body once and counts elementwise work;
the port's trace runs every layer and counts matmul FLOPs only, so the
FLOPs differ by design; argument and alias bytes are comparable. The
port's bytes sum every eager op's operands and results (nothing fused),
so its memory term, and with it the dominant term, is not comparable
with XLA's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/dryrun_small_vs_reference.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("smollm-360m", "mixtral-8x22b", "falcon-mamba-7b")

REFERENCE = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses as dc, json, sys
    from repro.configs import get_config
    from repro.configs.base import ShapeSpec, reduce_for_smoke
    from repro.launch import dryrun as dr
    from repro.launch.mesh import make_mesh
    from repro.roofline import analysis as roofline
    mesh = make_mesh((4, 2), ("data", "model"))
    out = {}
    for arch in json.loads(sys.argv[1]):
        cfg = dc.replace(reduce_for_smoke(get_config(arch)),
                         param_dtype="bfloat16", remat="full")
        for shape in (ShapeSpec("t", 128, 8, "train"),
                      ShapeSpec("d", 256, 8, "decode")):
            c = dr._compile(cfg, shape, mesh, 1)
            cost = roofline.costs_of(c)
            mem = roofline.memory_stats(c)
            rl = roofline.make_roofline(
                cost["flops"], cost["bytes"], cost["coll_raw"],
                cost["coll_modeled"], cost["coll_counts"], mem, 0.0)
            out[f"{arch} {shape.mode}"] = dict(
                flops=cost["flops"], bytes=cost["bytes"], mem=mem,
                colls=cost["coll_counts"], dominant=rl.dominant,
                terms=[rl.compute_s, rl.memory_s, rl.collective_s])
    print(json.dumps(out))
""")

PORT = textwrap.dedent("""
    import dataclasses as dc, json, sys
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec, reduce_for_smoke
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import init_fake_world, make_mesh
    from repro_torch.roofline import analysis as roofline
    init_fake_world(8)
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    out = {}
    for arch in json.loads(sys.argv[1]):
        cfg = dc.replace(reduce_for_smoke(get_config(arch)),
                         param_dtype="bfloat16", remat="full")
        for shape in (ShapeSpec("t", 128, 8, "train"),
                      ShapeSpec("d", 256, 8, "decode")):
            tr = dr._compile(cfg, shape, mesh, 1, device="cpu")
            cost = roofline.costs_of(tr)
            mem = roofline.memory_stats(tr)
            rl = roofline.make_roofline(
                cost["flops"], cost["bytes"], cost["coll_raw"],
                cost["coll_modeled"], cost["coll_counts"], mem, 0.0)
            out[f"{arch} {shape.mode}"] = dict(
                flops=cost["flops"], bytes=cost["bytes"], mem=mem,
                colls=cost["coll_counts"], dominant=rl.dominant,
                terms=[rl.compute_s, rl.memory_s, rl.collective_s])
    print(json.dumps(out))
""")


def _run(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code, json.dumps(CELLS)],
                       capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=1800, check=True)
    return json.loads(r.stdout.strip().splitlines()[-1])


def main() -> int:
    ref, port = _run(REFERENCE), _run(PORT)
    for cell in ref:
        for name, res in (("reference", ref[cell]), ("port", port[cell])):
            m = res["mem"]
            print(f"{cell:24s} {name:9s} flops {res['flops']:.6e} bytes "
                  f"{res['bytes']:.6e} argument {m['argument_bytes']} "
                  f"output {m['output_bytes']} temp {m['temp_bytes']} "
                  f"alias {m['alias_bytes']} collectives {res['colls']} "
                  "compute/memory/collective s "
                  f"{'/'.join(f'{t:.6e}' for t in res['terms'])} "
                  f"{res['dominant']}-bound")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
