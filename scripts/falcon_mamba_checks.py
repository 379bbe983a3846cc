"""FalconMamba-7B at its published widths on the card, outside the
benchmark's timed runs: what ``falcon-mamba-7b.prefill``'s check reads,
and what it would read without FalconMamba's own parts.

    python3 scripts/falcon_mamba_checks.py decode --seeds 1,2
    python3 scripts/falcon_mamba_checks.py guards --seeds 1,2,3 \\
        [--seconds 12]

``decode``: a prompt of 2 048 tokens (first seed) and of 8 192 (second),
prefilled and then decoded greedily for 32 steps through the recurrent
state (``serve.make_serve_step``), every returned position's logits held
to ``perfbench/reference/ssm.py``'s full forward over the same tokens;
one JSON line a prompt with the widest logit gap (the check's measure)
and the widest logit difference.

``guards``: the cell served for ``--seconds`` a seed as the benchmark
serves it (``harness.serve_seed``, then ``harness.readings``), with the
port as configured and with each of FalconMamba's parts taken out of the
port alone (the reference keeps them): ``mixer_rms_eps`` unset (no
weightless dt, B and C norms) and ``residual_in_fp32`` off (a bf16
residual stream). One JSON line a variant and seed with
``max_logit_gap`` and the cell's limit. A part whose absence reads under
the limit is one the cell's check cannot guard.

Each writes its lines to standard output; the weights are made from the
seed on the card (~15 s a seed).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[0:0] = [str(ROOT), str(ROOT / "src")]

CELL = "falcon-mamba-7b.prefill"
#: the port's fields each variant changes (None: as configured)
VARIANTS = {"as-configured": None,
            "no-mixer-norms": {"mixer_rms_eps": None},
            "bf16-residual": {"residual_in_fp32": False}}
DECODE_PROMPTS, DECODE_STEPS = (2048, 8192), 32


def decode(seeds, dev) -> None:
    import torch

    from perfbench import reference, weights
    from perfbench.port import System
    from perfbench.reference import ssm as ref
    c = json.loads((ROOT / "perfbench/configs/falcon-mamba-7b.json")
                   .read_text())
    for seed, S in zip(seeds, DECODE_PROMPTS):
        W = weights.make(ref.weight_shapes(c), seed, dev)
        system = System(c, W, dev)
        g = torch.Generator(device=dev).manual_seed(seed)
        prompt = torch.randint(0, c["vocab_size"], (1, S), generator=g,
                               device=dev)
        t0 = time.perf_counter()
        logits, cache = system.prefill(prompt, S + DECODE_STEPS)
        got, toks = [logits[0].float().cpu()], []
        tok = logits[:, -1:].argmax(dim=-1)
        for k in range(DECODE_STEPS):
            toks.append(tok)
            lg, cache = system.step(cache, tok, S + k)
            got.append(lg[0].float().cpu())
            tok = lg[:, -1:].argmax(dim=-1)
        torch.cuda.synchronize()
        served_s = time.perf_counter() - t0
        got = torch.cat(got)
        del system, cache, logits
        torch.cuda.empty_cache()
        reference.exact_fp32()
        seq = torch.cat([prompt[0], torch.cat(toks, dim=1)[0]])
        t0 = time.perf_counter()
        want = torch.cat([lg.cpu() for _, lg in ref.logit_blocks(c, W, seq)])
        ref_s = time.perf_counter() - t0
        diff = (got - want).abs()
        best, arg = want.max(dim=-1)
        gap = best - want.gather(-1, got.argmax(-1, keepdim=True))[:, 0]
        print(json.dumps({
            "check": "decode", "seed": seed, "prompt": S,
            "steps": DECODE_STEPS, "positions": got.shape[0],
            "max_logit_gap": float(gap.max()),
            "max_logit_gap_decode": float(gap[S:].max()),
            "max_abs_logit_diff": float(diff.max()),
            "max_abs_logit_diff_decode": float(diff[S:].max()),
            "logit_scale_max": float(want.abs().max()),
            "argmax_agree": int((arg == got.argmax(-1)).sum()),
            "served_s": served_s, "reference_s": ref_s}), flush=True)
        del W, got, want
        torch.cuda.empty_cache()


def guards(seeds, seconds, dev) -> None:
    from perfbench import harness
    from perfbench.port import ssm as port_ssm
    from perfbench.trace import Recorder
    cell = harness.load_cell(CELL)
    configured = port_ssm.config
    try:
        for seed in seeds:
            for variant, change in VARIANTS.items():
                port_ssm.config = (configured if change is None else
                                   lambda c, change=change:
                                   dataclasses.replace(configured(c),
                                                       **change))
                t0 = time.perf_counter()
                served = harness.serve_seed(cell, seed, seconds, dev,
                                            Recorder(False))
                got = harness.readings(cell, seed, dev, served)
                print(json.dumps({
                    "check": "guards", "variant": variant, "seed": seed,
                    "max_logit_gap": got["max_logit_gap"],
                    "limit": cell.limits["max_logit_gap"],
                    "sequences": len(served["samples"]),
                    "longest_prompt": max(r.req.prompt_len
                                          for r, _ in served["samples"]),
                    "seconds": time.perf_counter() - t0}), flush=True)
    finally:
        port_ssm.config = configured


def main(argv) -> int:
    import torch

    from perfbench import harness
    ap = argparse.ArgumentParser(prog="scripts/falcon_mamba_checks.py")
    ap.add_argument("check", choices=("decode", "guards"))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("falcon_mamba_checks: no CUDA card", file=sys.stderr)
        return 2
    harness.use_checkout_caches()
    seeds = [int(s) for s in args.seeds.split(",") if s]
    dev = torch.device("cuda:0")
    if args.check == "decode":
        decode(seeds, dev)
    else:
        guards(seeds, args.seconds, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
