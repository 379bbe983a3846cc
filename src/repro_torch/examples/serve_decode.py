"""Serve a small model with batched requests: prefill + autoregressive
decode with the KV cache (ring-buffer windowed cache for SWA archs).

The port of the reference's ``examples/serve_decode.py``, with the same
arguments; the prefill runs the attention and scan kernels on the card.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_decode
      [--arch mixtral-8x22b] [--device cuda]
"""
from __future__ import annotations

import argparse
import time

import torch

from ..configs import get_config
from ..configs.base import reduce_for_smoke
from ..core.model_apps import derive_app
from ..device import DEFAULT_DEVICE, resolve_device
from ..models import model
from ..train.serve import greedy_generate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x22b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = reduce_for_smoke(get_config(args.arch))
    print(f"arch={cfg.name} family={cfg.family} "
          f"(reduced config for the serving demo) on {dev}")
    for phase in ("prefill", "decode"):
        app = derive_app(args.arch, phase)
        print(f"scheduler app: {app.name} (flops={app.flops:.3g} "
              f"hbm={app.hbm_bytes:.3g}B n_chips={app.n_chips}, "
              f"full-size counters the DVFS scheduler dispatches on)")
    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           generator=gen, device=dev)
    extra = model.extra_inputs(cfg, args.batch, args.prompt_len, "prefill",
                               gen, device=dev)
    max_seq = args.prompt_len + args.gen + 8 + (
        cfg.vision_tokens if cfg.family == "vlm" else 0)

    t0 = time.perf_counter()
    out = greedy_generate(cfg, params, prompt, n_steps=args.gen,
                          max_seq=max_seq, extra=extra, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"prefill({args.batch}x{args.prompt_len}) + decode {args.gen} "
          f"steps in {dt:.2f}s ({args.batch * args.gen / dt:.1f} tok/s on "
          f"{dev}, host clock)")
    print("generated token ids (first request):", out[0].tolist())

    # consistency: teacher-forcing forward over prompt + generated tokens
    # reproduces the same greedy continuation
    full = torch.cat([prompt[:1], out[:1]], dim=1)
    with torch.no_grad():
        logits, _ = model.forward(cfg, params, full,
                                  {k: v[:1] for k, v in extra.items()},
                                  device=dev)
    V = logits.shape[1] - full.shape[1]
    redo = logits[0, V + args.prompt_len - 1:-1].argmax(dim=-1)
    agree = float((redo == out[0]).float().mean())
    print(f"teacher-forcing agreement with decode path: {100 * agree:.0f}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
