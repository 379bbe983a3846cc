"""Train a small LM for a few hundred steps with the port's full substrate:
synthetic data pipeline, AdamW, the differentiable train step, the
checkpointed runner with an injected failure and a bit-exact restart.

The port of the reference's ``examples/train_lm.py``, with the same
arguments. Default: a ~55M-param llama-style model (SmolLM family), 200
steps, on the card.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200]
      [--dim 512] [--device cuda]
"""
from __future__ import annotations

import argparse
import dataclasses
import tempfile
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.model_apps import derive_app
from ..data.pipeline import DataConfig, SyntheticLM
from ..device import DEFAULT_DEVICE, resolve_device
from ..dist.fault_tolerance import (FailureInjector, RunnerConfig,
                                    TrainingRunner)
from ..models import model
from ..optim import adamw
from ..train.step import make_train_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=1024)
    ap.add_argument("--inject-failure", action="store_true", default=True)
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(
        get_config("smollm-360m"),
        n_layers=args.layers, d_model=args.dim, n_heads=8, n_kv_heads=4,
        head_dim=args.dim // 8, d_ff=args.dim * 4, vocab_size=args.vocab,
        param_dtype="float32", activation_dtype="float32", remat="none")
    print(f"model: {args.layers}L d={args.dim} vocab={args.vocab} "
          f"→ {cfg.param_count() / 1e6:.1f}M params on {dev}")
    app = derive_app("smollm-360m", "train_step")
    print(f"scheduler app: {app.name} (flops={app.flops:.3g} "
          f"hbm={app.hbm_bytes:.3g}B coll={app.coll_bytes:.3g}B "
          f"n_chips={app.n_chips}, full-size counters the DVFS "
          f"scheduler dispatches on)")

    params = model.init(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev, trainable=True)
    ocfg = adamw.AdamWConfig(lr=5e-3, warmup_steps=20,
                             total_steps=args.steps, weight_decay=0.01)
    opt = adamw.init(params, ocfg)
    step = make_train_step(cfg, ocfg, device=dev)
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq, global_batch=args.batch,
                                  seed=0, order=1))

    # keyed by step so checkpoint-restart replays overwrite, not duplicate
    history: dict[int, float] = {}
    cur_step = {"s": 0}

    def data_fn(s):
        cur_step["s"] = s
        return data.batch(s)

    def step_fn(p, o, batch):
        p, o, m = step(p, o, batch)
        history[cur_step["s"]] = float(m["loss"])
        return p, o, m

    injector = (FailureInjector(fail_at=(args.steps // 2,))
                if args.inject_failure else None)
    with tempfile.TemporaryDirectory(prefix="repro_torch_train_lm_") as d:
        runner = TrainingRunner(RunnerConfig(ckpt_dir=d, ckpt_interval=50),
                                step_fn, data_fn, injector=injector)
        t0 = time.perf_counter()
        runner.run(params, opt, 0, args.steps)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    losses = [history[s] for s in sorted(history)]
    first = np.mean(losses[:10])
    last = np.mean(losses[-10:])
    tok_s = args.batch * args.seq * len(losses) / dt
    print(f"steps={len(losses)} restarts={runner.restarts} wall={dt:.1f}s "
          f"({tok_s:.0f} tok/s on {dev}, host clock)")
    print(f"loss: {first:.3f} → {last:.3f} "
          f"(uniform = {np.log(args.vocab):.3f})")
    if not last < first - 0.2:
        print("FAIL: loss did not improve")
        return 1
    print("OK: loss decreased; failure was injected and recovered" if
          runner.restarts else "OK: loss decreased")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
