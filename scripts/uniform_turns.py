#!/usr/bin/env python3
"""Time the ``uniform`` cell of ``chip_smoke.py`` (phase 4) for several
source trees in turns, on one NVIDIA card.

    python3 scripts/uniform_turns.py TREE [TREE ...] [--order ABBA]

Each turn is a fresh process that imports ``repro_torch`` from that tree's
``src/`` (building its kernels there on first use), fits the default
predictor on the card, and runs the 100 000-job stream as phase 4 does: a
CUDA ``PredictionService`` with ``prefetch_tables``, then ``run_schedule``
(min-energy, 8 devices, no budget managers), timed on the host clock
around both. Each turn prints one JSON line with the tree, the best of
``--reps`` walls, jobs/s at that wall, total energy and misses. ``--order``
maps letters to the trees given (A the first), so ``ABBA`` runs the
first tree, the second twice, then the first again: host-clock rates
move between runs on a shared host, so two trees are compared only within
one call, in turns.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

N_JOBS = 100_000
N_DEVICES = 8


def turn(tree: str, reps: int) -> dict:
    sys.path.insert(0, str(pathlib.Path(tree).resolve() / "src"))
    import numpy as np
    import torch
    from repro_torch.configs.paper_suite import PAPER_APPS
    from repro_torch.core import (EnergyTimePredictor, PredictionService,
                                  PredictorConfig, Testbed, V5E_DVFS,
                                  build_dataset, profile_features,
                                  run_schedule, stream_workload)
    dev = torch.device("cuda", torch.cuda.current_device())
    tb = Testbed(seed=0)
    apps = list(PAPER_APPS)
    X, yp, yt, _ = build_dataset(apps, tb, seed=0)
    rng = np.random.default_rng(7)
    feats = {a.name: profile_features(a, tb, rng=rng) for a in apps}
    pred = EnergyTimePredictor(PredictorConfig(), device=dev).fit(X, yp, yt)
    jobs = list(stream_workload(apps, tb, n_jobs=N_JOBS, seed=1,
                                n_devices=N_DEVICES))
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        svc = PredictionService(V5E_DVFS, predictor=pred, app_features=feats,
                                testbed=tb, device=dev)
        svc.prefetch_tables([a.name for a in apps])
        r = run_schedule(jobs, "min-energy", tb, service=svc,
                         n_devices=N_DEVICES, queue_aware=False,
                         virtual_pacing=False, device=dev)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    best = min(walls)
    return {"tree": tree, "walls_s": walls, "best_s": best,
            "jobs_per_s": N_JOBS / best,
            "total_energy": float(r.total_energy), "misses": r.misses}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--order", default=None,
                    help="letters A, B, ... naming the trees, in turn order")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--turn", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(turn(args.trees[0], args.reps)), flush=True)
        return 0
    order = args.order or "".join(chr(65 + i) for i in range(len(args.trees)))
    for letter in order:
        tree = args.trees[ord(letter) - 65]
        out = subprocess.run(
            [sys.executable, __file__, tree, "--turn", "--reps",
             str(args.reps)], capture_output=True, text=True, check=True)
        row = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps({"turn": letter, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
