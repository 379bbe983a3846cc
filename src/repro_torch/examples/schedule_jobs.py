"""End to end: deadline-aware DVFS scheduling of the framework's
own jobs.

The jobs are the architectures' training and serving steps. Their
resource profiles (FLOPs, HBM bytes and collective bytes a device a
step) come from the dry run's per-device roofline
(:mod:`repro_torch.launch.dryrun`, written with ``--out``), so the
scheduler sets clocks for the workloads the framework runs. The
predictors are fitted on the paper's suite plus those jobs, and the jobs
are scheduled under mc, dc, d-dvfs and oracle through one shared
:class:`~repro_torch.core.PredictionService` on ``--device`` (default
``cuda``: the GBDT kernel builds the clock tables; without a card that
default raises, and ``--device cpu`` runs the plain version).

The port of the reference's ``examples/schedule_jobs.py``, with the same
arguments, printed lines and dry-run file: ``results/dryrun_final.json``,
else ``results/dryrun_single.json``, at the root of the checkout, or the
file :func:`arch_apps` is given. Where no such file exists it schedules
the reference's four built-in profiles: that is the reference's own
data default (a published-size stand-in for a dry run not yet made),
not a fallback from one device to another.

Run:  PYTHONPATH=src python -m repro_torch.examples.schedule_jobs
      [--steps 20] [--jobs 16] [--results FILE] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib

import numpy as np

from ..configs.paper_suite import PAPER_APPS
from ..core import (AppProfile, EnergyTimePredictor, PredictionService,
                    PredictorConfig, Testbed, build_dataset, make_workload,
                    profile_features, run_schedule)
from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["BUILT_IN", "POLICIES", "arch_apps", "default_results", "main",
           "run"]

_DIR = pathlib.Path(__file__).resolve().parents[3] / "results"
POLICIES = ("mc", "dc", "d-dvfs", "oracle")

#: the reference's built-in profiles, used when no dry-run file exists:
#: (name, flops/dev/step, bytes/dev/step, coll bytes/dev/step, kind)
BUILT_IN = [
    ("qwen2.5-14b/train_4k", 1.5e12, 4.0e11, 9.0e10, "train"),
    ("smollm-360m/train_4k", 2.0e13, 1.6e12, 2.9e10, "train"),
    ("mixtral-8x22b/decode_32k", 1.6e11, 2.8e10, 2.4e9, "decode"),
    ("falcon-mamba-7b/long_500k", 2.1e9, 6.3e9, 1.6e9, "decode"),
]


def default_results() -> pathlib.Path:
    """The reference's dry-run file: ``dryrun_final.json``, else
    ``dryrun_single.json``, in ``results/`` at the checkout's root."""
    for name in ("dryrun_final.json", "dryrun_single.json"):
        if (_DIR / name).exists():
            return _DIR / name
    return _DIR / "dryrun_final.json"


def arch_apps(steps: int, results=None) -> list[AppProfile]:
    """One AppProfile per (arch x shape) job of the dry-run file
    ``results`` (default :func:`default_results`): ``steps`` steps per
    job, from each ok cell's ``roofline.flops``, ``bytes_accessed`` and
    ``coll_bytes_modeled``; :data:`BUILT_IN` when the file is absent or
    has no such cell."""
    path = pathlib.Path(results) if results is not None else \
        default_results()
    rows = []
    if os.path.exists(path):
        with open(path) as f:
            cells = json.load(f)
        for c in cells:
            if c.get("status") == "ok" and "roofline" in c:
                rl = c["roofline"]
                rows.append((f"{c['arch']}/{c['shape']}", rl["flops"],
                             rl["bytes_accessed"], rl["coll_bytes_modeled"],
                             "train" if "train" in c["shape"] else "decode"))
    if not rows:
        rows = BUILT_IN
    apps = []
    for i, (name, fl, by, co, kind) in enumerate(rows):
        apps.append(AppProfile(
            name=name, flops=fl * steps, hbm_bytes=by * steps,
            coll_bytes=co * steps, overhead_s=0.05 * steps, kind=kind,
            n_chips=256, wiggle_time=0.03, wiggle_power=0.03,
            seed=500 + i))
    return apps


def run(apps, steps: int, device=DEFAULT_DEVICE, verbose: bool = True):
    """Fit the predictors on the paper suite plus ``apps`` (of ``steps``
    steps each) and schedule ``apps`` under each of :data:`POLICIES`
    through one service on ``device``; returns ``({policy:
    ScheduleResult}, service)``."""
    dev = resolve_device(device)
    say = print if verbose else (lambda *a, **k: None)
    testbed = Testbed(seed=0)
    say(f"scheduling {len(apps)} framework jobs ({steps} steps each):")
    for a in apps[:8]:
        say(f"  {a.name:34s} {a.flops/1e12:8.1f} TFLOP  "
            f"{a.hbm_bytes/1e9:8.1f} GB  AI={a.arithmetic_intensity:6.1f}")

    # the predictors are trained on the paper suite + these jobs' profiles
    train_apps = list(PAPER_APPS) + list(apps)
    X, yp, yt, _ = build_dataset(train_apps, testbed, seed=0)
    predictor = EnergyTimePredictor(PredictorConfig(), device=dev).fit(
        X, yp, yt)
    rng = np.random.default_rng(7)
    feats = {a.name: profile_features(a, testbed, rng=rng)
             for a in train_apps}

    jobs = make_workload(apps, testbed, seed=1, arrival_range=(1.0, 120.0))
    # one shared prediction service: the app x clock-ladder tables are
    # built once and reused by every policy below
    run_tb = Testbed(seed=42)
    service = PredictionService(run_tb.dvfs, predictor=predictor,
                                app_features=feats, testbed=run_tb,
                                device=dev)
    say()
    results = {}
    for policy in POLICIES:
        r = run_schedule(jobs, policy, run_tb, service=service, device=dev)
        results[policy] = r
        # fleet energy = per-chip energy x chips
        say(f"  {policy:7s} per-chip E={r.total_energy:9.1f} J  "
            f"fleet E={r.total_energy*256/3.6e6:7.2f} kWh  "
            f"misses={r.misses}")
    say(f"\n  prediction service: {service.stats.summary()}")
    return results, service


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20,
                    help="train/serve steps per scheduled job")
    ap.add_argument("--jobs", type=int, default=16)
    ap.add_argument("--results", default=None,
                    help="a dry-run JSON (default: results/dryrun_final"
                         ".json, else results/dryrun_single.json)")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    apps = arch_apps(args.steps, args.results)[:args.jobs]
    run(apps, args.steps, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
