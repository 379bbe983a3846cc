"""Quickstart: the paper's pipeline end to end.

1. Profile the 12-application suite on the simulated DVFS testbed.
2. Train the CatBoost-style power & time predictors.
3. Schedule a deadline workload with Algorithm 1 (D-DVFS) vs DC/MC.

The port of the reference's ``examples/quickstart.py``: the same steps
and the same printed lines. The predictor and every schedule run on
``--device`` (default ``cuda``: the GBDT kernel builds the clock tables;
without a card that default raises, and ``--device cpu`` runs the plain
version).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from ..configs.paper_suite import PAPER_APPS
from ..core import (EnergyTimePredictor, PredictorConfig, Testbed,
                    build_dataset, make_workload, profile_features,
                    run_schedule)
from ..device import DEFAULT_DEVICE, resolve_device

__all__ = ["POLICIES", "main", "run"]

POLICIES = ("mc", "dc", "d-dvfs")


def run(device=DEFAULT_DEVICE, verbose: bool = True) -> dict:
    """Profile, fit, and schedule under each of ``POLICIES`` on
    ``device``; returns ``{policy: ScheduleResult}``."""
    dev = resolve_device(device)
    say = print if verbose else (lambda *a, **k: None)
    testbed = Testbed(seed=0)
    apps = list(PAPER_APPS)

    say("== 1. profiling campaign (12 apps x 64 clock pairs) ==")
    X, y_power, y_time, groups = build_dataset(apps, testbed, seed=0)
    say(f"   dataset: {X.shape[0]} rows x {X.shape[1]} features")

    say("== 2. train power/time predictors (oblivious-tree GBDT) ==")
    predictor = EnergyTimePredictor(PredictorConfig(), device=dev).fit(
        X, y_power, y_time)
    rng = np.random.default_rng(7)
    feats = {a.name: profile_features(a, testbed, rng=rng) for a in apps}

    say("== 3. deadline-aware scheduling ==")
    jobs = make_workload(apps, testbed, seed=0)
    results = {}
    for policy in POLICIES:
        r = run_schedule(jobs, policy, Testbed(seed=100),
                         predictor=predictor, app_features=feats,
                         device=dev)
        results[policy] = r
        say(f"   {policy:7s} energy={r.total_energy:7.1f} J  "
            f"misses={r.misses}  makespan={r.makespan:5.1f} s")
    dd, dc, mc = (results[p].total_energy for p in ("d-dvfs", "dc", "mc"))
    say(f"\nD-DVFS saves {100*(1-dd/dc):.1f}% vs DC and "
        f"{100*(1-dd/mc):.1f}% vs MC with {results['d-dvfs'].misses} "
        f"deadline misses (paper: 13.8% / 25.2%, zero misses).")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
