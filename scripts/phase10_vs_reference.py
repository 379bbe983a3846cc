#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase-10 scenarios at full size on the CPU in the
port and in the JAX reference, and compare their records field for field.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/phase10_vs_reference.py

The scenarios are ``chip_smoke``'s own functions (cold start: 800 jobs with
6 novel apps, frozen and corrected; federation: 10 000 jobs on the 64-device
8-rack fleet, uncapped, federated and straggler rescue; models: the capped
120 + 30 job headline mix, max-clock and min-energy), called once with
``repro_torch.core`` on ``device="cpu"`` and once with ``repro.core``. Each
package fits its own default predictors. Prints one line per run with the
misses and total energy of both and whether every record is equal, and
exits non-zero if any run differs. Needs both packages, so it runs where
the reference is installed, not on the card's machine.
"""
from __future__ import annotations

import pathlib
import sys
import time
import types

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def _without_device(fn):
    def call(*args, **kw):
        kw.pop("device", None)
        return fn(*args, **kw)
    return call


def _reference_core():
    """``repro.core`` behind the port's signatures: the entry points that
    take ``device`` in the port drop it."""
    import repro.core as rc
    ns = types.SimpleNamespace(**{n: getattr(rc, n) for n in dir(rc)
                                  if not n.startswith("_")})
    ns.run_schedule = _without_device(rc.run_schedule)
    ns.PredictionService = _without_device(rc.PredictionService)
    return ns


def _scenarios(core, apps, kw) -> dict:
    tb = core.Testbed(seed=0)
    X, yp, yt, _ = core.build_dataset(apps, tb, seed=0)
    rng7 = np.random.default_rng(7)
    feats = {a.name: core.profile_features(a, tb, rng=rng7) for a in apps}
    pred = core.EnergyTimePredictor(core.PredictorConfig(), **kw).fit(
        X, yp, yt)
    class_features, data = cs._hetero_fixture(core, apps)
    fed_pred = core.EnergyTimePredictor(core.PredictorConfig(), **kw).fit(
        *data)
    cpu = torch.device("cpu")
    return {
        "coldstart": cs._coldstart_runs(core, apps, tb, pred, feats, cpu),
        "federation": cs._federation_runs(core, apps, class_features,
                                          fed_pred, cpu),
        "models": cs._models_runs(core, apps, tb, pred, feats, cpu)}


def main() -> int:
    import repro_torch.core as pc
    from repro.configs.paper_suite import PAPER_APPS as r_apps
    from repro_torch.configs.paper_suite import PAPER_APPS as p_apps
    out = {}
    for name, core, apps, kw in (("port", pc, p_apps, {"device": "cpu"}),
                                 ("ref", _reference_core(), r_apps, {})):
        t0 = time.perf_counter()
        out[name] = _scenarios(core, list(apps), kw)
        print(f"{name}: {time.perf_counter() - t0:.3f} s (CPU, host clock)")
    bad = 0
    for scenario, arms in out["port"].items():
        for arm, (p, _, _) in arms.items():
            r = out["ref"][scenario][arm][0]
            same = (len(p.records) == len(r.records)
                    and all(cs._fields(a) == cs._fields(b)
                            for a, b in zip(p.records, r.records)))
            bad += not same
            print(f"{scenario}/{arm}: records equal {same}; "
                  f"{len(p.records)} records; misses port {p.misses} ref "
                  f"{r.misses}; energy port {float(p.total_energy)!r} ref "
                  f"{float(r.total_energy)!r} J")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
