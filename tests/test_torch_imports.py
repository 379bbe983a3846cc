"""Import hygiene and device defaults of the PyTorch port (repro_torch).

The port must never pull in ``jax`` or the reference package ``repro``
(``import repro.core`` alone drags JAX in), and its entry points must run
on the card by default: on a machine without CUDA the default raises and
names ``device="cpu"`` instead of quietly running on the CPU.
"""
from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def test_importing_every_port_module_leaves_jax_and_repro_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20     # every module was reached


def _imported_roots(path: pathlib.Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_repro(path):
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def _entry_points():
    from repro_torch import resolve_device
    from repro_torch.core import (EnergyTimePredictor, PredictionService,
                                  Testbed, V5E_DVFS, legacy_run_schedule,
                                  run_schedule)
    from repro_torch.core.gbdt import GBDTModel, GBDTParams, fit_gbdt
    X = np.random.default_rng(0).normal(size=(8, 3))
    return {
        "resolve_device": lambda: resolve_device(),
        "EnergyTimePredictor": lambda: EnergyTimePredictor(),
        "PredictionService": lambda: PredictionService(V5E_DVFS),
        "run_schedule": lambda: run_schedule([], "dc", Testbed()),
        "legacy_run_schedule": lambda: legacy_run_schedule([], "dc",
                                                           Testbed()),
        "fit_gbdt": lambda: fit_gbdt(X, X[:, 0], GBDTParams(iterations=2)),
        "GBDTModel": lambda: GBDTModel(
            base=0.0, feats=np.zeros((1, 1), np.int32),
            thresholds=np.zeros((1, 1)), leaves=np.zeros((1, 2)),
            split_gain=np.zeros(3), params=GBDTParams()),
    }


@pytest.mark.parametrize("name", ["resolve_device", "EnergyTimePredictor",
                                  "PredictionService", "run_schedule",
                                  "legacy_run_schedule", "fit_gbdt",
                                  "GBDTModel"])
def test_default_device_is_cuda_and_raises_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _entry_points()[name]()


def test_cpu_is_available_on_request():
    from repro_torch import resolve_device
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
