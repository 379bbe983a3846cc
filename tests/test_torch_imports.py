"""Import hygiene and device defaults of the PyTorch port (repro_torch).

The port must never pull in ``jax``, ``ml_dtypes`` or the reference
package ``repro`` (``import repro.core`` alone drags JAX in), and its entry
points must run on the card by default: on a machine without CUDA the
default raises and names ``device="cpu"`` instead of quietly running on
the CPU.
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
        "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20     # every module was reached


@pytest.mark.parametrize("package", ["repro_torch.examples.quickstart",
                                     "repro_torch.examples.schedule_jobs",
                                     "repro_torch.dist",
                                     "repro_torch.roofline",
                                     "repro_torch.launch",
                                     "repro_torch.launch.dryrun",
                                     "repro_torch.dist.collectives"])
def test_subpackage_imports_alone_without_jax_or_repro(package):
    """Each subpackage imports first, in a fresh interpreter (the straggler
    monitor's package reaches ``core`` and back through ``federation``),
    and pulls in neither JAX nor the reference."""
    code = (
        "import importlib, sys\n"
        f"mod = importlib.import_module({package!r})\n"
        "assert mod.__all__ and all(hasattr(mod, n) for n in mod.__all__)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'ml_dtypes'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr


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
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro",
                                        "ml_dtypes"}


def _entry_points():
    from repro_torch import resolve_device
    from repro_torch.core import (ColdStartSynthesizer, EnergyTimePredictor,
                                  PredictionService, Testbed, V5E_DVFS,
                                  legacy_run_schedule, run_schedule)
    from repro_torch.core.gbdt import GBDTModel, GBDTParams, fit_gbdt
    from repro_torch.configs import get_config
    from repro_torch.configs.base import reduce_for_smoke
    from repro_torch.convert import model_from_arrays
    from repro_torch.models import model
    from repro_torch.convert import opt_state_from_arrays
    from repro_torch.examples import (quickstart, schedule_jobs,
                                      serve_decode, train_lm)
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import serve
    from repro_torch.train.step import loss_fn, make_train_step
    X = np.random.default_rng(0).normal(size=(8, 3))
    cfg = reduce_for_smoke(get_config("falcon-mamba-7b"))
    params = model.init(cfg, device="cpu")
    tokens = np.zeros((1, 4), np.int32)
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
        "model.init": lambda: model.init(cfg),
        "model.init_cache": lambda: model.init_cache(cfg, 1, 8),
        "model.forward": lambda: model.forward(cfg, params, tokens),
        "model.prefill": lambda: model.prefill(cfg, params, tokens, 8),
        "model.decode_step": lambda: model.decode_step(
            cfg, params, model.init_cache(cfg, 1, 8, device="cpu"),
            tokens[:, :1], 0),
        "model_from_arrays": lambda: model_from_arrays(
            cfg, {"unused": None}),
        "greedy_generate": lambda: serve.greedy_generate(cfg, params,
                                                         tokens, 2, 8),
        "make_serve_step": lambda: serve.make_serve_step(cfg),
        "make_prefill_step": lambda: serve.make_prefill_step(cfg, 8),
        "ColdStartSynthesizer": lambda: ColdStartSynthesizer(dvfs=V5E_DVFS),
        "make_train_step": lambda: make_train_step(cfg, AdamWConfig()),
        "loss_fn": lambda: loss_fn(params, {"tokens": tokens,
                                            "labels": tokens}, cfg),
        "opt_state_from_arrays": lambda: opt_state_from_arrays(
            params, {"step": 0, "m": {}, "v": {}}, device="cuda"),
        "train_lm": lambda: train_lm.main(["--steps", "1"]),
        "serve_decode": lambda: serve_decode.main([]),
        "quickstart": lambda: quickstart.main([]),
        "schedule_jobs": lambda: schedule_jobs.main(["--steps", "1"]),
    }


@pytest.mark.parametrize("name", ["resolve_device", "EnergyTimePredictor",
                                  "PredictionService", "run_schedule",
                                  "legacy_run_schedule", "fit_gbdt",
                                  "GBDTModel", "model.init",
                                  "model.init_cache", "model.forward",
                                  "model.prefill", "model.decode_step",
                                  "model_from_arrays", "greedy_generate",
                                  "make_serve_step", "make_prefill_step",
                                  "ColdStartSynthesizer", "make_train_step",
                                  "loss_fn", "opt_state_from_arrays",
                                  "train_lm", "serve_decode", "quickstart",
                                  "schedule_jobs"])
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
