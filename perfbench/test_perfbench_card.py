"""The benchmark's cells on the card: each cell, for a few seconds,
through ``run_cell`` as ``run.py`` drives it, comes out correct, and its
traced run gives every per-layer metric it lists (roofline shares at
most 100 %). Run on the card with ``PYTHONPATH=src python -m pytest -q
-m cuda perfbench/test_perfbench_card.py``; they skip without one."""
from __future__ import annotations

import time

import pytest

from perfbench import harness


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda:0"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness._json(harness.ROOT /
                                                "BENCHMARK.json")
                                  ["workloads"]])
@pytest.mark.parametrize("traced", [False, True])
def test_a_cell_on_the_card(card, cell, traced):
    out = harness.run_cell(cell, 2 ** 33 + 17, 3.0, traced, card,
                           time.perf_counter())
    assert out["correct"] is True, out["checks"]
    spec = harness._json(harness.ROOT / "BENCHMARK.json")
    want = {m["name"] for m in harness.cell_metrics(spec, cell, traced)}
    assert set(out["metrics"]) == want
    for name, m in out["metrics"].items():
        if "roofline" in name or "mfu" in name:
            assert 0 < m["value"] <= 100.0
