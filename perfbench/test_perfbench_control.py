"""How ``correct`` is decided, at a size a test run holds: the control
(the reference in fp8, put in the program's place) reads well above the
program, and a run whose timed path is broken underneath comes out not
correct, once for each fault a serving cell can have. The harness's look
for a card is skipped (``run_cell`` on the CPU); the rest of a run is
driven as on the card."""
from __future__ import annotations

import time

import pytest
import torch

from perfbench import harness, port, testcells
from perfbench.trace import Recorder


@pytest.fixture
def tiny(tmp_path):
    return testcells.make_home(tmp_path)


@pytest.mark.parametrize("cell", sorted(testcells.CELLS))
def test_the_control_reads_far_above_the_program(tiny, cell):
    home, spec = tiny
    cl = harness.load_cell(cell, home, spec)
    for seed in (1, 2, 3):
        served = harness.serve_seed(cl, seed, 1.0, "cpu", Recorder(False))
        got = harness.readings(cl, seed, "cpu", served, control=True)
        program, control = got["max_logit_gap"], got["control.max_logit_gap"]
        assert program <= testcells.LIMIT < control
        assert control >= 3 * max(program, 1e-3)


def _unchanged_state(orig):
    """The decode step computes its logits but hands back the cache as it
    was before the step (the new K and V never kept)."""
    def step(self, cache, tokens, pos):
        before = {k: {n: t.clone() for n, t in v.items()}
                  for k, v in cache.items()}
        logits, _ = orig(self, cache, tokens, pos)
        for k, v in cache.items():
            for n, t in v.items():
                t.copy_(before[k][n])
        return logits, cache
    return "step", step


def _half_batch(orig):
    """The decode step computes the first half of the batch; the rest get
    the mean of that half's logits."""
    def step(self, cache, tokens, pos):
        logits, cache = orig(self, cache, tokens, pos)
        half = logits.shape[0] // 2
        logits = logits.clone()
        logits[half:] = logits[:half].mean(dim=0, keepdim=True)
        return logits, cache
    return "step", step


def _altered(which):
    """The prefill's last logits, or one decode step's, put another
    token first."""
    def alter(logits):
        logits = logits.clone()
        last = logits[:, -1]
        best = last.argmax(dim=-1)
        last.scatter_(-1, ((best + 1) % last.shape[-1])[:, None],
                      float(last.max()) + 1.0)
        return logits

    def fault(orig):
        if which == "prefill":
            def prefill(self, tokens, max_seq):
                logits, cache = orig(self, tokens, max_seq)
                return alter(logits), cache
            return "prefill", prefill

        def step(self, cache, tokens, pos):
            logits, cache = orig(self, cache, tokens, pos)
            return (alter(logits) if pos == 18 else logits), cache
        return "step", step
    return fault


FAULTS = [("tiny.decode", "unchanged-state", _unchanged_state),
          ("tiny.decode", "half-batch", _half_batch),
          ("tiny.decode", "token-altered", _altered("step")),
          ("tiny.prefill", "token-altered", _altered("prefill"))]


@pytest.mark.parametrize("cell,name,fault", FAULTS,
                         ids=[f"{c}-{n}" for c, n, _ in FAULTS])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, name,
                                            fault):
    home, spec = tiny
    attr = fault(None)[0]
    orig = getattr(port.System, attr)
    monkeypatch.setattr(port.System, attr, fault(orig)[1])
    # a window long enough for a whole batch on a loaded host: the check
    # compares a batch up to its last served token
    out = harness.run_cell(cell, 2 ** 35 + 1, 2.0, False, "cpu",
                           time.perf_counter(), home=home, spec=spec,
                           log=lambda msg: None)
    assert out["correct"] is False
    assert out["checks"]["max_logit_gap"]["value"] > testcells.LIMIT


def test_the_sound_path_is_correct_on_many_seeds(tiny):
    home, spec = tiny
    for seed in (7, 2 ** 33, 2 ** 62 + 5):
        for cell in sorted(testcells.CELLS):
            out = harness.run_cell(cell, seed, 0.2, False, "cpu",
                                   time.perf_counter(), home=home,
                                   spec=spec, log=lambda msg: None)
            assert out["correct"] is True, (cell, seed, out["checks"])
            torch.manual_seed(0)
