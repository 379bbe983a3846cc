"""The port's examples against the reference's, on the CPU.

``repro_torch.examples.quickstart`` and ``.schedule_jobs`` are run with
``device="cpu"`` beside the reference's ``examples/quickstart.py`` and
``examples/schedule_jobs.py`` (loaded with importlib; their
``run_schedule`` is wrapped to keep each policy's result, and
``schedule_jobs``' module-level ``RESULTS`` is pointed at a temporary
file). Each policy's schedule must equal the reference's record for
record (every behaviour field), with the same total energy, misses and
makespan, and the printed lines must be the reference's. The service's
summary line is the exception: the port's ``rows=`` also counts the one-
row point predictions, which it evaluates through the service's device
path (``PredictionService._predict``) and the reference does not.
"""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import pathlib
import sys

import pytest

from repro_torch.examples import quickstart, schedule_jobs
from test_torch_schedule import _fields

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _reference(name: str):
    """The reference's ``examples/<name>.py`` as a fresh module whose
    ``run_schedule`` records each policy's result in ``mod.got``."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.got = {}
    inner = mod.run_schedule

    def run_schedule(jobs, policy, *a, **kw):
        mod.got[policy] = inner(jobs, policy, *a, **kw)
        return mod.got[policy]
    mod.run_schedule = run_schedule
    return mod


def _stdout(fn, *a, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **kw)
    return out, buf.getvalue().splitlines()


def _same_runs(port: dict, ref: dict):
    assert list(port) == list(ref)
    for policy in ref:
        p, r = port[policy], ref[policy]
        assert len(p.records) == len(r.records) > 0, policy
        assert [_fields(x) for x in p.records] == \
            [_fields(x) for x in r.records], policy
        assert (p.total_energy, p.misses, p.makespan) == \
            (r.total_energy, r.misses, r.makespan), policy


def test_quickstart_equals_reference():
    ref = _reference("quickstart")
    _, ref_lines = _stdout(ref.main)
    port, port_lines = _stdout(quickstart.run, "cpu")
    _same_runs(port, ref.got)
    assert port_lines == ref_lines
    assert list(port) == ["mc", "dc", "d-dvfs"]


def _schedule_jobs_pair(tmp_path, monkeypatch, rows=None, steps=20):
    """The reference's ``schedule_jobs.main`` and the port's run on the
    same dry-run file (``rows``; absent when None)."""
    path = tmp_path / "dryrun.json"
    if rows is not None:
        path.write_text(json.dumps(rows))
    ref = _reference("schedule_jobs")
    monkeypatch.setattr(ref, "RESULTS", str(path))
    monkeypatch.setattr(sys, "argv", ["schedule_jobs.py", "--steps",
                                      str(steps)])
    _, ref_lines = _stdout(ref.main)
    apps = schedule_jobs.arch_apps(steps, path)[:16]
    ref_apps = ref.arch_apps(steps)[:16]
    assert [vars(a) for a in apps] == [vars(a) for a in ref_apps]
    (port, service), port_lines = _stdout(schedule_jobs.run, apps, steps,
                                          "cpu")
    _same_runs(port, ref.got)
    summary = [i for i, s in enumerate(ref_lines)
               if "prediction service" in s]
    assert len(summary) == 1
    keep = [i for i in range(len(ref_lines)) if i not in summary]
    assert [port_lines[i] for i in keep] == [ref_lines[i] for i in keep]
    assert service.stats.table_builds == int(
        ref_lines[summary[0]].split("table_builds=")[1].split()[0])
    return port, apps


def test_schedule_jobs_built_in_profiles_equal_reference(tmp_path,
                                                         monkeypatch):
    port, apps = _schedule_jobs_pair(tmp_path, monkeypatch)
    assert [a.name for a in apps] == [r[0] for r in schedule_jobs.BUILT_IN]
    assert list(port) == ["mc", "dc", "d-dvfs", "oracle"]


# dry-run rows as both packages write them: ok cells with a roofline, a
# skipped and an errored one that must be left out
DRYRUN_ROWS = [
    {"arch": "smollm-360m", "shape": "train_4k", "status": "ok",
     "roofline": {"flops": 1.930e13, "bytes_accessed": 1.327e12,
                  "coll_bytes_modeled": 5.302e10}},
    {"arch": "qwen2.5-14b", "shape": "long_500k", "status": "skipped",
     "reason": "quadratic attention"},
    {"arch": "mixtral-8x22b", "shape": "decode_32k", "status": "ok",
     "roofline": {"flops": 5.2e11, "bytes_accessed": 3.1e11,
                  "coll_bytes_modeled": 2.6e10}},
    {"arch": "kimi-k2-1t-a32b", "shape": "prefill_32k", "status": "error",
     "error": "RuntimeError: out of memory"},
    {"arch": "falcon-mamba-7b", "shape": "prefill_32k", "status": "ok",
     "roofline": {"flops": 2.4e14, "bytes_accessed": 4.4e12,
                  "coll_bytes_modeled": 7.9e10}},
]


@pytest.mark.parametrize("steps", [20, 5])
def test_schedule_jobs_dry_run_rows_equal_reference(tmp_path, monkeypatch,
                                                    steps):
    _, apps = _schedule_jobs_pair(tmp_path, monkeypatch, DRYRUN_ROWS,
                                  steps)
    assert [a.name for a in apps] == [
        "smollm-360m/train_4k", "mixtral-8x22b/decode_32k",
        "falcon-mamba-7b/prefill_32k"]
    assert [a.kind for a in apps] == ["train", "decode", "decode"]
    assert apps[0].flops == 1.930e13 * steps


def test_arch_apps_default_file_is_the_reference_s(tmp_path):
    """Both packages look for the same files, relative to the checkout."""
    ref = _reference("schedule_jobs")
    assert pathlib.Path(ref.RESULTS).resolve().parent == \
        schedule_jobs.default_results().parent
    assert schedule_jobs.default_results().name in (
        "dryrun_final.json", "dryrun_single.json")


def test_schedule_jobs_main_prints_the_reference_s_lines(tmp_path,
                                                        monkeypatch):
    path = tmp_path / "none.json"
    ref = _reference("schedule_jobs")
    monkeypatch.setattr(ref, "RESULTS", str(path))
    monkeypatch.setattr(sys, "argv", ["schedule_jobs.py", "--steps", "5",
                                      "--jobs", "3"])
    _, ref_lines = _stdout(ref.main)
    rc, port_lines = _stdout(schedule_jobs.main, [
        "--steps", "5", "--jobs", "3", "--results", str(path),
        "--device", "cpu"])
    assert rc == 0
    assert [s for s in port_lines if "prediction service" not in s] == \
        [s for s in ref_lines if "prediction service" not in s]
