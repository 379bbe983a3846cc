"""The harness on the CPU: tiny cells run end to end through the same
code as the card's cells, files are found by their names, BENCHMARK.json
keeps to its contract, and the benchmark's process loads no JAX."""
from __future__ import annotations

import ast
import json
import pathlib
import re
import subprocess
import sys
import time

import pytest

from perfbench import harness, testcells
from perfbench.trace import Recorder

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture
def tiny(tmp_path):
    return testcells.make_home(tmp_path)


def _run(tiny, cell, traced=False, seed=2 ** 40 + 3, seconds=0.3):
    home, spec = tiny
    return harness.run_cell(cell, seed, seconds, traced, "cpu",
                            time.perf_counter(), home=home, spec=spec,
                            log=lambda msg: None)


@pytest.mark.parametrize("cell,e2e", [
    ("tiny.prefill", {"prefill_tok_per_s", "ttft_p90_ms", "setup_s"}),
    ("tiny.decode", {"decode_tok_per_s", "itl_p95_ms", "setup_s"})])
def test_a_tiny_cell_runs_and_is_correct(tiny, cell, e2e):
    # a window long enough for a few requests on a loaded host
    out = _run(tiny, cell, seconds=2.0)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert set(out["metrics"]) == e2e
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"
    check = out["checks"]["max_logit_gap"]
    assert 0 <= check["value"] <= check["limit"] == testcells.LIMIT


@pytest.mark.parametrize("cell", sorted(testcells.CELLS))
def test_a_traced_tiny_cell_gives_the_trace_keys(tiny, cell):
    out = _run(tiny, cell, traced=True)
    assert out["correct"] is True
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # the per-layer metrics only (the CPU has no device time: the
    # rooflines and MFU are absent, never 0)
    names = {m["name"] for m in harness.cell_metrics(tiny[1], cell, True)}
    assert set(out["metrics"]) <= names
    assert not {"prefill_mfu", "decode_mfu", "attn_roofline.prefill"} & set(
        out["metrics"])


def test_the_traced_window_ends_before_the_window(tiny, monkeypatch):
    from perfbench import trace
    monkeypatch.setattr(trace, "TRACE_SECONDS", 0.3)
    out = _run(tiny, "tiny.decode", traced=True, seconds=1.5)
    assert out["correct"] is True
    assert 0 < out["device"]["window_s"] < 1.0


def test_a_batch_cut_by_the_close_is_compared_to_its_last_token(tiny):
    home, spec = tiny
    mix = home / "mixes" / "tiny-decode.json"
    mix.write_text(json.dumps(dict(testcells.MIXES["tiny-decode"],
                                   output_tokens=2000)))
    cl = harness.load_cell("tiny.decode", home, spec)
    served = harness.serve_seed(cl, 2 ** 40 + 9, 0.5, "cpu",
                                Recorder(False))
    (rec,) = served["records"]
    served_tokens = len(rec.arrivals)
    assert 1 < served_tokens < 2000
    got = harness.readings(cl, 2 ** 40 + 9, "cpu", served)
    # every prompt position, then each served step's token
    assert got["positions"] == 2 * (16 + served_tokens - 1)
    assert got["max_logit_gap"] <= testcells.LIMIT


def _request(issued, arrivals, prompt_len=16, batch=4):
    from perfbench.check import Record
    from perfbench.traffic import Request
    rec = Record(Request(0, batch, prompt_len, len(arrivals)), issued)
    rec.arrivals = list(arrivals)
    return rec


@pytest.mark.parametrize("name", ["decode_mfu", "prefill_mfu"])
def test_host_clock_layer_metrics_read_the_untraced_rest(name):
    from types import SimpleNamespace
    # every step or prefill could take 10 ms at the least
    least = (0.0, 0.01 * 3e12)
    counts = SimpleNamespace(decode_step=lambda c, B, pos: least,
                             prefill=lambda c, B, S: least)
    peak = {"bf16_flops_per_s": 1e15, "hbm_bytes_per_s": 3e12}
    # 0.1 s a step or request untraced (to 1.0 s), 0.2 s traced after
    t = [0.1 * k for k in range(11)] + [1.0 + 0.2 * k for k in range(1, 6)]
    recs = ([_request(0.0, t)] if name == "decode_mfu" else
            [_request(a, [b], batch=1) for a, b in zip(t, t[1:])])
    read = harness.reader(HERE, name)

    def run(t_traced):
        return harness.Run("c", testcells.TINY, {}, counts, peak, 0.0, 0.0,
                           2.0, recs, None, t_traced)
    assert read(run(2.5)) == pytest.approx(100 * 15 * 0.01 / 2.0)
    assert read(run(1.05)) == pytest.approx(100 * 10 * 0.01 / 1.0)
    assert read(run(0.0)) is None


def test_attention_roofline_reads_the_calls_device_time():
    from types import SimpleNamespace
    from perfbench import counts
    peak = counts.peaks("NVIDIA H100 80GB HBM3")
    call = ((1, 2048, 32, 128), (1, 2048, 8, 128), 2, True, None)
    least = counts.least_seconds(*counts.attention(
        1, 2048, 2048, 32, 8, 128, 2), peak)
    read = harness.reader(HERE, "attn_roofline.prefill")

    def run(device_s):
        tr = SimpleNamespace(attention_calls=[call] * 40,
                             span_device_s={"flash_attention": device_s})
        return harness.Run("c", {}, {}, None, peak, 0.0, 0.0, 1.0, [], tr)
    assert read(run(40 * 4 * least)) == pytest.approx(25.0)
    assert read(run(0.0)) is None


def test_device_operations_belong_to_the_span_of_their_launch():
    from perfbench.trace import by_span
    spans = {"prefill": [(0, 100)], "flash_attention": [(10, 20)]}
    # (start, end, name, thread, correlation id, linked id) as read from
    # the profiler; a torch op's ids may collide with the runtime's
    host = [(12, 13, "cudaLaunchKernel", 1, 7, 0),
            (30, 31, "cudaLaunchKernel", 1, 8, 0),
            (50, 51, "aten::mm", 1, 9, 0)]
    dev = [(60, 90, "flash_attention_kernel", 2, 7, 0),   # launched at 12
           (91, 95, "gemm", 2, 8, 0),                      # launched at 30
           (15, 18, "copy", 2, 9, 0),                      # no CUDA call
           (96, 99, "fill", 2, 0, 0)]                      # none either
    launches, dev_time = by_span(host, dev, spans)
    assert dict(launches) == {"prefill": 4, "flash_attention": 2}
    assert dev_time["flash_attention"] == 30 + 3
    assert dev_time["prefill"] == 30 + 4 + 3 + 3


def test_files_added_to_a_copy_are_found_by_name(tiny):
    home, spec = tiny
    # the copy's own files are the benchmark's, unedited
    for path in HERE.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts:
            assert (home / path.relative_to(HERE)).read_bytes() == \
                path.read_bytes()
    # a new metric is one file and one entry
    (home / "metrics" / "prompt_tokens_seen.py").write_text(
        "def read(run):\n"
        "    return float(sum(r.req.prompt_len for r in run.records))\n")
    spec["end_to_end"].append({
        "name": "prompt_tokens_seen", "unit": "tokens", "better": "higher",
        "bound": 0.1, "source": "host_clock", "workloads": ["tiny.prefill"]})
    out = harness.run_cell("tiny.prefill", 5, 0.2, False, "cpu",
                           time.perf_counter(), home=home, spec=spec,
                           log=lambda msg: None)
    assert out["metrics"]["prompt_tokens_seen"]["value"] > 0


def test_a_cell_without_its_files_is_refused(tiny):
    home, spec = tiny
    (home / "mixes" / "tiny-decode.json").unlink()
    with pytest.raises(FileNotFoundError):
        harness.run_cell("tiny.decode", 5, 0.2, False, "cpu", 0.0,
                         home=home, spec=spec)


def test_benchmark_json_keeps_to_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["perfbench"]
    assert len(SPEC["command"]) <= 32 and SPEC["command"][1] == \
        "perfbench/run.py"
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    cfg_keys = {"name", "source", "file", "reduced", "why"}
    for c in SPEC["configs"]:
        assert set(c) == cfg_keys and NAME.match(c["name"])
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("perfbench/")
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
    names = [w["name"] for w in SPEC["workloads"]]
    assert len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in SPEC["workloads"]}
    assert len(pairs) == len(names)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert w["config"] in {c["name"] for c in SPEC["configs"]}
        assert (HERE / "mixes" / f"{w['traffic']}.json").is_file()
        assert (HERE / "workloads" / f"{w['name']}.json").is_file()
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", names)) <= set(names)
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in names:
        own = [m["name"] for m in harness.cell_metrics(SPEC, cell, False)]
        assert "setup_s" in own and len(own) >= 2
        assert harness.cell_metrics(SPEC, cell, True)
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_every_file_under_paths_is_named_from_name_characters():
    for path in HERE.rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_the_harness_process_holds_no_jax(tmp_path):
    # a fresh process: this one may hold the JAX package for other tests
    script = (
        "import sys, time\n"
        f"sys.path[0:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]\n"
        "import pathlib\n"
        "from perfbench import harness, testcells\n"
        f"home, spec = testcells.make_home(pathlib.Path({str(tmp_path)!r}))\n"
        "for cell in sorted(testcells.CELLS):\n"
        "    harness.run_cell(cell, 9, 0.2, cell.endswith('decode'), 'cpu',\n"
        "                     time.perf_counter(), home=home, spec=spec,\n"
        "                     log=lambda m: None)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=300, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]
                          .replace("'", '"')))
    assert "repro_torch" in tops and "perfbench" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.models", "reprox", "jaxtyping",
         "flaxen", "numpy"]) == []
    assert harness.forbidden_modules(
        ["repro.core", "jax.numpy", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_card_tests_decide_inside_a_fixture():
    """Every test that needs the card carries the ``cuda`` marker and asks
    for the ``card`` fixture; no test module asks CUDA anything while it
    is imported (the workers would collect different tests)."""
    for path in HERE.glob("test_*.py"):
        tree = ast.parse(path.read_text())
        tests = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
                 and n.name.startswith("test_")]
        at_import = [n for n in tree.body if not isinstance(
            n, (ast.FunctionDef, ast.ClassDef))]
        at_import += [d for fn in tests for d in fn.decorator_list]
        for node in at_import:
            assert "torch.cuda" not in ast.unparse(node), \
                (path.name, node.lineno)
        for fn in tests:
            marks = {ast.unparse(d) for d in fn.decorator_list}
            uses = {a.arg for a in fn.args.args}
            assert ("card" in uses) == ("pytest.mark.cuda" in marks), \
                (path.name, fn.name)
