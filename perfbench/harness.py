"""One run of one cell: set-up, the measured window, the check, and the
result line.

Set-up makes the weights on the card from the seed, builds the port's
model around them, and warms up every shape the cell's traffic uses (one
request of each prompt length, a few decode steps). The window then
serves the traffic in a closed loop for ``--seconds``: each request's
prefill (``serve.make_prefill_step``, through the kernels), the argmax of
its last position, its first token copied to the host, then each decode
step (``serve.make_serve_step``) and its tokens copied to the host, every
arrival stamped on the host clock. The window's close ends the loop: no
new request starts and no further step is taken. After the window the
program is freed and :mod:`perfbench.check` compares a sample of what it
served, up to each sequence's last served token, with the plain
reference. Every metric is read by its own ``metrics/<name>.py`` from
the run's record.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import pathlib
import sys
import time

import torch

from . import check, reference
from .port import System
from .trace import Recorder, summarize
from .traffic import Traffic
from .weights import make as make_weights

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level modules the benchmark's process may never hold
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DECODE_WARM_UP = 3


@dataclasses.dataclass
class Run:
    """What a metric reader gets: the cell's files, the card's peaks,
    the window on the host clock, every request's record, and the trace
    of a traced run. ``t_traced`` is where the profiler began to record
    (``t_end`` in an untraced run): the per-layer metrics timed on the
    host clock read the window before it."""
    cell: str
    config: dict
    mix: dict
    counts: object
    peaks: "dict | None"
    t_process: float
    t_start: float
    t_end: float
    records: list
    trace: object = None
    t_traced: "float | None" = None


def use_checkout_caches() -> None:
    """Every build and kernel cache in a fixed directory under the
    checkout's ``build/``, so that only a checkout's first run builds;
    called before anything touches CUDA."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(ROOT / "build" / sub)


def _json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def cell_entry(spec: dict, cell: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == cell:
            return w
    raise KeyError(f"no workload {cell!r} in BENCHMARK.json")


def cell_metrics(spec: dict, cell: str, traced: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end ones, or with
    ``traced`` its per-layer ones (those listing the cell, or without a
    list those moving one of its end-to-end metrics)."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def reader(home: pathlib.Path, name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = home / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench.metrics." + name.replace(".", "__"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _serve(system, req, prompt, rec, recorder, stop):
    """One request: its prefill, first token, then its decode steps while
    ``stop()`` is false."""
    with recorder.span("prefill"):
        logits, cache = system.prefill(prompt, req.max_seq)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        rec.served.append(tok.cpu())
    rec.arrivals.append(time.perf_counter())
    recorder.tick()
    # every returned position's greedy token, for the check alone: after
    # the first token has arrived and outside the prefill's span
    rec.argmax = logits.argmax(dim=-1)
    del logits
    for k in range(1, req.output_tokens):
        if stop():
            break
        with recorder.span("decode_step"):
            logits, cache = system.step(cache, tok, req.prompt_len + k - 1)
            tok = logits[:, -1:].argmax(dim=-1)
            del logits
            rec.served.append(tok.cpu())
        rec.arrivals.append(time.perf_counter())
        recorder.tick()


def warm_up(system, traffic) -> None:
    """Every shape of the cell's traffic once: a request of each prompt
    length, in the window's cache size, and a few of its decode steps."""
    for req in traffic.warm_up_requests():
        rec = check.Record(req, time.perf_counter())
        _serve(system, req, traffic.prompt(req), rec, Recorder(False),
               lambda rec=rec: len(rec.arrivals) > DECODE_WARM_UP)
    _sync(system.device)


def serve_window(system, traffic, seconds, recorder):
    """The measured window: (records, t_start, t_end)."""
    records = []
    t_end = float("inf")

    def stop():
        return time.perf_counter() >= t_end and not recorder.waiting

    recorder.start(seconds)
    t_start = time.perf_counter()
    t_end = t_start + seconds
    i = 0
    while time.perf_counter() < t_end or recorder.waiting:
        req = traffic.request(i)
        i += 1
        prompt = traffic.prompt(req)
        rec = check.Record(req, time.perf_counter())
        records.append(rec)
        _serve(system, req, prompt, rec, recorder, stop)
    _sync(system.device)
    recorder.stop()
    return records, t_start, t_end


@dataclasses.dataclass
class Cell:
    """A cell's files: its configuration, traffic mix and limits, and its
    family's reference and counts modules."""
    name: str
    config: dict
    mix: dict
    limits: dict
    ref: object
    counts: object


def load_cell(cell: str, home: pathlib.Path = HERE,
              spec: "dict | None" = None) -> Cell:
    spec = spec if spec is not None else _json(ROOT / "BENCHMARK.json")
    entry = cell_entry(spec, cell)
    c = _json(home / "configs" / f"{entry['config']}.json")
    return Cell(cell, c, _json(home / "mixes" / f"{entry['traffic']}.json"),
                _json(home / "workloads" / f"{cell}.json")["limits"],
                importlib.import_module(f"perfbench.reference.{c['family']}"),
                importlib.import_module(f"perfbench.counts.{c['family']}"))


def serve_seed(cell: Cell, seed: int, seconds: float, device,
               recorder: Recorder) -> dict:
    """Set-up and the window for one seed, then the sample the check
    compares; the program's state is freed before this returns."""
    device = torch.device(device)
    W = make_weights(cell.ref.weight_shapes(cell.config), seed, device)
    system = System(cell.config, W, device)
    traffic = Traffic(cell.mix, cell.config["vocab_size"], seed, device)
    if recorder.on:
        recorder.wrap_attention()
    try:
        warm_up(system, traffic)
        records, t_start, t_end = serve_window(system, traffic, seconds,
                                               recorder)
    finally:
        recorder.unwrap()
    if device.type == "cuda":
        kind = torch.cuda.get_device_name(device)
        mem_peak = torch.cuda.max_memory_allocated(device)
    else:
        kind, mem_peak = "cpu", 0
    samples = check.choose(records, cell.mix, seed)
    prompts = {rec.req.index: traffic.prompt(rec.req) for rec, _ in samples}
    del system, W
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"records": records, "t_start": t_start, "t_end": t_end,
            "kind": kind, "mem_peak": mem_peak, "samples": samples,
            "prompts": prompts}


def readings(cell: Cell, seed: int, device, served: dict,
             control: bool = False) -> dict:
    """The program's numbers compared (and with ``control`` the
    control's, under ``control.<name>``), on the weights made again from
    the seed."""
    if not served["samples"]:
        return {"max_logit_gap": float("inf")}
    reference.exact_fp32()
    W = make_weights(cell.ref.weight_shapes(cell.config), seed,
                     torch.device(device))
    args = (cell.ref, cell.config, W, served["samples"], served["prompts"])
    out = check.program_gap(*args)
    if control:
        out.update({f"control.{k}": v
                    for k, v in check.control_gap(*args).items()})
    return out


def run_cell(cell: str, seed: int, seconds: float, traced: bool, device,
             t_process: float, home: pathlib.Path = HERE,
             spec: "dict | None" = None, log=None) -> dict:
    """Run ``cell`` and return its result line (a dict)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    spec = spec if spec is not None else _json(ROOT / "BENCHMARK.json")
    cl = load_cell(cell, home, spec)
    recorder = Recorder(traced)
    served = serve_seed(cl, seed, seconds, device, recorder)
    t0 = time.perf_counter()
    tr = summarize(recorder.prof, recorder.attention_calls) if traced \
        else None
    if traced:
        log(f"trace: summarized in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    got = readings(cl, seed, device, served)
    log(f"check: {len(served['samples'])} sequences, "
        f"{got.get('positions', 0)} positions, {got.get('agree', 0)} on "
        f"the reference's argmax, {time.perf_counter() - t0:.1f} s")
    checks = {name: {"value": got[name], "limit": float(lim)}
              for name, lim in cl.limits.items()}
    correct = bool(served["samples"]) and all(
        v["value"] <= v["limit"] for v in checks.values())

    from .counts import peaks
    records = served["records"]
    run = Run(cell, cl.config, cl.mix, cl.counts, peaks(served["kind"]),
              t_process, served["t_start"], served["t_end"], records, tr,
              recorder.since if traced else served["t_end"])
    metrics = {}
    for m in cell_metrics(spec, cell, traced):
        value = reader(home, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = sum(r.req.batch for r in records)
    dev = {"platform": "gpu" if served["kind"] != "cpu" else "cpu",
           "kind": served["kind"], "count": 1,
           "memory_peak_bytes": int(served["mem_peak"])}
    out = {"correct": correct, "attempted": attempted,
           "failed": 0 if served["samples"] else attempted,
           "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        out["breakdown"] = {"device_ops": tr.device_ops,
                            "idle_gaps": tr.idle_gaps}
    out["checks"] = checks
    return out


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: the
    modules this process has loaded), each compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv, t_process: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    use_checkout_caches()
    spec = _json(ROOT / "BENCHMARK.json")
    chips = cell_entry(spec, args.workload)["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"this machine has {cards}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   "cuda:0", t_process, spec=spec)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process holds {found} (the JAX package or "
              "JAX itself): no result", file=sys.stderr)
        return 3
    for name, v in out["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
