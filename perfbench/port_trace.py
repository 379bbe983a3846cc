"""The port's own spans and counters (``repro_torch.obs``) laid on a
traced run's timeline.

    python3 perfbench/port_trace.py --workload <cell> --seed <n> \
        --seconds <s> >> <file>.jsonl

runs one cell as ``run.py --trace 1`` does (set-up, warm-up, the window
with ``torch.profiler`` over its last part) with the port's recorder on,
and prints one JSON line: the traced run's per-layer metrics as
``metrics/`` reads them, the four readings of the port's spans below,
each port span's host time a step (before the profiler starts) and
device time and launches a step (inside the traced window),
``idle_by_span``, the share of the steps' device time launched inside a
port span, and how long each reading took. No correctness check runs.
The recorder takes the roots alone over the first half of the untraced
part (and at least the window's first three requests or steps), so that
their lengths carry no other span's cost, then every span.
:func:`run` goes once ``run.py`` itself switches the recorder on; the
readers stay for it.

A device operation belongs to the innermost port span whose host
interval holds the CUDA call that launched it (the runtime's
correlation id, as :func:`perfbench.trace.by_span`); the port's stamps
(``perf_counter``) are shifted onto the profiler's clock (Unix epoch) by
the recorder's ``epoch_offset_ns``. The readings:

* ``dispatch_ms_per_step.decode``: the median host length of the
  ``serve.decode_step`` roots recorded alone (the port's dispatch of a
  step, no other span on, profiler off);
* ``attend_ms_per_step.decode``: device ms a traced decode step of the
  operations launched inside ``attention.attend``;
* ``attend_masked_share.decode``: % of the decode attention's cache
  positions that its mask drops, ``100 (1 - live / attended)``;
* ``elementwise_share.prefill``: % of the traced prefills' device time
  launched inside ``norm`` and ``attention.rope``.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import pathlib
import statistics
import sys
import time
from collections import defaultdict

if __name__ == "__main__":
    T_PROCESS = time.perf_counter()
    _ROOT = pathlib.Path(__file__).resolve().parent.parent
    sys.path[0:1] = [str(_ROOT), str(_ROOT / "src")]

import torch  # noqa: E402

from perfbench import harness, trace  # noqa: E402

DECODE, PREFILL = "serve.decode_step", "serve.prefill"
#: the harness's spans around a step and a prefill
STEPS = ("decode_step", "prefill")
#: the port spans around the prefill's fp32 elementwise work
ELEMENTWISE = ("norm", "attention.rope")


@dataclasses.dataclass
class PortTrace:
    """Per (root name, span name): ``host_ns`` and ``self_host_ns`` the
    spans' summed host length, whole and less their child spans', over
    the roots recorded with their children before the profiler started
    (``host_roots`` of them);
    ``device_ns`` and ``launches`` of the operations launched anywhere
    inside the spans, ``self_device_ns`` of those launched with the span
    innermost, over the roots inside the traced window (``roots``).
    ``covered``: the share of the device time launched inside the
    harness's steps that a port span holds; ``idle_by_span``: idle
    seconds inside the harness's steps by the innermost port span around
    each gap's middle (``harness`` outside any), the ``TOP`` largest."""
    host_roots: dict
    host_ns: dict
    self_host_ns: dict
    roots: dict
    device_ns: dict
    self_device_ns: dict
    launches: dict
    covered: "float | None"
    idle_by_span: list


class _Tree:
    """The drained spans on the profiler's clock, for lookups by time."""

    def __init__(self, spans):
        off = spans.epoch_offset_ns
        self.start = [s + off for s in spans.start]
        self.end = [e + off for e in spans.end]
        self.parent = spans.parent
        self.name = [spans.named(i) for i in range(len(spans))]
        self.rooti = spans.root
        self.root = [self.name[r] for r in spans.root]
        self.lone = lone_roots(spans)

    def innermost(self, t) -> int:
        """The innermost span holding time ``t``, or -1. Spans nest and
        are numbered in the order they opened, so it is the last opened
        before ``t`` or one of its ancestors."""
        i = bisect.bisect_right(self.start, t) - 1
        while i >= 0 and self.end[i] < t:
            i = self.parent[i]
        return i


def _host(tree: _Tree, until) -> tuple[dict, dict, dict]:
    """(roots, host ns, self host ns) by (root, name) over the roots
    recorded with their children that ended before ``until`` (epoch
    ns)."""
    roots, host, own = defaultdict(int), defaultdict(int), defaultdict(int)
    ok = [False] * len(tree.start)
    for i, p in enumerate(tree.parent):
        ok[i] = ok[p] if p >= 0 else (tree.end[i] < until
                                      and not tree.lone[i])
        if not ok[i]:
            continue
        key = (tree.root[i], tree.name[i])
        length = tree.end[i] - tree.start[i]
        host[key] += length
        own[key] += length
        if p >= 0:
            own[(tree.root[p], tree.name[p])] -= length
        else:
            roots[tree.name[i]] += 1
    return dict(roots), dict(host), dict(own)


def read(host, dev, spans, since_ns) -> PortTrace:
    """The port's spans ``spans`` (``obs.drain()``) on the profile whose
    rows :func:`perfbench.trace._events` gives (``host``, ``dev``); the
    profiler started at ``since_ns`` (epoch)."""
    tree = _Tree(spans)
    host_roots, host_ns, self_host = _host(tree, since_ns)
    launched = {h[4]: h[0] for h in host if h[4] and h[2].startswith("cu")}
    steps = sorted((s, e) for s, e, name, *_ in host
                   if name[len(trace.PREFIX):] in STEPS
                   and name.startswith(trace.PREFIX))
    starts = [s for s, _ in steps]
    n = len(tree.start)
    own, count = [0] * n, [0] * n
    inside = covered = 0
    for s, e, _, _, corr, _ in dev:
        t = launched.get(corr, s)
        i = tree.innermost(t)
        if trace._inside(steps, starts, t):
            inside += e - s
            covered += (e - s) if i >= 0 else 0
        if i >= 0:
            own[i] += e - s
            count[i] += 1
    # a span's whole: its own and its children's (opened after it)
    whole, launches = own[:], count[:]
    for i in range(n - 1, -1, -1):
        p = tree.parent[i]
        if p >= 0:
            whole[p] += whole[i]
            launches[p] += launches[i]
    # summed by (root, name) over the roots wholly in the traced window
    lo, hi = (steps[0][0], max(e for _, e in steps)) if steps else (0, 0)
    roots = defaultdict(int)
    by = (defaultdict(int), defaultdict(int), defaultdict(int))
    for i in range(n):
        r = tree.rooti[i]
        if not lo <= tree.start[r] <= tree.end[r] <= hi:
            continue
        if i == r:
            roots[tree.name[i]] += 1
        key = (tree.root[i], tree.name[i])
        for acc, v in zip(by, (whole, own, launches)):
            acc[key] += v[i]
    busy = trace._merge([(max(s, lo), min(e, hi)) for s, e, *_ in dev
                         if e > lo and s < hi])
    return PortTrace(host_roots, host_ns, self_host, dict(roots),
                     dict(by[0]), dict(by[1]), dict(by[2]),
                     covered / inside if inside else None,
                     idle_by_span(busy, tree, steps, starts))


def idle_by_span(busy, tree: _Tree, steps, starts) -> list:
    """The gaps between the device's busy intervals whose middle falls in
    one of the harness's ``steps``, in seconds summed by the innermost
    port span around the middle (``harness`` outside any); the ``TOP``
    largest."""
    out = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        if not trace._inside(steps, starts, mid):
            continue
        i = tree.innermost(mid)
        out[tree.name[i] if i >= 0 else "harness"] += (s1 - e0) / 1e9
    return [[n, t] for n, t in sorted(out.items(),
                                      key=lambda kv: -kv[1])[:trace.TOP]]


def lone_roots(spans) -> list:
    """For each span: whether it is a root holding no other span (one
    recorded while ``obs.enable`` took the roots alone)."""
    lone = [p < 0 for p in spans.parent]
    for p in spans.parent:
        if p >= 0:
            lone[p] = False
    return lone


def dispatch_ms_per_step(spans, until_ns) -> "float | None":
    """Median host ms of the ``serve.decode_step`` roots of ``spans``
    recorded alone that ended before ``until_ns`` (epoch)."""
    off = spans.epoch_offset_ns
    lone = lone_roots(spans)
    lengths = [spans.end[i] - spans.start[i] for i in range(len(spans))
               if lone[i] and spans.named(i) == DECODE
               and spans.end[i] + off < until_ns]
    return 1e-6 * statistics.median(lengths) if lengths else None


def attend_ms_per_step(pt: PortTrace) -> "float | None":
    n = pt.roots.get(DECODE, 0)
    t = pt.device_ns.get((DECODE, "attention.attend"))
    return 1e-6 * t / n if n and t else None


def attend_masked_share(counts: dict) -> "float | None":
    seen = counts.get("attention.positions_attended")
    if not seen:
        return None
    return 100.0 * (1.0 - counts["attention.positions_live"] / seen)


def elementwise_share(pt: PortTrace) -> "float | None":
    total = pt.device_ns.get((PREFILL, PREFILL))
    if not total:
        return None
    return 100.0 * sum(pt.device_ns.get((PREFILL, k), 0)
                       for k in ELEMENTWISE) / total


def readings(pt: PortTrace, spans, since_ns) -> dict:
    """The four readings that are there (module docstring)."""
    out = {"dispatch_ms_per_step.decode": dispatch_ms_per_step(
               spans, since_ns),
           "attend_ms_per_step.decode": attend_ms_per_step(pt),
           "attend_masked_share.decode": attend_masked_share(spans.counts),
           "elementwise_share.prefill": elementwise_share(pt)}
    return {k: v for k, v in out.items() if v is not None}


def by_layer(pt: PortTrace) -> dict:
    """{root: {span: [host ms, self host ms, device ms, self device ms,
    launches], a root each}}."""
    out = {}
    for root in set(pt.host_roots) | set(pt.roots):
        nh, nd = pt.host_roots.get(root, 0), pt.roots.get(root, 0)
        names = {k for r, k in (*pt.host_ns, *pt.device_ns) if r == root}
        out[root] = {k: [
            1e-6 * pt.host_ns.get((root, k), 0) / nh if nh else None,
            1e-6 * pt.self_host_ns.get((root, k), 0) / nh if nh else None,
            1e-6 * pt.device_ns.get((root, k), 0) / nd if nd else None,
            1e-6 * pt.self_device_ns.get((root, k), 0) / nd if nd else None,
            pt.launches.get((root, k), 0) / nd if nd else None]
            for k in sorted(names)}
    return out


def spans_a_root(spans) -> dict:
    """{root name: spans under a root of that name, itself included},
    over the roots recorded with their children."""
    lone = lone_roots(spans)
    under, roots = defaultdict(int), defaultdict(int)
    for i, r in enumerate(spans.root):
        if not lone[r]:
            under[spans.named(r)] += 1
            roots[spans.named(r)] += i == r
    return {k: n / roots[k] for k, n in under.items()}


class _Recorder(trace.Recorder):
    """The harness's recorder of a traced run, which also switches the
    port's recorder from its roots alone to every span halfway through
    the untraced part, once ``ALONE`` requests or steps have run."""
    ALONE = 3

    def __init__(self, obs):
        super().__init__(True)
        self._obs = obs
        self._every_at = None
        self._ticks = 0

    def start(self, seconds: float) -> None:
        now = time.perf_counter()
        super().start(seconds)
        self._every_at = now + (self._start_at - now) / 2
        self._obs.enable((DECODE, PREFILL))

    def tick(self) -> None:
        self._ticks += 1
        if self._every_at is not None and self._ticks >= self.ALONE and \
                time.perf_counter() >= self._every_at:
            self._every_at = None
            self._obs.enable()
        super().tick()


def run(cell: str, seed: int, seconds: float, device, t_process: float,
        home: pathlib.Path = harness.HERE, spec: "dict | None" = None,
        log=None) -> dict:
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    spec = spec if spec is not None else harness._json(
        harness.ROOT / "BENCHMARK.json")
    from repro_torch import obs
    cl = harness.load_cell(cell, home, spec)
    device = torch.device(device)
    W = harness.make_weights(cl.ref.weight_shapes(cl.config), seed, device)
    system = harness.System(cl.config, W, device)
    traffic = harness.Traffic(cl.mix, cl.config["vocab_size"], seed, device)
    harness.warm_up(system, traffic)
    out = {"cell": cell, "seed": seed}
    recorder = _Recorder(obs)
    recorder.wrap_attention()
    try:
        records, t_start, t_end = harness.serve_window(
            system, traffic, seconds, recorder)
    finally:
        obs.disable()
        recorder.unwrap()
    spans = obs.drain()
    t0 = time.perf_counter()
    tr = trace.summarize(recorder.prof, recorder.attention_calls)
    out["summarize_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    host, dev = trace._events(recorder.prof)
    out["events_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    since = int(recorder.since * 1e9) + spans.epoch_offset_ns
    pt = read(host, dev, spans, since)
    got = readings(pt, spans, since)
    out["port_read_s"] = time.perf_counter() - t0
    kind = (torch.cuda.get_device_name(device)
            if device.type == "cuda" else "cpu")
    from perfbench.counts import peaks
    hrun = harness.Run(cell, cl.config, cl.mix, cl.counts, peaks(kind),
                       t_process, t_start, t_end, records, tr,
                       recorder.since)
    metrics = {}
    for m in harness.cell_metrics(spec, cell, True):
        value = harness.reader(home, m["name"])(hrun)
        if value is not None:
            metrics[m["name"]] = value
    out.update(device=kind, metrics=metrics, port=got,
               spans_a_root=spans_a_root(spans),
               counts=spans.counts, covered=pt.covered,
               idle_by_span=pt.idle_by_span, by_layer=by_layer(pt),
               idle_gaps=tr.idle_gaps, device_ops=tr.device_ops,
               busy_s=tr.busy_s, window_s=tr.window_s)
    log(f"port_trace: summarize {out['summarize_s']:.1f} s, events "
        f"{out['events_s']:.1f} s, port spans {out['port_read_s']:.1f} s, "
        f"{len(spans)} spans")
    return out


def main(argv, t_process: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="perfbench/port_trace.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    harness.use_checkout_caches()
    if not torch.cuda.is_available():
        print("port_trace: needs a CUDA card", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = run(args.workload, args.seed, args.seconds, "cuda:0", t_process)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_PROCESS))
