"""The traced run's reading of the card's timeline.

``torch.profiler`` (CUPTI) records the end of the window (the traced
window: its last ``TRACE_SHARE``, at most ``TRACE_SECONDS``; the profiler
is stopped, which takes tens of seconds, once the window has closed)
with the harness's spans
around the calls into the program: ``perfbench.prefill`` (one request's
prefill up to its first token on the host), ``perfbench.decode_step``
(one step up to its tokens on the host) and ``perfbench.flash_attention``
(the port's ``kernels.ops.flash_attention``, wrapped at run time from
here, with each call's shapes kept). The events stay in memory; nothing
is exported. :func:`summarize` reduces them to what the metrics read.
The profiler records every host op, which slows the host's dispatch
(about twice a decode step's host time on the H100); the shares of
device idle time read from the trace include that cost, and the metrics
timed on the host clock read the untraced part of the window before it.

A device operation (kernel, copy or fill) belongs to the span in which the
CUDA call that launched it (``cudaLaunchKernel``, ``cuLaunchKernelEx``,
``cudaMemcpyAsync``, ...) started: the two share the runtime's
correlation id. One the trace holds no such call for belongs to the span
its start falls in.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from collections import defaultdict

import torch

PREFIX = "perfbench."
TOP = 10
#: the traced window's share of the window, and its longest length:
#: some hundred decode steps or requests, after an untraced part
TRACE_SHARE = 0.4
TRACE_SECONDS = 20.0


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    #: per span name: host intervals (s), device busy inside them (s),
    #: device operations launched inside them, and their device time (s)
    spans: dict
    span_busy_s: dict
    span_launches: dict
    span_device_s: dict
    #: the wrapped attention calls: (q shape, k shape, itemsize, causal,
    #: window), one tuple a call inside the traced window
    attention_calls: list
    device_ops: list
    idle_gaps: list


class Recorder:
    """Spans, the attention wrapper and the profiler of a traced run: the
    profiler runs over the window's last ``TRACE_SHARE``, at most
    ``TRACE_SECONDS`` (the traced window; the part before it runs
    untraced, so the trace stays a bounded size). With ``on=False`` all
    of it is a no-op."""

    def __init__(self, on: bool):
        self.on = on
        self.attention_calls: list = []
        self.prof = None
        #: host time the traced window began, once it has
        self.since = None
        #: host time the traced window ended, once it has
        self.until = None
        self._start_at = None
        self._spans = 0
        self._restore = None

    @property
    def tracing(self) -> bool:
        return self.prof is not None and self.until is None

    @property
    def waiting(self) -> bool:
        """A traced run whose trace holds no span yet: the window is held
        open for one more request or step."""
        return self.on and not self._spans

    def span(self, name: str):
        if not self.tracing:
            return contextlib.nullcontext()
        self._spans += 1
        return torch.profiler.record_function(PREFIX + name)

    def wrap_attention(self) -> None:
        from repro_torch.kernels import ops
        orig = ops.flash_attention

        def flash_attention(q, k, v, causal=True, window=None):
            if not self.tracing:
                return orig(q, k, v, causal=causal, window=window)
            self.attention_calls.append((tuple(q.shape), tuple(k.shape),
                                         q.element_size(), causal, window))
            with self.span("flash_attention"):
                return orig(q, k, v, causal=causal, window=window)

        ops.flash_attention = flash_attention
        self._restore = lambda: setattr(ops, "flash_attention", orig)

    def unwrap(self) -> None:
        if self._restore is not None:
            self._restore()
            self._restore = None

    def start(self, seconds: float) -> None:
        """A window of ``seconds`` begins now."""
        if self.on:
            self._start_at = time.perf_counter() + seconds - min(
                TRACE_SECONDS, TRACE_SHARE * seconds)

    def tick(self) -> None:
        """After each request or step: begin the traced window once the
        untraced part has run its length."""
        if self.on and self.prof is None and \
                time.perf_counter() >= self._start_at:
            from torch.profiler import ProfilerActivity, profile
            self.since = time.perf_counter()
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()

    def stop(self) -> None:
        """After the window has closed."""
        if self.tracing:
            self.until = time.perf_counter()
            self.prof.stop()


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(merged, lo, hi) -> float:
    """Length of the union ``merged`` (sorted, disjoint) inside [lo, hi]."""
    i = bisect.bisect_left(merged, [lo, lo])
    i = max(0, i - 1)
    total = 0.0
    while i < len(merged) and merged[i][0] < hi:
        s, e = merged[i]
        total += max(0.0, min(e, hi) - max(s, lo))
        i += 1
    return total


def _inside(intervals, starts, t) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and intervals[i][1] >= t


def _events(prof):
    """(host ops, device operations) of the profile as (start_ns, end_ns,
    name, thread, correlation id, linked correlation id) tuples, read from
    the profiler's raw records (building its per-event Python objects
    takes minutes for a window of decode steps)."""
    from torch.autograd import DeviceType
    host, dev = [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = ev.start_ns()
        row = (start, start + ev.duration_ns(), name, ev.start_thread_id(),
               ev.correlation_id(), ev.linked_correlation_id())
        if ev.device_type() == DeviceType.CPU:
            host.append(row)
        elif ev.device_type() == DeviceType.CUDA and row[1] > row[0] \
                and not name.startswith(PREFIX):
            # (a span's mark on the device's lane is no operation)
            dev.append(row)
    return host, dev


def by_span(host, dev, spans) -> tuple[dict, dict]:
    """({span: device operations launched inside it}, {span: their device
    time, ns}) for the rows of :func:`_events` and the spans' sorted host
    intervals."""
    # the CUDA call that launched each device operation, by the runtime's
    # correlation id (the profiler's link to the torch op that launched it
    # is missing for a kernel a C++ extension launches)
    launched = {h[4]: h[0] for h in host if h[4] and h[2].startswith("cu")}
    starts = {k: [s for s, _ in v] for k, v in spans.items()}
    launches, dev_time = defaultdict(int), defaultdict(float)
    for s, e, _, _, corr, _ in dev:
        t = launched.get(corr, s)
        for k, v in spans.items():
            if _inside(v, starts[k], t):
                launches[k] += 1
                dev_time[k] += e - s
    return launches, dev_time


def summarize(prof, attention_calls) -> Trace:
    host, dev = _events(prof)
    ours = [h for h in host if h[2].startswith(PREFIX)]
    if not ours:
        raise RuntimeError("the trace holds none of the harness's spans")
    main = ours[0][3]
    spans = defaultdict(list)
    for s, e, name, *_ in ours:
        spans[name[len(PREFIX):]].append((s, e))
    for v in spans.values():
        v.sort()
    lo = min(s for v in spans.values() for s, _ in v)
    hi = max(e for v in spans.values() for _, e in v)
    busy = _merge([(max(s, lo), min(e, hi)) for s, e, *_ in dev
                   if e > lo and s < hi])
    launches, dev_time = by_span(host, dev, spans)
    ops = defaultdict(float)
    for s, e, name, *_ in dev:
        ops[name] += e - s
    span_busy = {k: sum(_overlap(busy, s, e) for s, e in v) / 1e9
                 for k, v in spans.items()}
    return Trace(
        window_s=(hi - lo) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        spans={k: [(s / 1e9, e / 1e9) for s, e in v]
               for k, v in spans.items()},
        span_busy_s=span_busy,
        span_launches=dict(launches),
        span_device_s={k: v / 1e9 for k, v in dev_time.items()},
        attention_calls=list(attention_calls),
        device_ops=[[n, t / 1e9] for n, t in sorted(
            ops.items(), key=lambda kv: -kv[1])[:TOP]],
        idle_gaps=_idle_gaps(busy, [h for h in host if h[3] == main],
                             spans))


def _idle_gaps(busy, cpu, spans) -> list:
    """The device's idle time by what the host was doing: each gap
    between device operations, named by the harness span and the
    innermost host op around the gap's middle, summed by name; the
    ``TOP`` largest."""
    host = sorted((s, e, name) for s, e, name, *_ in cpu
                  if not name.startswith(PREFIX))
    hstarts = [h[0] for h in host]
    parent, stack = [], []          # host ops nest: each op's enclosing one
    for i, (s, _, _) in enumerate(host):
        while stack and host[stack[-1]][1] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(i)
    span_list = sorted((s, e, k) for k, v in spans.items() for s, e in v
                       if k != "flash_attention")
    sstarts = [s[0] for s in span_list]
    out = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        i = bisect.bisect_right(sstarts, mid) - 1
        where = (span_list[i][2] if i >= 0 and span_list[i][1] >= mid
                 else "between")
        j = bisect.bisect_right(hstarts, mid) - 1
        while j >= 0 and host[j][1] < mid:
            j = parent[j]
        op = host[j][2] if j >= 0 else "python"
        out[f"{where}/{op}"] += (s1 - e0) / 1e9
    return [[n, t] for n, t in sorted(out.items(),
                                      key=lambda kv: -kv[1])[:TOP]]
