"""Spans and counters of the serving path, kept in memory.

Off by default. :func:`enable` and :func:`disable` switch recording for
the whole process; while it is off, :func:`span` returns one shared no-op
context manager and :func:`count` returns at once, each after a single
check of the module flag ``on``. ``enable(names)`` records the spans of
those names alone (the roots, say, so that their lengths carry no other
span's cost); the rest stay no-ops.

While on, a span appends its name and start, then its end, to one flat
buffer on ``time.perf_counter_ns()``'s clock; counters sum what the code
counted. :func:`drain` hands both over and empties the buffer. There each
span carries its name, start and end, the index of its parent (the span
open around it, or -1) and the index of its root (the outermost span open
around it, itself for a root). A root is one ``serve.prefill`` or one
``serve.decode_step`` call, so every span of one step shares its root's
index. Nothing is written anywhere.

A span or counter makes no tensor, calls no CUDA API and never waits for
the device: a span's length is host time, the time to dispatch the work
inside it. Under a CUDA graph a span would run once, at capture.

The stamps are on ``perf_counter``'s clock; :func:`epoch_offset_ns` gives
Unix-epoch ns minus ``perf_counter_ns``, the shift onto the clock
``torch.profiler``'s events carry. Recording is for one thread.
"""
from __future__ import annotations

import dataclasses
import time

#: the one check a span and a counter make while recording is off
on = False
_now = time.perf_counter_ns
_PAIRS = 7
#: (name, start) as a span opens, (end, None) as it closes
_events: list = []
_counts: dict = {}
_offset = None
#: the names recorded, or None: every name
_only = None


class _Off:
    """The no-op context manager every span returns while off. Its
    methods are static, so ``with`` binds no method object to call them
    (half the cost of plain methods)."""
    __slots__ = ()

    @staticmethod
    def __enter__():
        return None

    @staticmethod
    def __exit__(typ, val, tb):
        return False


class _Span:
    """Span ``name`` while on; holds no state of a call, so one serves
    every span of its name."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _events.append(self.name)
        _events.append(_now())

    def __exit__(self, typ, val, tb):
        _events.append(_now())
        _events.append(None)
        return False


_OFF = _Off()
_SPANS: dict = {}


def span(name: str):
    """A context manager timing the code inside it as span ``name``."""
    if not on:
        return _OFF
    s = _SPANS.get(name)
    if s is None:
        s = _SPANS[name] = (_Span(name) if _only is None or name in _only
                            else _OFF)
    return s


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name``."""
    if on:
        _counts[name] = _counts.get(name, 0) + n


@dataclasses.dataclass
class Spans:
    """What :func:`drain` hands over. Span ``i`` is named
    ``names[name[i]]``, ran from ``start[i]`` to ``end[i]`` (ns on
    ``perf_counter``'s clock) inside span ``parent[i]`` (-1: none) and
    root ``root[i]``, numbered in the order they opened; ``counts`` sums
    each counter; ``epoch_offset_ns`` as :func:`epoch_offset_ns`."""
    names: list
    name: list
    start: list
    end: list
    parent: list
    root: list
    counts: dict
    epoch_offset_ns: int

    def __len__(self) -> int:
        return len(self.start)

    def named(self, i: int) -> str:
        return self.names[self.name[i]]


def _measure_offset() -> int:
    """Median over a few back-to-back readings of Unix-epoch ns minus
    ``perf_counter_ns`` (each epoch reading against the middle of the two
    ``perf_counter`` readings around it)."""
    out = []
    for _ in range(_PAIRS):
        a = time.perf_counter_ns()
        e = time.time_ns()
        b = time.perf_counter_ns()
        out.append(e - (a + b) // 2)
    return sorted(out)[_PAIRS // 2]


def enable(names=None) -> None:
    """Start recording the spans named in ``names`` (default: every
    span), and measure the clock offset. Counters count either way."""
    global on, _offset, _only
    _only = None if names is None else frozenset(names)
    _SPANS.clear()
    _offset = _measure_offset()
    on = True


def disable() -> None:
    """Stop recording; what was recorded stays for :func:`drain`."""
    global on
    on = False


def epoch_offset_ns() -> int:
    """Unix-epoch ns minus ``perf_counter_ns``, as measured at the last
    :func:`enable` (or now, before any)."""
    return _offset if _offset is not None else _measure_offset()


def drain() -> Spans:
    """Everything recorded since the last drain; the buffer is emptied.
    Raises, keeping the buffer, while a span is open."""
    global _events, _counts
    ids: dict = {}
    out = Spans([], [], [], [], [], [], _counts, epoch_offset_ns())
    stack: list = []
    ev = _events
    for k in range(0, len(ev), 2):
        a, b = ev[k], ev[k + 1]
        if b is None:
            out.end[stack.pop()] = a
            continue
        nid = ids.get(a)
        if nid is None:
            nid = ids[a] = len(out.names)
            out.names.append(a)
        i = len(out.start)
        parent = stack[-1] if stack else -1
        out.name.append(nid)
        out.start.append(b)
        out.end.append(-1)
        out.parent.append(parent)
        out.root.append(out.root[parent] if parent >= 0 else i)
        stack.append(i)
    if stack:
        raise RuntimeError(f"{len(stack)} span(s) still open")
    _events, _counts = [], {}
    return out
