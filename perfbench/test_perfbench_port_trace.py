"""The reader of the port's spans (``port_trace.py``) on the CPU: device
operations go to the innermost port span around their launch, the
readings follow their definitions on synthetic spans and traces, and a
tiny cell run through ``port_trace.run`` gives the readings the CPU can
give (no device time here)."""
from __future__ import annotations

import time

import pytest

from perfbench import port_trace, testcells
from repro_torch.obs import Spans

OFF = 1_000


def _spans(rows, counts=None):
    """Spans from (name, start, end, parent) rows, in the order they
    opened; stamps on ``perf_counter``'s clock, ``OFF`` ns behind the
    profiler's."""
    names = sorted({r[0] for r in rows})
    root = []
    for i, (_, _, _, p) in enumerate(rows):
        root.append(root[p] if p >= 0 else i)
    return Spans(names, [names.index(r[0]) for r in rows],
                 [r[1] - OFF for r in rows], [r[2] - OFF for r in rows],
                 [r[3] for r in rows], root, counts or {}, OFF)


#: one decode step, traced: the harness's span (100, 200) around the
#: port's root (101, 188): a layer holding a norm and the attention's
#: attend span, then the unembed
STEP = [("serve.decode_step", 101, 188, -1), ("layer", 105, 170, 0),
        ("norm", 106, 110, 1), ("attention.attend", 120, 160, 1),
        ("unembed", 175, 185, 0)]
#: (start, end, name, thread, correlation id, linked id) as
#: ``trace._events`` reads them
HOST = [(100, 200, "perfbench.decode_step", 1, 0, 0),
        (107, 108, "cudaLaunchKernel", 1, 1, 0),     # in norm
        (130, 131, "cudaLaunchKernel", 1, 2, 0),     # in attend
        (140, 141, "cuLaunchKernelEx", 1, 3, 0),     # in attend
        (165, 166, "cudaLaunchKernel", 1, 4, 0),     # in layer
        (180, 181, "cudaMemcpyAsync", 1, 5, 0),      # in unembed
        (192, 193, "cudaLaunchKernel", 1, 6, 0)]     # the harness's argmax
DEV = [(109, 112, "rms", 2, 1, 0), (132, 150, "bmm", 2, 2, 0),
       (150, 158, "softmax", 2, 3, 0), (168, 172, "add", 2, 4, 0),
       (182, 186, "copy", 2, 5, 0), (194, 196, "argmax", 2, 6, 0)]


def test_a_launch_goes_to_the_innermost_port_span():
    pt = port_trace.read(HOST, DEV, _spans(STEP), since_ns=50)
    key = ("serve.decode_step", "attention.attend")
    assert pt.self_device_ns[key] == pt.device_ns[key] == 18 + 8
    assert pt.launches[key] == 2
    assert pt.self_device_ns[("serve.decode_step", "norm")] == 3
    assert pt.self_device_ns[("serve.decode_step", "layer")] == 4
    assert pt.device_ns[("serve.decode_step", "layer")] == 3 + 26 + 4
    root = ("serve.decode_step", "serve.decode_step")
    assert pt.device_ns[root] == 3 + 26 + 4 + 4
    assert pt.self_device_ns.get(root, 0) == 0
    assert pt.launches[root] == 5
    assert pt.roots == {"serve.decode_step": 1}
    # the argmax is the harness's, outside every port span
    assert pt.covered == pytest.approx(37 / 39)
    assert port_trace.attend_ms_per_step(pt) == pytest.approx(26e-6)


def test_idle_gaps_are_named_by_the_innermost_port_span():
    pt = port_trace.read(HOST, DEV, _spans(STEP), since_ns=50)
    got = dict(pt.idle_by_span)
    # gaps 112-132 (middle 122, in attend), 158-168 (163, layer),
    # 172-182 (177, unembed), 186-194 (190, past the root: the
    # harness's);
    # 100-109 lies before the first operation
    assert got == pytest.approx({"attention.attend": 20e-9,
                                 "layer": 10e-9, "unembed": 10e-9,
                                 "harness": 8e-9})


def test_host_times_read_the_roots_before_the_profiler():
    # a root recorded alone, then one with its children, then the traced
    lone = [("serve.decode_step", -150, -120, -1)]
    early = [(n, s - 100, e - 100, p + 1 if p >= 0 else -1)
             for n, s, e, p in STEP]
    rows = lone + early
    spans = _spans(rows + [(n, s, e, p + len(rows) if p >= 0 else -1)
                           for n, s, e, p in STEP])
    pt = port_trace.read(HOST, DEV, spans, since_ns=95)
    # host times by span: the root with its children alone
    assert pt.host_roots == {"serve.decode_step": 1}
    assert pt.host_ns[("serve.decode_step", "layer")] == 65
    assert pt.self_host_ns[("serve.decode_step", "layer")] == 65 - 4 - 40
    assert pt.self_host_ns[("serve.decode_step", "serve.decode_step")] == \
        87 - 65 - 10
    # the traced root alone carries device time
    assert pt.roots == {"serve.decode_step": 1}
    # dispatch: the root recorded alone, so no other span's cost is in it
    assert port_trace.dispatch_ms_per_step(spans, 95) == pytest.approx(
        30e-6)
    assert port_trace.dispatch_ms_per_step(spans, -130) is None
    assert port_trace.spans_a_root(spans) == {"serve.decode_step": 5.0}


def test_the_counter_and_share_readings():
    assert port_trace.attend_masked_share(
        {"attention.positions_attended": 2048 * 32,
         "attention.positions_live": 512 * 32}) == pytest.approx(75.0)
    assert port_trace.attend_masked_share({}) is None
    rows = [("serve.prefill", 0, 100, -1), ("norm", 5, 10, 0),
            ("attention.rope", 20, 30, 0), ("mlp", 40, 90, 0)]
    host = [(0, 101, "perfbench.prefill", 1, 0, 0)] + [
        (t, t + 1, "cudaLaunchKernel", 1, c, 0)
        for c, t in enumerate((6, 21, 45, 95), 1)]
    dev = [(200, 210, "a", 2, 1, 0), (210, 230, "b", 2, 2, 0),
           (230, 290, "c", 2, 3, 0), (290, 300, "d", 2, 4, 0)]
    pt = port_trace.read(host, dev, _spans(rows), since_ns=-1)
    assert port_trace.elementwise_share(pt) == pytest.approx(30.0)
    assert port_trace.attend_ms_per_step(pt) is None


@pytest.fixture
def tiny(tmp_path):
    return testcells.make_home(tmp_path)


@pytest.mark.parametrize("cell,want", [
    ("tiny.decode", {"dispatch_ms_per_step.decode",
                     "attend_masked_share.decode"}),
    ("tiny.prefill", set())])
def test_a_tiny_cell_gives_what_the_cpu_can(tiny, cell, want):
    home, spec = tiny
    out = port_trace.run(cell, 2 ** 40 + 5, 1.0, "cpu", time.perf_counter(),
                         home=home, spec=spec, log=lambda msg: None)
    assert set(out["port"]) == want
    assert all(v > 0 for v in out["port"].values())
    root = "serve.decode_step" if cell == "tiny.decode" else "serve.prefill"
    layers = out["by_layer"][root]
    assert {"layer", "norm", "attention.project", "attention.attend",
            "mlp", "unembed"} <= set(layers)
    # a layer each of the tiny model's two, a step
    assert out["spans_a_root"][root] >= 2 * 10
