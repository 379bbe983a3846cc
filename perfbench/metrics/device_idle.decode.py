"""device_idle.decode: the share, in %, of the traced decode steps' time
(each from its start to its tokens on the host) in which no operation ran
on the device. The profiler records every host op, so the share
includes its cost to the host's dispatch (about twice an untraced
decode step's host time on the H100)."""


def read(run):
    spans = run.trace.spans.get("decode_step", [])
    total = sum(e - s for s, e in spans)
    if not total:
        return None
    return 100.0 * (1.0 - run.trace.span_busy_s["decode_step"] / total)
