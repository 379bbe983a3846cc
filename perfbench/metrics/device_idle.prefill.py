"""device_idle.prefill: the share, in %, of the traced prefills' time
(each from its start to its first token on the host) in which no
operation ran on the device. The profiler records every host op, so the
share includes its cost to the host's dispatch (a prefill ~15 % longer
than untraced on the H100)."""


def read(run):
    spans = run.trace.spans.get("prefill", [])
    total = sum(e - s for s, e in spans)
    if not total:
        return None
    return 100.0 * (1.0 - run.trace.span_busy_s["prefill"] / total)
