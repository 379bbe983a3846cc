"""device_ms_per_step.decode: milliseconds a decode step keeps the device
busy (operations running, from the trace), averaged over the traced
steps: the card's share of a step, steadier than the host's."""


def read(run):
    steps = len(run.trace.spans.get("decode_step", []))
    if not steps:
        return None
    return 1e3 * run.trace.span_busy_s["decode_step"] / steps
