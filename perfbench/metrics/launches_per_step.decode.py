"""launches_per_step.decode: device operations (kernels, copies, fills)
launched inside the traced decode steps, per step: the host's dispatch
work a step."""


def read(run):
    steps = len(run.trace.spans.get("decode_step", []))
    if not steps:
        return None
    return run.trace.span_launches.get("decode_step", 0) / steps
