"""decode_mfu: the whole decode step's share of the chip's roofline, in
%: for every decode step taken in the untraced part of a
traced run's window (the profiler slows the host's dispatch), the least time the step could take (the larger of its operations
at the bf16 peak and its bytes at the HBM peak, ``counts/<family>.py``:
every weight once, the cached positions attended, the new K and V, the
logits), summed, over the summed gaps between the batch's tokens."""
from perfbench.counts import least_seconds
from perfbench.stats import untraced


def read(run):
    if run.peaks is None:
        return None
    least = spent = 0.0
    for r in run.records:
        for k, (a, b) in enumerate(zip(r.arrivals, r.arrivals[1:]), 1):
            if untraced(run, a) and untraced(run, b):
                ops, nbytes = run.counts.decode_step(
                    run.config, r.req.batch, r.req.prompt_len + k - 1)
                least += least_seconds(ops, nbytes, run.peaks)
                spent += b - a
    return 100.0 * least / spent if spent else None
