"""prefill_mfu: the whole prefill's share of the chip's roofline, in %:
for every request sent and served its first token in the untraced part
of a traced run's window (the profiler slows the host's dispatch), the
least time its prefill could take (the larger of its operations at the
bf16 peak and its bytes at the HBM peak, from ``counts/<family>.py``),
summed, over the summed time from sending it to
its first token on the host."""
from perfbench.counts import least_seconds
from perfbench.stats import untraced


def read(run):
    if run.peaks is None:
        return None
    least = spent = 0.0
    for r in run.records:
        if r.arrivals and untraced(run, r.issued) \
                and untraced(run, r.arrivals[0]):
            ops, nbytes = run.counts.prefill(run.config, r.req.batch,
                                             r.req.prompt_len)
            least += least_seconds(ops, nbytes, run.peaks)
            spent += r.arrivals[0] - r.issued
    return 100.0 * least / spent if spent else None
