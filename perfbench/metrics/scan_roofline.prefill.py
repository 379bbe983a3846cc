"""scan_roofline.prefill: the Mamba-2 scan's share of its roofline in the
prefill, in %: the least time of every layer's scan in each prefill the
traced window holds (a request sent after the profiler began; each
layer's scan over the prompt, ``counts/<family>.py``'s ``scan``: the
recurrence's multiply-adds at the bf16 peak, x, y, dt, B and C bf16 and
the final state fp32 once), over the device time of the scan kernel's
operations (K3, named ``mamba_scan`` in the trace). Absent where the
family counts no scan, the trace names no such operation, or no traced
prefill was served."""
from perfbench.counts import least_seconds


def read(run):
    scan = getattr(run.counts, "scan", None)
    if run.peaks is None or scan is None:
        return None
    spent = sum(t for name, t in run.trace.device_ops
                if "mamba_scan" in name)
    c = run.config
    least = 0.0
    for r in run.records:
        if r.arrivals and r.issued >= run.t_traced:
            ops, nbytes = scan(r.req.batch, r.req.prompt_len,
                               c["n_mamba_heads"], c["mamba_headdim"],
                               c["mamba_ngroups"], c["mamba_d_state"])
            least += c["num_hidden_layers"] * least_seconds(ops, nbytes,
                                                            run.peaks)
    if not spent or not least:
        return None
    return 100.0 * least / spent
