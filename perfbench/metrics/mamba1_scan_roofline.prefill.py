"""mamba1_scan_roofline.prefill: the Mamba-1 scan's share of its roofline
in the prefill, in %: the least time of every layer's scan in each
prefill the traced window holds (a request sent after the profiler
began; each layer's scan over the prompt, ``counts/<family>.py``'s
``scan``: the recurrence's two multiply-adds a state element and step at
the bf16 peak, x, dt, y, B and C bf16 and the final state fp32 once),
over the device time of the operations named ``mamba_scan_kernel`` in
the trace (K3's Mamba-1 kernel; the Mamba-2 route's
``mamba_scan_mamba2_kernel`` does not match). Absent where the family
counts no scan, the trace names no such operation, or no traced prefill
was served."""
from perfbench.counts import least_seconds


def read(run):
    scan = getattr(run.counts, "scan", None)
    if run.peaks is None or scan is None:
        return None
    spent = sum(t for name, t in run.trace.device_ops
                if "mamba_scan_kernel" in name)
    c = run.config
    least = 0.0
    for r in run.records:
        if r.arrivals and r.issued >= run.t_traced:
            ops, nbytes = scan(r.req.batch, r.req.prompt_len,
                               c["intermediate_size"], c["state_size"])
            least += c["num_hidden_layers"] * least_seconds(ops, nbytes,
                                                            run.peaks)
    if not spent or not least:
        return None
    return 100.0 * least / spent
