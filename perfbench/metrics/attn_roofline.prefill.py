"""attn_roofline.prefill: attention's share of its roofline in the
prefill, in %: the least time of every call of the port's
``kernels.ops.flash_attention`` in the traced window (live (query, key)
pairs, q, k, v and the output counted once at the head dim as given,
``counts.attention``), over the device time of the operations launched
inside those calls. Absent where the calls launched nothing on the
device."""
from perfbench.counts import attention, least_seconds


def read(run):
    tr = run.trace
    spent = tr.span_device_s.get("flash_attention")
    if run.peaks is None or not spent:
        return None
    least = 0.0
    for (B, sq, hq, hd), (_, sk, hkv, _), size, causal, window in \
            tr.attention_calls:
        ops, nbytes = attention(B, sq, sk, hq, hkv, hd, size, causal, window)
        least += least_seconds(ops, nbytes, run.peaks)
    return 100.0 * least / spent
