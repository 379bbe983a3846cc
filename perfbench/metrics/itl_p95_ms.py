"""itl_p95_ms: the 95th percentile, over every decode step whose tokens
reached the host inside the window, of the gap since the batch's previous
tokens reached it (each step's tokens are copied to the host, as a
streaming server must)."""
from perfbench.stats import in_window, percentile


def read(run):
    gaps = [(b - a) * 1e3 for r in run.records
            for a, b in zip(r.arrivals, r.arrivals[1:]) if in_window(run, b)]
    return percentile(gaps, 95)
