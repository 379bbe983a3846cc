"""ttft_p90_ms: the 90th percentile, over every request whose first token
reached the host inside the window, of the time from sending it to that
token on the host."""
from perfbench.stats import in_window, percentile


def read(run):
    ttft = [(r.arrivals[0] - r.issued) * 1e3 for r in run.records
            if r.arrivals and in_window(run, r.arrivals[0])]
    return percentile(ttft, 90)
