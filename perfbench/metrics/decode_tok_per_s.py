"""decode_tok_per_s: tokens that reached the host inside the window, over
every sequence of each batch (the first token of each, from the prefill,
and one a decode step), over the window's length (host clock)."""
from perfbench.stats import in_window


def read(run):
    done = sum(r.req.batch for r in run.records for t in r.arrivals
               if in_window(run, t))
    return done / (run.t_end - run.t_start) if done else None
