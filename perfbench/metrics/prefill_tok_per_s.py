"""prefill_tok_per_s: prompt tokens whose first token reached the host
inside the window, over the window's length (host clock)."""
from perfbench.stats import in_window


def read(run):
    done = sum(r.req.batch * r.req.prompt_len for r in run.records
               if r.arrivals and in_window(run, r.arrivals[0]))
    return done / (run.t_end - run.t_start) if done else None
