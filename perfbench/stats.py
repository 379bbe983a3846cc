"""Order statistics the metrics share."""
from __future__ import annotations

import statistics


def percentile(values, p: int) -> "float | None":
    """The ``p``-th percentile (1..99) of ``values``, as Python's
    ``statistics.quantiles(..., n=100, method="inclusive")`` cuts them;
    None for fewer than two values."""
    values = list(values)
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=100, method="inclusive")[p - 1]


def in_window(run, t: float) -> bool:
    return run.t_start <= t <= run.t_end


def untraced(run, t: float) -> bool:
    """Inside the window and before the profiler began to record."""
    return run.t_start <= t < run.t_traced
