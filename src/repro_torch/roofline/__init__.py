"""Roofline analysis: analytic model costs and traced step costs (see
:mod:`.analysis`)."""
from .analysis import (CollectiveStats, Recorder, Roofline, Trace, analyze,
                       collectives_of, costs_of, extrapolate_costs,
                       make_roofline, memory_stats, model_flops,
                       ssm_scan_correction)

__all__ = ["CollectiveStats", "Recorder", "Roofline", "Trace", "analyze",
           "collectives_of", "costs_of", "extrapolate_costs",
           "make_roofline", "memory_stats", "model_flops",
           "ssm_scan_correction"]
