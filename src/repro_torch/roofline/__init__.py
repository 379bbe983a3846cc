"""Analytic model costs (see :mod:`.analysis`)."""
from .analysis import model_flops, ssm_scan_correction

__all__ = ["model_flops", "ssm_scan_correction"]
