"""Distributed-substrate utilities: the straggler monitor of the federation
layer. The checkpointed restart loop comes with training (ROADMAP §1.13) and
the compressed collectives with distribution (§1.14)."""
from .fault_tolerance import StragglerMonitor

__all__ = ["StragglerMonitor"]
