"""Distributed-substrate utilities: the checkpointed restart loop of
training (:class:`TrainingRunner`, :class:`FailureInjector`) and the
straggler monitor of the federation layer. The compressed collectives come
with distribution (ROADMAP §1 item 14)."""
from .fault_tolerance import (FailureInjector, RunnerConfig,
                              SimulatedFailure, StragglerMonitor,
                              TrainingRunner)

__all__ = [
    "SimulatedFailure",
    "FailureInjector",
    "RunnerConfig",
    "TrainingRunner",
    "StragglerMonitor",
]
