"""Distributed-substrate utilities: the checkpointed restart loop of
training (:class:`TrainingRunner`, :class:`FailureInjector`), the
straggler monitor of the federation layer, and the int8 compressed
collectives with error feedback (:mod:`.collectives`, imported from
there, as in the reference)."""
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
