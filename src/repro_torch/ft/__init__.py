"""Fault tolerance: deterministic fault injection, rank-scoped across a
gang (``faults``), capped exponential retry backoff (``retry``) and
straggler accounting (``watchdog``), copies of the reference's, with its
exports."""
from repro_torch.ft.faults import (FaultEvent, FaultPlan, InjectedCrash,
                                   active, arm, arm_plan, current_rank,
                                   disarm, set_rank)
from repro_torch.ft.retry import BackoffPolicy
from repro_torch.ft.watchdog import FailureInjector, StepWatchdog

__all__ = [
    "FaultEvent", "FaultPlan", "InjectedCrash", "active", "arm",
    "arm_plan", "disarm", "set_rank", "current_rank",
    "BackoffPolicy", "FailureInjector", "StepWatchdog",
]
