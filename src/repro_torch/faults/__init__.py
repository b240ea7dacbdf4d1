"""Deterministic fault injection for the port's campaign stack.

``repro_torch.faults`` is the injection layer (:mod:`~repro_torch.faults.injector`:
``fire``/``FaultPlan``, inert unless ``REPRO_FAULTS`` is set).  Plans,
sites and the fired-log format are the JAX package's, so one plan file
drives either package.  The chaos driver (seeded plan generation and the
faulty→heal→compare convergence checker) is not ported yet.
"""
from .injector import (
    FAULTS_ENV,
    FaultInjected,
    FaultPlan,
    FaultRule,
    configure,
    enabled,
    fire,
    kill_self,
    read_fired_log,
    reset,
)

__all__ = [
    "FAULTS_ENV",
    "FaultInjected",
    "FaultPlan",
    "FaultRule",
    "configure",
    "enabled",
    "fire",
    "kill_self",
    "read_fired_log",
    "reset",
]
