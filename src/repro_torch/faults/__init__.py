"""Deterministic fault injection and the chaos harness for the port's
campaign stack.

``repro_torch.faults`` is the injection layer
(:mod:`~repro_torch.faults.injector`: ``fire``/``FaultPlan``, inert unless
``REPRO_FAULTS`` is set) plus the chaos driver
(:mod:`~repro_torch.faults.chaos`: seeded plan generation and the
faulty→heal→compare convergence checker behind ``python -m repro_torch
chaos run``, whose servers run their cells on the card unless asked for
the CPU).  Plans, sites and the fired-log format are the JAX package's,
so one plan file drives either package.
"""
from .chaos import DEFAULT_SPEC, SITE_CLASSES, chaos_run, generate_plans
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
    "DEFAULT_SPEC",
    "FAULTS_ENV",
    "FaultInjected",
    "FaultPlan",
    "FaultRule",
    "SITE_CLASSES",
    "chaos_run",
    "configure",
    "enabled",
    "fire",
    "generate_plans",
    "kill_self",
    "read_fired_log",
    "reset",
]
