"""Self-timed schedule simulator of the port.

Takes a decoded phenotype — ξ-transformed graph + architecture +
:class:`~repro_torch.core.schedule.Schedule` — and *runs* it: actors fire
when input tokens and their bound core are available, reads/writes contend
for interconnects (and optionally MRB ports), and the steady-state
iteration interval is measured from the firing trace.  Two backends behind
one semantics (:mod:`repro_torch.sim.model`):

* :func:`simulate` / :func:`simulate_period` — event-driven reference in
  exact Python integers, with per-resource Gantt traces (:class:`SimTrace`,
  rendered by :mod:`repro_torch.sim.gantt`);
* :func:`batch_simulate` / :func:`batch_simulate_periods` — the batched
  simulator (:mod:`repro_torch.sim.batched`): the CUDA kernel
  (``backend="cuda"``, :mod:`repro_torch.kernels.sim_step`) or the plain
  batched torch program (``backend="torch"``), wired into
  ``EvaluationEngine.evaluate_batch`` via ``sim_backend=``.

:func:`check_sim_invariants` holds a simulation of any backend against the
analytic schedule.  The ``sim_period`` objective falls back to the analytic
period when simulation is disabled here (:func:`set_simulation_enabled`, or
the ``REPRO_SIM_DISABLE`` environment variable).
"""
from __future__ import annotations

import os

from .batched import BATCH_BACKENDS, batch_simulate, batch_simulate_periods
from .events import Segment, SimResult, SimTrace, simulate, simulate_period
from .gantt import ascii_gantt, save_svg, svg_gantt
from .invariants import check_sim_invariants
from .model import (
    SimConfig,
    SimProgram,
    TaskSpec,
    contention_free,
    fallback_period,
    lower_phenotype,
    measure_period,
)

__all__ = [
    "BATCH_BACKENDS",
    "SimConfig",
    "SimProgram",
    "TaskSpec",
    "Segment",
    "SimResult",
    "SimTrace",
    "simulate",
    "simulate_period",
    "batch_simulate",
    "batch_simulate_periods",
    "lower_phenotype",
    "measure_period",
    "fallback_period",
    "contention_free",
    "check_sim_invariants",
    "ascii_gantt",
    "svg_gantt",
    "save_svg",
    "simulation_enabled",
    "set_simulation_enabled",
]

_ENABLED = not bool(os.environ.get("REPRO_SIM_DISABLE"))


def simulation_enabled() -> bool:
    """Whether objectives backed by the simulator actually simulate."""
    return _ENABLED


def set_simulation_enabled(value: bool) -> bool:
    """Toggle simulation-backed objectives (``sim_period`` falls back to the
    analytic period while disabled).  Returns the previous value."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(value)
    return prev
