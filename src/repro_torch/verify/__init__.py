"""Standalone, decoder-agnostic schedule verification (README "Schedule
verification"): structured :class:`Violation` reports over the paper's
constraint system, schedule mutations for negative testing, and the decoder
conformance sweep."""
from .conformance import differential_sweep, verify_scenario_decoder
from .mutations import MUTATIONS, apply_mutation, mutation_names
from .verifier import (
    VIOLATION_KINDS,
    VerificationReport,
    Violation,
    verify_decode_result,
    verify_schedule,
)

__all__ = [
    "VIOLATION_KINDS",
    "Violation",
    "VerificationReport",
    "verify_schedule",
    "verify_decode_result",
    "MUTATIONS",
    "apply_mutation",
    "mutation_names",
    "differential_sweep",
    "verify_scenario_decoder",
]
