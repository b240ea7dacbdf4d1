"""Scenario subsystem: deterministic families of SDF application graphs and
heterogeneous architectures, serializable specs, and sampling strategies for
property-based testing and scaling sweeps (see README "Scenario subsystem")."""
from .archs import ArchParams, NOC_PROFILES, generate_architecture
from .families import FAMILIES, build, exec_times, harmonize_graph
from .spec import AppSpec, Scenario, harmonized, scenario_from_json, validate_scenario
from .strategies import (
    LARGE_PARAM_RANGES,
    PARAM_RANGES,
    SIZE_TIERS,
    sample_app_spec,
    sample_arch_params,
    sample_scenario,
    sample_scenarios,
)

__all__ = [
    "ArchParams",
    "NOC_PROFILES",
    "generate_architecture",
    "FAMILIES",
    "build",
    "exec_times",
    "harmonize_graph",
    "AppSpec",
    "Scenario",
    "harmonized",
    "scenario_from_json",
    "validate_scenario",
    "PARAM_RANGES",
    "LARGE_PARAM_RANGES",
    "SIZE_TIERS",
    "sample_app_spec",
    "sample_arch_params",
    "sample_scenario",
    "sample_scenarios",
]
