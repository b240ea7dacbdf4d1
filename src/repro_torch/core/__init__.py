"""Host core of the port: graphs, architectures, MRBs, channel placement,
CAPS-HMS and exact scheduling, the exploration API (problem / engine /
explorers), and campaigns over the run store."""
from .architecture import ArchitectureGraph, paper_architecture
from .apps import APPLICATIONS, multicamera, sobel, sobel4, table1_row
from .binding import (
    CHANNEL_DECISIONS,
    Binding,
    allocation,
    core_cost,
    determine_channel_bindings,
    memory_footprint,
    validate_binding,
)
from .caps_hms import DecodeResult, caps_hms, decode_via_heuristic
from .decoders import (
    DECODERS,
    Decoder,
    decoder_names,
    get_decoder,
    register_decoder,
)
from .dse import (
    DSEConfig,
    DSEResult,
    Genotype,
    GenotypeSpace,
    Individual,
    STRATEGIES,
    evaluate_genotype,
    infeasible_objectives,
    pipeline_delays,
    transformed_graph,
    run_dse,
    xi_mode,
)
from .campaign import (
    Campaign,
    CampaignCell,
    CampaignResult,
    CampaignRunner,
    build_report,
)
from .engine import (
    AUTO_MIN_BATCH,
    CACHE_MODES,
    SIM_BACKENDS,
    EvaluationEngine,
    decode_key,
    resolve_sim_backend,
)
from .runstore import RunStore, canonical_json
from .explorers import (
    EXPLORERS,
    ExplorationRun,
    Explorer,
    NSGA2Explorer,
    RandomSearchExplorer,
    explorer_names,
    get_explorer,
    register_explorer,
)
from .problem import (
    OBJECTIVES,
    EvalContext,
    ExplorationProblem,
    Objective,
    PAPER_OBJECTIVES,
    get_objective,
    objective_names,
    register_objective,
    resolve_objectives,
)
from .graph import (
    Actor,
    ApplicationGraph,
    Channel,
    multicast_actors,
    satisfies_multicast_structure,
    topological_priorities,
)
from .ilp import ExactResult, decode_via_ilp
from .mrb import MRBState, substitute_mrbs
from .pareto import (
    crowding_distance,
    fast_nondominated_sort,
    hypervolume,
    nondominated,
    normalize,
    relative_hypervolume,
)
from .schedule import (
    Schedule,
    TaskTimes,
    UtilizationSet,
    comm_times,
    f_wrap,
    period_lower_bound,
    required_capacities,
    validate_schedule,
)
