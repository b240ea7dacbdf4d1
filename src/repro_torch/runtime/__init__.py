"""Runtime of the port: the train and serve steps, the training loop with
checkpoint/restart, the fault-tolerance state machines, the int8
compressed data-parallel step over a process group, and the sharding rules
that put a model, its optimizer state and its inputs on a ``DeviceMesh``."""
from .compressed_dp import CompressedTrainState, make_compressed_dp_train_step
from .fault import ElasticController, HeartbeatMonitor, MeshPlan, StragglerDetector
from .loop import TrainLoopConfig, TrainReport, run_training
from .shardings import batch_specs_for_mesh, data_axes, named, param_specs, state_specs
from .train import (
    TrainState,
    cross_entropy_chunked,
    init_train_state,
    make_serve_step,
    make_train_step,
)

__all__ = [
    "CompressedTrainState",
    "make_compressed_dp_train_step",
    "batch_specs_for_mesh",
    "data_axes",
    "named",
    "param_specs",
    "state_specs",
    "ElasticController",
    "HeartbeatMonitor",
    "MeshPlan",
    "StragglerDetector",
    "TrainLoopConfig",
    "TrainReport",
    "run_training",
    "TrainState",
    "cross_entropy_chunked",
    "init_train_state",
    "make_serve_step",
    "make_train_step",
]
