"""Runtime of the port: the train and serve steps, the training loop with
checkpoint/restart, and the fault-tolerance state machines.  The
compressed data-parallel step and the mesh shardings come with
distribution (ROADMAP module item 11)."""
from .fault import ElasticController, HeartbeatMonitor, MeshPlan, StragglerDetector
from .loop import TrainLoopConfig, TrainReport, run_training
from .train import (
    TrainState,
    cross_entropy_chunked,
    init_train_state,
    make_serve_step,
    make_train_step,
)

__all__ = [
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
