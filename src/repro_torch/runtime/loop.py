"""The training loop: steps + checkpoint/restart + fault handling.

The counterpart of the JAX package's ``runtime/loop.py``.  Data is indexed
statelessly by step (resume needs no data state), saves are async and
atomic, and failures (real or injected) roll back to the last checkpoint
instead of crashing the job: the rollback writes the checkpoint's weights,
optimizer state and step into the live train state in place.  The loop
restores from ``ckpt_dir`` at start, a step-0 checkpoint included, so a
run can start from a checkpoint the reference wrote.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ..ckpt import CheckpointManager
from ..data import SyntheticStream
from ..device import resolve_device
from ..models.config import ModelConfig
from .fault import StragglerDetector
from .train import init_train_state, load_state_tree, make_train_step, state_tree

__all__ = ["TrainLoopConfig", "run_training", "TrainReport"]


@dataclass
class TrainLoopConfig:
    steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: Optional[str] = None
    optimizer: str = "adamw"
    peak_lr: float = 3e-4
    warmup: int = 10
    grad_clip: float = 1.0
    seq_len: int = 128
    global_batch: int = 8
    microbatches: int = 1
    seed: int = 0
    log_every: int = 10
    # test hook: raise a simulated failure at this step (once)
    inject_failure_at: Optional[int] = None


@dataclass
class TrainReport:
    losses: List[float] = field(default_factory=list)
    steps_done: int = 0
    restarts: int = 0
    step_times: List[float] = field(default_factory=list)
    # seconds of each restore (read + copy into the live state) and of each
    # checkpoint write (host snapshot to commit)
    restore_s: List[float] = field(default_factory=list)
    ckpt_write_s: List[float] = field(default_factory=list)

    @property
    def final_loss(self) -> float:
        return self.losses[-1] if self.losses else float("nan")


class _InjectedFailure(RuntimeError):
    pass


def run_training(cfg: ModelConfig, loop: TrainLoopConfig, *,
                 on_step: Optional[Callable[[int, Dict], None]] = None,
                 device="cuda") -> TrainReport:
    """Train ``cfg`` from random weights (seed ``loop.seed``) on ``device``
    (the card unless ``"cpu"`` is asked for) for ``loop.steps`` steps of
    ``SyntheticStream`` batches.  With ``ckpt_dir`` it restores the newest
    checkpoint there first, saves every ``ckpt_every`` steps, rolls back on
    a failure and ends with the final step's checkpoint on disk (a blocking
save, or the wait for the periodic save of that step, which holds the
same state)."""
    dev = resolve_device(device)
    state, opt_update = init_train_state(
        cfg, loop.optimizer, loop.peak_lr, loop.warmup, loop.steps, seed=loop.seed, device=dev
    )
    train_step = make_train_step(cfg, opt_update, grad_clip=loop.grad_clip,
                                 microbatches=loop.microbatches)
    stream = SyntheticStream(cfg, loop.seq_len, loop.global_batch, seed=loop.seed, device=dev)
    mgr = CheckpointManager(loop.ckpt_dir) if loop.ckpt_dir else None
    template = state_tree(state, template=True)
    detector = StragglerDetector()
    report = TrainReport()

    def restore() -> Optional[int]:
        t0 = time.perf_counter()
        step, tree = mgr.restore_latest(template)
        if step is not None:
            load_state_tree(state, tree)
            report.restore_s.append(time.perf_counter() - t0)
        return step

    step = 0
    saved = None  # the step of the newest checkpoint written or restored
    if mgr is not None:
        saved = restore()
        step = saved or 0
    injected = False
    while step < loop.steps:
        try:
            t0 = time.monotonic()
            batch = stream.batch(step)
            if loop.inject_failure_at is not None and step == loop.inject_failure_at and not injected:
                injected = True
                raise _InjectedFailure(f"simulated node failure at step {step}")
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            detector.record("host0", dt)
            report.losses.append(loss)
            report.step_times.append(dt)
            if on_step:
                on_step(step, metrics)
            step += 1
            report.steps_done = step
            if mgr is not None and step % loop.ckpt_every == 0:
                mgr.save(step, state_tree(state))
                saved = step
        except _InjectedFailure:
            # roll back to the last checkpoint (elastic path: new mesh + restore)
            report.restarts += 1
            if mgr is None:
                raise
            step = saved = restore()
            if step is None:  # nothing saved yet: start over from fresh weights
                step = 0
                state, _ = init_train_state(cfg, loop.optimizer, loop.peak_lr, loop.warmup,
                                            loop.steps, seed=loop.seed, device=dev)
    if mgr is not None:
        if saved == step:  # this step's checkpoint is written or in flight
            mgr.wait()
        else:
            mgr.save(step, state_tree(state), blocking=True)
        report.ckpt_write_s = list(mgr.write_s)
    return report
