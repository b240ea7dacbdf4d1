"""Data-parallel training step with int8 error-feedback gradient reduction.

The counterpart of the JAX package's ``runtime/compressed_dp.py`` (there a
``shard_map`` over the data axis): each rank of a ``torch.distributed``
process group takes its shard of the batch, computes its local gradients,
quantizes them to int8 with the carried error-feedback residual, moves the
int8 values across the wire (all-gather) and dequantize-sums locally, a 4×
cut of the gradient collective bytes against float32.  Then it clips by the
global norm, applies the optimizer and all-reduces the mean loss.

Compression is per leaf of the reference's tree (``models/tree.py``), as
the reference's per-leaf loop over its stacked tree: one scale over all
the layers of a ``[L, …]`` leaf and one residual in that stacked shape.
Parameters, optimizer state and residuals are replicated on every rank.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple

import torch
import torch.distributed as dist

from ..models import tree
from ..models.config import ModelConfig
from ..models.model import DecoderLM
from ..optim import OptState, clip_by_global_norm
from ..optim.compression import compressed_psum, init_error_state
from .train import TrainState, make_loss_fn

__all__ = ["CompressedTrainState", "make_compressed_dp_train_step"]


class CompressedTrainState(NamedTuple):
    """The model (updated in place), its optimizer state and the
    error-feedback residuals (reference key → float32 stacked tensor)."""

    model: DecoderLM
    opt: OptState
    err: Dict[str, torch.Tensor]


def make_compressed_dp_train_step(cfg: ModelConfig, opt_update: Callable, group=None, *,
                                  grad_clip: float = 1.0, vocab_chunk: int = 512):
    """Returns (init_state, train_step).  ``train_step(state, batch)`` runs
    on every rank of ``group`` (the default group if None) with the same
    global ``batch``; each rank trains on its contiguous shard of the batch
    rows.  The state is updated in place; metrics are ``loss`` (the mean
    over ranks) and ``grad_norm``."""
    loss_fn = make_loss_fn(cfg, vocab_chunk)

    def init_state(train_state: TrainState) -> CompressedTrainState:
        return CompressedTrainState(train_state.model, train_state.opt,
                                    init_error_state(train_state.model))

    def train_step(state: CompressedTrainState, batch: Mapping[str, torch.Tensor]):
        model = state.model
        if model.cfg != cfg:
            raise ValueError(f"train_step for {cfg.name} got a model of {model.cfg.name}")
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        B = batch["tokens"].shape[0]
        if B % n:
            raise ValueError(f"batch {B} does not split over {n} ranks")
        b = B // n
        local = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
        names, params = zip(*model.named_parameters())
        loss, _ = loss_fn(model, local)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = {nm: torch.zeros_like(p) if g is None else g
                 for nm, p, g in zip(names, params, grads)}
        reduced: Dict[str, torch.Tensor] = {}
        for key, leaf in tree.layout(cfg).items():  # int8 on the wire, per stacked leaf
            mean, state.err[key] = compressed_psum(tree.stacked(leaf, grads), state.err[key],
                                                   group)
            rows = mean.reshape((len(leaf.names),) + leaf.shape[len(leaf.stack):])
            reduced.update(zip(leaf.names, rows))
        grads, gnorm = clip_by_global_norm(reduced, grad_clip)
        opt_update(grads, state.opt, model)
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=group)
        return state, {"loss": loss / n, "grad_norm": gnorm}

    return init_state, train_step
