"""Step factories: the counterpart of the JAX package's ``runtime/train.py``.

Training: the loss with the vocabulary projection computed chunked over
the sequence inside the loss (each chunk recomputed in the backward, so
the ``[B, c, V]`` float32 logits of only one chunk are alive at a time),
gradients by ``torch.autograd.grad``, optional gradient accumulation over
microbatches, global-norm clipping and an optimizer of ``repro_torch.optim``
that updates the weights in place.  :func:`state_tree` and
:func:`load_state_tree` give the train state in the reference's tree
layout (stacked leaves, ``params/…``, ``opt/step``, ``opt/inner/…``) for
the checkpoints.

Serving: :func:`make_serve_step`, one greedy token per request.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..models import tree
from ..models.config import ModelConfig
from ..models.layers import Embed, logits_fwd, torch_dtype
from ..models.model import DecoderLM, decode_step, forward, init_model
from ..models.sharding_utils import constrain, gathered, splits, vocab_parallel_logp
from ..optim import OptState, clip_by_global_norm, cosine_schedule, make_optimizer

__all__ = [
    "TrainState",
    "make_train_step",
    "make_serve_step",
    "make_loss_fn",
    "init_train_state",
    "cross_entropy_chunked",
    "state_tree",
    "load_state_tree",
]


class TrainState(NamedTuple):
    """The model (parameters updated in place) and its optimizer state."""

    model: DecoderLM
    opt: OptState


def cross_entropy_chunked(embed: Embed, cfg: ModelConfig, hidden: torch.Tensor,
                          labels: torch.Tensor, chunk: int = 512, mode: str = "onehot"
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked CE over the vocab projection, chunked along L, each chunk
    recomputed in the backward.  hidden: [B, L, D]; labels: [B, L] (or
    audio [B, K, L]).  Label −100 masks a position.  Returns (sum_loss,
    n_valid), float32.

    ``mode="onehot"`` is the reference's vocab-parallel phrasing: the
    detached max, the sum of exponentials and the picked logit, whose
    one-hot product over V the port reads with one gather (the product
    has a single non-zero term, so the two are equal, without a ``[B, c,
    V]`` one-hot); ``mode="gather"`` takes the label's entry of
    ``log_softmax``."""
    if mode not in ("onehot", "gather"):
        raise ValueError(f"unknown ce mode {mode!r}")
    B, L, D = hidden.shape
    chunk = min(chunk, L)
    while L % chunk:
        chunk -= 1  # largest divisor ≤ requested

    def piece(h_c: torch.Tensor, y_c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with gathered(embed):
            logits = logits_fwd(embed, cfg, h_c).to(torch.float32)  # [B, c, V] or [B, K, c, V]
        mask = (y_c != -100).to(torch.float32)
        y = torch.clamp(y_c, 0, cfg.vocab - 1).long()[..., None]
        if splits(logits, logits.ndim - 1) > 1:  # both modes, vocab-parallel
            picked = vocab_parallel_logp(logits, y)
        elif mode == "gather":
            picked = torch.log_softmax(logits, dim=-1).gather(-1, y)[..., 0]
        else:
            m = logits.amax(-1).detach()
            se = torch.exp(logits - m[..., None]).sum(-1)
            picked = logits.gather(-1, y)[..., 0] - m - torch.log(se)
        return -(picked * mask).sum(), mask.sum()

    # under a mesh: the sequence whole, so the chunks slice locally and the
    # logits split by vocab
    hidden = constrain(hidden, "data", None, None)
    remat = torch.is_grad_enabled()
    s = torch.zeros((), dtype=torch.float32, device=hidden.device)
    n = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(L // chunk):
        h_c = hidden[:, i * chunk:(i + 1) * chunk]
        y_c = labels[..., i * chunk:(i + 1) * chunk]
        ds, dn = checkpoint(piece, h_c, y_c, use_reentrant=False) if remat else piece(h_c, y_c)
        s, n = s + ds, n + dn
    return s, n


def make_loss_fn(cfg: ModelConfig, vocab_chunk: int = 512, ce_mode: str = "onehot"):
    """loss_fn(model, batch) → (ce + aux, {"ce", "aux", "tokens"})."""

    def loss_fn(model: DecoderLM, batch: Mapping[str, torch.Tensor]):
        hidden, aux = forward(model, batch["tokens"], img_embeds=batch.get("img_embeds"),
                              cond_embeds=batch.get("cond_embeds"), return_hidden=True)
        s, m = cross_entropy_chunked(model.embed, cfg, hidden, batch["labels"], vocab_chunk,
                                     ce_mode)
        ce = s / torch.clamp(m, min=1.0)
        return ce + aux, {"ce": ce, "aux": aux, "tokens": m}

    return loss_fn


def init_train_state(cfg: ModelConfig, optimizer: str = "adamw", peak_lr: float = 3e-4,
                     warmup: int = 100, total_steps: int = 10_000, *, seed: int = 0,
                     device="cuda") -> Tuple[TrainState, Callable]:
    """(TrainState with random weights from ``seed`` on ``device``, gradients
    on, and the optimizer's fresh state; the optimizer's update) on the
    reference's cosine schedule."""
    model = init_model(cfg, seed=seed, device=device).requires_grad_(True)
    opt_init, opt_update = make_optimizer(optimizer, cosine_schedule(peak_lr, warmup, total_steps))
    return TrainState(model, opt_init(model)), opt_update


def make_train_step(cfg: ModelConfig, opt_update: Callable, *, grad_clip: float = 1.0,
                    vocab_chunk: int = 512, microbatches: int = 1,
                    grad_dtype: str = "float32", grad_shardings: Optional[Mapping] = None,
                    ce_mode: str = "onehot"):
    """Returns train_step(state, batch) → (state, metrics); the state is
    updated in place.

    ``microbatches`` > 1 accumulates gradients over that many equal slices
    of the batch, as the reference's scan does: the microbatches' mean
    losses and gradients are averaged (not a token-weighted mean over the
    batch), and ``ce``, ``aux`` and ``tokens`` are the last microbatch's.
    ``grad_dtype="bfloat16"`` keeps the gradients and the accumulator in
    bfloat16; clipping and the optimizer still compute in float32.
    ``grad_shardings`` (DTensor placements by parameter name,
    ``runtime.shardings.param_placements``) pins the gradients and the
    accumulator of a model on a mesh to their parameters' placements:
    left to DTensor, a gradient can come out partial or replicated.
    Metrics are 0-dim tensors on the device (``loss``, ``grad_norm``,
    ``ce``, ``aux``, ``tokens``)."""
    loss_fn = make_loss_fn(cfg, vocab_chunk, ce_mode)
    gdt = torch_dtype(grad_dtype)

    def single(model: DecoderLM, batch):
        names, params = zip(*model.named_parameters())
        loss, metrics = loss_fn(model, batch)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = {n: (torch.zeros_like(p) if g is None else g).to(gdt)
                 for n, p, g in zip(names, params, grads)}
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, pin(grads)

    def pin(grads):
        if grad_shardings is None:
            return grads
        return {n: g.redistribute(g.device_mesh, grad_shardings[n]) for n, g in grads.items()}

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor]):
        model = state.model
        if model.cfg != cfg:
            raise ValueError(f"train_step for {cfg.name} got a model of {model.cfg.name}")
        if microbatches > 1:
            B = batch["tokens"].shape[0]
            if B % microbatches:
                raise ValueError(f"batch {B} does not split into {microbatches} microbatches")
            mb = B // microbatches
            grads = pin({n: torch.zeros_like(p, dtype=gdt) for n, p in model.named_parameters()})
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l_i, metrics, g_i = single(model, part)
                grads = pin({n: (grads[n] + g).to(gdt) for n, g in g_i.items()})
                loss = loss + l_i
            grads = {n: g / microbatches for n, g in grads.items()}
            loss = loss / microbatches
        else:
            loss, metrics, grads = single(model, batch)
        grads, gnorm = clip_by_global_norm(grads, grad_clip)
        opt_update(grads, state.opt, model)
        return state, dict(metrics, loss=loss, grad_norm=gnorm)

    return train_step


# ------------------------------------------------------------- state trees
def _nest(flat: Mapping[str, Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        *head, last = key.split(".")
        d = out
        for h in head:
            d = d.setdefault(h, {})
        d[last] = v
    return out


def _dotted(tree_: Mapping, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree_.items():
        if isinstance(v, Mapping):
            out.update(_dotted(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def state_tree(state: TrainState, *, template: bool = False) -> Dict[str, Any]:
    """The reference's ``TrainState`` tree of ``state``: ``{"params": …,
    "opt": {"step": …, "inner": …}}``, nested dicts with the reference's
    keys, every parameter leaf stacked in the reference's shape and dtype
    (the port's float32 norms hold bfloat16 values where the reference's
    leaf is bfloat16, so that cast is exact).  Leaves are on the model's
    device and may be views of live tensors: a checkpoint copies them.
    ``template=True`` gives ``device="meta"`` tensors of the same shapes."""
    leaves = tree.layout(state.model.cfg)
    inner = _dotted(state.opt.inner)
    if template:
        params = {k: torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
                  for k, leaf in leaves.items()}
        inner = {k: torch.empty_like(v, device="meta") for k, v in inner.items()}
        step = torch.empty_like(state.opt.step, device="meta")
    else:
        named = dict(state.model.named_parameters())
        params = {k: tree.stacked(leaf, named).detach().to(leaf.dtype) for k, leaf in leaves.items()}
        step = state.opt.step
    return {"params": _nest(params), "opt": {"step": step, "inner": _nest(inner)}}


@torch.no_grad()
def load_state_tree(state: TrainState, tree_: Mapping[str, Any]) -> TrainState:
    """Copy a tree of :func:`state_tree`'s layout (e.g. a restored
    checkpoint, on any device) into ``state`` in place: weights,
    optimizer state and step."""
    named = dict(state.model.named_parameters())
    params = _dotted(tree_["params"])
    for key, leaf in tree.layout(state.model.cfg).items():
        tree.write_back(leaf, named, params[key].to(state.model.device))
    inner = _dotted(state.opt.inner)
    for key, v in _dotted(tree_["opt"]["inner"]).items():
        inner[key].copy_(v)
    state.opt.step.copy_(tree_["opt"]["step"])
    return state


def make_serve_step(cfg: ModelConfig):
    """serve_step(model, tokens, state[, cond_embeds]) → (next_tokens,
    logits, state).  One new greedy token per request ([B, 1], or [B, K, 1]
    for audio) with the MRB ring KV cache; the state is updated in place.
    ``model`` must have been built for ``cfg``."""

    def serve_step(model: DecoderLM, tokens: torch.Tensor, state,
                   cond_embeds: Optional[torch.Tensor] = None):
        if model.cfg != cfg:
            raise ValueError(f"serve_step for {cfg.name} got a model of {model.cfg.name}")
        logits, state = decode_step(model, tokens, state, cond_embeds=cond_embeds)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, state

    return serve_step
