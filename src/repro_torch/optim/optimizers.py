"""Optimizers: AdamW and Adafactor (factored second moments), global-norm
clipping, cosine schedule.

The counterpart of the JAX package's ``optim/optimizers.py``.  An optimizer
is a pair ``(init, update)``: ``init(model)`` returns an :class:`OptState`,
``update(grads, state, model)`` applies one step **in place** to the
model's parameters and to the state, and returns the state.  ``grads``
maps the port's parameter names to their gradients.

Both optimizers compute per leaf of the reference's tree
(``models/tree.py``): each leaf's gradients and weights are stacked into
the reference's stacked shape, the reference's formula is applied there,
and the result is written back.  So the rules that test ``ndim >= 2``
(AdamW's weight decay, Adafactor's factoring) see the stacked leaf, where a
stacked ``[L, d]`` norm scale is a matrix, and Adafactor's update clip
takes the RMS over the whole stacked leaf, all layers at once.  The state
is kept per leaf in the stacked shape: ``m``/``v`` for AdamW, ``vr``/``vc``
or ``v`` for Adafactor.  Where the reference's leaf is bfloat16 and the
port keeps the parameter in float32 (the norms), the new value is rounded
through bfloat16, as the reference's ``.astype(p.dtype)`` does.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, NamedTuple, Tuple, Union

import torch
from torch import nn

from ..models import tree
from ..models.sharding_utils import reduce_partial

__all__ = [
    "OptState",
    "adamw",
    "adafactor",
    "clip_by_global_norm",
    "cosine_schedule",
    "make_optimizer",
]

Grads = Mapping[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]


class OptState(NamedTuple):
    """``step``: int32 0-dim tensor on the model's device; ``inner``: the
    optimizer's per-leaf state, keyed by the reference's dotted leaf keys."""

    step: torch.Tensor
    inner: Dict


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1) -> Schedule:
    """lr(step): linear warm-up to ``peak_lr``, then a cosine down to
    ``final_frac · peak_lr`` at ``total_steps``; float32, on the step's
    device (no host round trip)."""

    def lr(step: torch.Tensor) -> torch.Tensor:
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(1, warmup_steps)
        prog = torch.clamp((step - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr


def clip_by_global_norm(grads: Grads, max_norm: float) -> Tuple[Dict[str, torch.Tensor],
                                                                torch.Tensor]:
    """(grads scaled to a global norm of at most ``max_norm``, each in its
    own dtype; the global norm before clipping, float32)."""
    gnorm = torch.stack([g.float().square().sum() for g in grads.values()]).sum().sqrt()
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    return {k: (g * scale).to(g.dtype) for k, g in grads.items()}, gnorm


def _lr_fn(lr: Union[Schedule, float]) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def _step0(model: nn.Module) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=next(model.parameters()).device)


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


# ---------------------------------------------------------------- AdamW
def adamw(lr: Union[Schedule, float], b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1):
    lr_fn = _lr_fn(lr)

    def init(model: nn.Module) -> OptState:
        dev = next(model.parameters()).device
        leaves = tree.layout(model.cfg)
        return OptState(_step0(model), {
            part: {k: _zeros(leaf.shape, dev) for k, leaf in leaves.items()}
            for part in ("m", "v")})

    @torch.no_grad()
    def update(grads: Grads, state: OptState, model: nn.Module) -> OptState:
        state.step.add_(1)
        t = state.step.to(torch.float32)
        bc1 = 1 - b1 ** t
        bc2 = 1 - b2 ** t
        lr_t = lr_fn(state.step)
        params = dict(model.named_parameters())
        for key, leaf in tree.layout(model.cfg).items():
            gf = tree.stacked(leaf, grads).to(torch.float32)
            p = tree.stacked(leaf, params).to(torch.float32)
            m, v = state.inner["m"][key], state.inner["v"][key]
            m.copy_(b1 * m + (1 - b1) * gf)
            v.copy_(b2 * v + (1 - b2) * gf.square())
            delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if leaf.ndim >= 2:  # decoupled weight decay on (stacked) matrices only
                delta = delta + weight_decay * p
            tree.write_back(leaf, params, (p - lr_t * delta).to(leaf.dtype))
        return state

    return init, update


# ------------------------------------------------------------ Adafactor
def adafactor(lr: Union[Schedule, float], decay: float = 0.8, eps: float = 1e-30,
              clip_threshold: float = 1.0, weight_decay: float = 0.0):
    """Factored second-moment optimizer (Shazeer & Stern): O(r+c) state per
    r×c matrix instead of O(r·c)."""
    lr_fn = _lr_fn(lr)

    def init(model: nn.Module) -> OptState:
        dev = next(model.parameters()).device
        inner = {}
        for k, leaf in tree.layout(model.cfg).items():
            s = leaf.shape
            if leaf.ndim >= 2:
                inner[k] = {"vr": _zeros(s[:-1], dev), "vc": _zeros(s[:-2] + s[-1:], dev)}
            else:
                inner[k] = {"v": _zeros(s, dev)}
        return OptState(_step0(model), inner)

    @torch.no_grad()
    def update(grads: Grads, state: OptState, model: nn.Module) -> OptState:
        state.step.add_(1)
        t = state.step.to(torch.float32)
        beta = 1.0 - t ** (-decay)
        lr_t = lr_fn(state.step)
        params = dict(model.named_parameters())
        for key, leaf in tree.layout(model.cfg).items():
            gf = tree.stacked(leaf, grads).to(torch.float32)
            p = tree.stacked(leaf, params).to(torch.float32)
            s = state.inner[key]
            g2 = gf.square() + eps
            if leaf.ndim >= 2:  # (means over a split dim finished before the blend)
                vr = s["vr"].copy_(beta * s["vr"] + (1 - beta) * reduce_partial(g2.mean(-1)))
                vc = s["vc"].copy_(beta * s["vc"] + (1 - beta) * reduce_partial(g2.mean(-2)))
                denom = torch.clamp(reduce_partial(vr.mean(-1, keepdim=True)), min=eps)
                u = gf * torch.rsqrt(vr[..., None] / denom[..., None])
                u = u * torch.rsqrt(vc[..., None, :])
            else:
                v = s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                u = gf * torch.rsqrt(v)
            rms = torch.sqrt(reduce_partial(u.square().mean()) + 1e-30)  # the whole stacked leaf
            u = u / torch.clamp(rms / clip_threshold, min=1.0)
            if weight_decay and leaf.ndim >= 2:
                u = u + weight_decay * p
            tree.write_back(leaf, params, (p - lr_t * u).to(leaf.dtype))
        return state

    return init, update


def make_optimizer(name: str, lr, **kw):
    if name == "adamw":
        return adamw(lr, **kw)
    if name == "adafactor":
        return adafactor(lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
