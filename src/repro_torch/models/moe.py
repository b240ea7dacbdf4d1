"""Mixture-of-Experts layer (Mixtral / Qwen3-MoE style).

Counterpart of the JAX package's ``models/moe.py``: per-sample top-k
routing with a capacity per (sample, expert) of ``⌈cf·L·k/e⌉``, a
scatter-add dispatch into ``[B, e, cap + 1, D]`` capacity buffers (slot
``cap`` takes the dropped tokens and is cut off), the expert FFN over every
expert's buffer, a gather combine and the Switch load-balancing aux loss.

The capacity positions are a cumsum over the ``(L, k)`` choices flattened
token-major, as the reference's ``route_one`` takes them, so the same
tokens drop.  Top-k is a stable descending sort: equal probabilities keep
the lower expert index first, as ``jax.lax.top_k`` does.  Everything is
batched over the rows (no loop per sample); the loops left are over the k
choices, as in the reference.  All leaves, the router included, are in
``cfg.dtype``; the router product is taken in float32 (the reference
promotes the router to the float32 activations).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import _param, torch_dtype
from .sharding_utils import constrain, on_batch_rows

__all__ = ["MoE", "Routing", "init_moe", "moe_route", "moe_fwd"]


class MoE(nn.Module):
    """``router [D, e]``, ``wi``/``wg [e, D, F]`` (``wg`` only for gated
    kinds), ``wo [e, F, D]``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D, m = cfg.d_model, cfg.moe
        e, Fd = m.num_experts, m.d_ff
        dt = torch_dtype(cfg.dtype)
        self.router = _param((D, e), dt, device)
        self.wi = _param((e, D, Fd), dt, device)
        if cfg.mlp in ("swiglu", "geglu"):
            self.wg = _param((e, D, Fd), dt, device)
        else:
            self.register_parameter("wg", None)
        self.wo = _param((e, Fd, D), dt, device)

    @torch.no_grad()
    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> "MoE":
        s = 1.0 / math.sqrt(self.router.shape[0])
        so = 1.0 / math.sqrt(self.wi.shape[2])
        for w in (self.router, self.wi, self.wg):
            if w is not None:
                w.normal_(0.0, s, generator=gen)
        self.wo.normal_(0.0, so, generator=gen)
        return self


def init_moe(gen: Optional[torch.Generator], cfg: ModelConfig, device=None) -> MoE:
    return MoE(cfg, device).reset_parameters(gen)


class Routing(NamedTuple):
    """Per-sample routing of ``x [B, L, D]``: router ``probs [B, L, e]``,
    ``gate_idx``/``gate_vals [B, L, k]`` (values renormalised over the k),
    each choice's capacity position ``pos_c [B, L, k]`` (``capacity`` where
    it is dropped) and ``keep [B, L, k]``."""

    probs: torch.Tensor
    gate_idx: torch.Tensor
    gate_vals: torch.Tensor
    pos_c: torch.Tensor
    keep: torch.Tensor
    capacity: int


def moe_route(p: MoE, cfg: ModelConfig, x: torch.Tensor) -> Routing:
    # per sample: under a mesh, on each device's batch rows
    return on_batch_rows(_route, x, whole=(p.router,), m=cfg.moe)


def _route(x: torch.Tensor, router: torch.Tensor, m) -> Routing:
    B, L, _ = x.shape
    e, k = m.num_experts, m.top_k
    capacity = max(1, int(math.ceil(m.capacity_factor * L * k / e)))
    logits = x.float() @ router.float()                            # [B, L, e]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[..., :k], idx[..., :k]              # [B, L, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    onehot = F.one_hot(gate_idx, e).reshape(B, L * k, e)           # token-major (l, j)
    pos = torch.cumsum(onehot, dim=1) - 1
    pos = (pos * onehot).sum(-1).reshape(B, L, k)
    keep = pos < capacity
    pos_c = torch.where(keep, pos, capacity)                       # cap = drop slot
    return Routing(probs, gate_idx, gate_vals, pos_c, keep, capacity)


def _expert_ffn(p: MoE, cfg: ModelConfig, xe: torch.Tensor) -> torch.Tensor:
    """xe: [e, n, D] → [e, n, D], every expert over its own rows."""
    if p.wg is not None:
        g = torch.bmm(xe, p.wg)
        g = F.silu(g) if cfg.mlp == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * torch.bmm(xe, p.wi)
    elif cfg.mlp == "relu2":
        h = torch.relu(torch.bmm(xe, p.wi)).square()
    else:
        h = F.gelu(torch.bmm(xe, p.wi), approximate="tanh")
    h = constrain(h, "model", "data", None)  # experts over model, (batch, slot) rows over data
    return torch.bmm(h, p.wo)


def _dispatch(x: torch.Tensor, gate_idx: torch.Tensor, pos_c: torch.Tensor, e: int, cap: int
              ) -> torch.Tensor:
    """Scatter-add every choice of ``x [B, L, D]`` into its (b, expert,
    position) row: ``[B, e, cap, D]``, the drop slot cut off."""
    B, L, D = x.shape
    rows = torch.arange(B, device=x.device)[:, None, None] * e + gate_idx  # (b, expert)
    buf = x.new_zeros((B * e * (cap + 1), D))
    slot = rows * (cap + 1) + pos_c
    xf = x.reshape(B * L, D)
    for j in range(gate_idx.shape[-1]):
        buf.index_add_(0, slot[:, :, j].reshape(-1), xf)
    return buf.view(B, e, cap + 1, D)[:, :, :cap]


def _combine(out_e: torch.Tensor, gate_idx: torch.Tensor, pos_c: torch.Tensor,
             gate_vals: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """Gather-accumulate the k choices of each token from ``out_e [B, e,
    cap, D]``, dropped ones with weight 0: ``[B, L, D]``."""
    B, e, cap, D = out_e.shape
    L = gate_idx.shape[1]
    flat = out_e.reshape(B * e * cap, D)
    rows = torch.arange(B, device=out_e.device)[:, None, None] * e + gate_idx
    w = (gate_vals * keep.float()).to(flat.dtype)                  # [B, L, k]
    src = rows * cap + torch.clamp(pos_c, max=cap - 1)
    y = torch.zeros((B, L, D), dtype=flat.dtype, device=out_e.device)
    for j in range(gate_idx.shape[-1]):
        y = y + flat[src[:, :, j]] * w[:, :, j:j + 1]
    return y


def _choices(gate_idx: torch.Tensor, e: int) -> torch.Tensor:
    return F.one_hot(gate_idx, e).float().sum(2)                   # [B, L, e]


def moe_fwd(p: MoE, cfg: ModelConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, L, D] → (y, aux_loss).  Per-sample capacity-bounded top-k.
    Under a mesh the routing, the dispatch and the combine (index
    scatters and gathers, which DTensor cannot shard) run on each device's
    batch rows; the expert FFN runs on DTensors in the EP layout."""
    m = cfg.moe
    B, L, D = x.shape
    e, k = m.num_experts, m.top_k
    r = moe_route(p, cfg, x)
    cap = r.capacity
    disp = on_batch_rows(_dispatch, x, r.gate_idx, r.pos_c, e=e, cap=cap)  # [B, e, cap, D]
    disp = constrain(disp, "data", "model", None, None)            # EP layout

    # expert FFN over [B, e, cap, D]
    xe = disp.permute(1, 0, 2, 3).reshape(e, B * cap, D)
    out_e = _expert_ffn(p, cfg, xe).reshape(e, B, cap, D).permute(1, 0, 2, 3)
    y = on_batch_rows(_combine, out_e, r.gate_idx, r.pos_c, r.gate_vals, r.keep)

    # load-balancing aux loss (Switch): e · Σ_e f_e · P_e
    me = r.probs.reshape(-1, e).mean(0)
    ce = on_batch_rows(_choices, r.gate_idx, e=e).reshape(-1, e).mean(0) / k
    aux = e * torch.sum(me * ce) * m.aux_loss_weight
    return y.to(x.dtype), aux
