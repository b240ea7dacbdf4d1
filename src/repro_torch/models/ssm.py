"""Mamba2 (State Space Duality) blocks: chunked SSD scan and O(1) decode.

Counterpart of the JAX package's ``models/ssm.py``.  Per-head scalar decay
A < 0, input-dependent Δt (softplus), grouped B/C of state size N, a causal
depthwise conv on the (x, B, C) stream, gated RMSNorm and out-projection.

:func:`ssm_fwd` is the chunkwise algorithm: quadratic, attention-like work
inside chunks of length Q and a Python loop over the chunks that carries
the inter-chunk state ``[B, nh, P, N]``.  :func:`ssm_decode` is the exact
recurrence S ← S·exp(Δt·A) + Δt·B ⊗ x, one token per step; it updates the
state of :func:`init_ssm_state` in place, as the attention layers update
their ring caches.

Dtypes are the reference's: the decays (``a``, ``dt``, their cumsum and
``exp``) in float32, the x/B/C streams in the compute dtype until the
chunk step widens them, the conv state and ``ssm`` state float32.  Every
leaf of :class:`SSM` is in ``cfg.dtype``, as in the reference's stacked
trees, which cast each float32 leaf with ``ndim >= 2`` (the stacked
``A_log``, ``D_skip``, ``dt_bias``, ``conv_b`` and ``norm`` included), so
``-exp(A_log)`` is computed in that dtype where the reference computes it.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .config import ModelConfig
from .layers import _param, torch_dtype
from .sharding_utils import constrain, like, on_batch_rows

__all__ = ["SSM", "init_ssm", "ssm_fwd", "ssm_decode", "init_ssm_state"]


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nh = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return s, d_inner, nh, conv_dim


class SSM(nn.Module):
    """``in_proj [D, 2·d_inner + 2·G·N + nh]`` (z, x, B, C, dt),
    ``conv_w [d_conv, conv_dim]``, ``conv_b``, ``A_log``, ``D_skip``,
    ``dt_bias [nh]``, ``norm [d_inner]``, ``out_proj [d_inner, D]``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        s, d_inner, nh, conv_dim = _dims(cfg)
        D = cfg.d_model
        dt = torch_dtype(cfg.dtype)
        in_dim = 2 * d_inner + 2 * s.n_groups * s.d_state + nh
        self.in_proj = _param((D, in_dim), dt, device)
        self.conv_w = _param((s.d_conv, conv_dim), dt, device)
        self.conv_b = _param((conv_dim,), dt, device)
        self.A_log = _param((nh,), dt, device)
        self.D_skip = _param((nh,), dt, device)
        self.dt_bias = _param((nh,), dt, device)
        self.norm = _param((d_inner,), dt, device)
        self.out_proj = _param((d_inner, D), dt, device)

    @torch.no_grad()
    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> "SSM":
        D, d_inner = self.in_proj.shape[0], self.out_proj.shape[0]
        nh = self.A_log.shape[0]
        self.in_proj.normal_(0.0, 1.0 / math.sqrt(D), generator=gen)
        self.conv_w.normal_(0.0, 0.2, generator=gen)
        self.conv_b.zero_()
        a = torch.linspace(1.0, 16.0, nh, dtype=torch.float32, device=self.A_log.device)
        self.A_log.copy_(torch.log(a))
        self.D_skip.fill_(1.0)
        self.dt_bias.fill_(math.log(math.e - 1))  # softplus⁻¹(1)
        self.norm.fill_(1.0)
        self.out_proj.normal_(0.0, 1.0 / math.sqrt(d_inner), generator=gen)
        return self


def init_ssm(gen: Optional[torch.Generator], cfg: ModelConfig, device=None) -> SSM:
    return SSM(cfg, device).reset_parameters(gen)


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    s, d_inner, nh, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    z, xbc, dt = torch.split(proj, [d_inner, d_inner + 2 * gn, nh], dim=-1)
    return z, xbc, dt  # xbc = (x, B, C) conv stream


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    g = y * F.silu(z.float()).to(y.dtype)
    gf = g.float()
    out = gf * torch.rsqrt(gf.square().mean(-1, keepdim=True) + 1e-6) * scale
    return out.to(y.dtype)


def ssm_fwd(p: SSM, cfg: ModelConfig, u: torch.Tensor) -> torch.Tensor:
    """Full-sequence SSD.  u: [B, L, D] → [B, L, D].  Raises where L is not a
    multiple of ``min(cfg.ssm.chunk, L)``."""
    s, _, _, conv_dim = _dims(cfg)
    B_, L, _ = u.shape
    Q = min(s.chunk, L)
    if L % Q:
        raise ValueError(f"seq {L} must be divisible by ssm chunk {Q}")
    proj = u @ p.in_proj
    z, xbc, dt = _split_proj(cfg, proj)

    # causal depthwise conv over the (x, B, C) stream
    pad = torch.zeros((B_, s.d_conv - 1, conv_dim), dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([pad, xbc], dim=1)
    conv = sum(xp[:, i:i + L, :] * p.conv_w[i] for i in range(s.d_conv)) + p.conv_b
    conv = F.silu(conv.float()).to(u.dtype)
    conv = constrain(conv, "data", None, "model")
    # per sample: under a mesh, on each device's batch rows, heads whole
    y = on_batch_rows(_ssd, conv, dt, whole=(p.dt_bias, p.A_log, p.D_skip), cfg=cfg)
    return _gated_norm(y, z, p.norm) @ p.out_proj


def _ssd(conv: torch.Tensor, dt: torch.Tensor, dt_bias: torch.Tensor, A_log: torch.Tensor,
         D_skip: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The chunked SSD scan of :func:`ssm_fwd` over the activated conv
    stream ``conv [B, L, conv_dim]`` and the raw ``dt [B, L, nh]``; returns
    ``y [B, L, d_inner]`` in conv's dtype."""
    s, d_inner, nh, _ = _dims(cfg)
    B_, L, _ = conv.shape
    Q = min(s.chunk, L)
    gn = s.n_groups * s.d_state
    x, Bc, Cc = torch.split(conv, [d_inner, gn, gn], dim=-1)
    x = x.reshape(B_, L, nh, s.head_dim)
    Bc = Bc.reshape(B_, L, s.n_groups, s.d_state)
    Cc = Cc.reshape(B_, L, s.n_groups, s.d_state)
    heads_per_group = nh // s.n_groups

    dt = F.softplus(dt.float() + dt_bias)     # [B, L, nh]
    A = -torch.exp(A_log)                     # [nh] < 0, in the leaf's dtype
    a = dt * A                                # log decay, float32

    nchunks = L // Q
    xc = x.reshape(B_, nchunks, Q, nh, s.head_dim)
    Bcc = Bc.reshape(B_, nchunks, Q, s.n_groups, s.d_state)
    Ccc = Cc.reshape(B_, nchunks, Q, s.n_groups, s.d_state)
    ac = a.reshape(B_, nchunks, Q, nh)
    dtc = dt.reshape(B_, nchunks, Q, nh)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=conv.device))

    state = torch.zeros((B_, nh, s.head_dim, s.d_state), dtype=torch.float32, device=conv.device)
    ys = []
    for c in range(nchunks):
        xq = xc[:, c].float()
        Bq = Bcc[:, c].float()
        Cq = Ccc[:, c].float()
        aq, dtq = ac[:, c], dtc[:, c]
        cum = torch.cumsum(aq, dim=1)                             # [B,Q,nh]
        # intra-chunk: M[b,i,j,h] = exp(cum_i - cum_j) for i >= j.  Masked
        # before the exp: above the diagonal cum_i - cum_j > 0 overflows to
        # inf, and exp's backward there would give 0 · inf = NaN (the
        # reference masks after its exp, and its gradients are NaN from
        # the first step at the smoke and full-width chunks); the values
        # are the same.
        diff = cum[:, :, None, :] - cum[:, None, :, :]            # [B,Q,Q,nh]
        M = torch.exp(torch.where(mask[None, :, :, None], diff, -math.inf))
        xdt = xq * dtq[..., None]                                 # [B,Q,nh,P]
        Bh = torch.repeat_interleave(Bq, heads_per_group, dim=2)  # [B,Q,nh,N]
        Ch = torch.repeat_interleave(Cq, heads_per_group, dim=2)
        scores = torch.einsum("bihn,bjhn->bijh", Ch, Bh)          # [B,Q,Q,nh]
        y_intra = torch.einsum("bijh,bjhp->bihp", scores * M, xdt)
        # inter-chunk contribution from the carried state
        decay_in = torch.exp(cum)                                 # [B,Q,nh]
        y_inter = torch.einsum("bihn,bhpn->bihp", Ch, state) * decay_in[..., None]
        # state update
        total = cum[:, -1, :]                                     # [B,nh]
        decay_out = torch.exp(total[:, None, :] - cum)            # [B,Q,nh]
        state = state * torch.exp(total)[:, :, None, None] + torch.einsum(
            "bjhn,bjhp->bhpn", Bh * decay_out[..., None], xdt)
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)                                      # [B, L, nh, P]
    y = y + D_skip[None, None, :, None] * x.float()
    return y.reshape(B_, L, d_inner).to(conv.dtype)


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None
                   ) -> Dict[str, torch.Tensor]:
    """``conv [B, d_conv - 1, conv_dim]`` (``dtype``, float32 by default)
    and ``ssm [B, nh, P, N]`` float32, zeros."""
    s, d_inner, nh, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_dim), dtype=torch_dtype(dtype), device=device),
        "ssm": torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=torch.float32, device=device),
    }


def ssm_decode(p: SSM, cfg: ModelConfig, u: torch.Tensor, state: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token recurrence.  u: [B, 1, D].  ``state`` (``conv``, ``ssm``)
    is updated in place and returned."""
    proj = u[:, 0, :] @ p.in_proj                                  # [B, in_dim]
    z, xbc, dt = _split_proj(cfg, proj)
    conv_state = state["conv"]
    hist = torch.cat([conv_state, xbc[:, None, :]], dim=1)         # [B, d_conv, C], promoted
    wide = torch.promote_types(hist.dtype, p.conv_w.dtype)         # float32, as in JAX
    conv = torch.einsum("bkc,kc->bc", hist.to(wide), p.conv_w.to(wide)) + p.conv_b
    conv = F.silu(conv.float()).to(u.dtype)
    conv = constrain(conv, "data", None, "model")
    y, S = on_batch_rows(_ssm_step, conv, dt, state["ssm"],
                         whole=(p.dt_bias, p.A_log, p.D_skip), cfg=cfg)
    out = _gated_norm(y, z[:, None, :], p.norm) @ p.out_proj
    conv_state.copy_(like(hist[:, 1:, :], conv_state))
    state["ssm"].copy_(like(S, state["ssm"]))
    return out, state


def _ssm_step(conv: torch.Tensor, dt: torch.Tensor, ssm: torch.Tensor, dt_bias: torch.Tensor,
              A_log: torch.Tensor, D_skip: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence of :func:`ssm_decode` over the activated ``conv [B,
    conv_dim]``, the raw ``dt [B, nh]`` and the state ``ssm [B, nh, P,
    N]``: (``y [B, 1, d_inner]`` in conv's dtype, the new state)."""
    s, d_inner, nh, _ = _dims(cfg)
    B_ = conv.shape[0]
    gn = s.n_groups * s.d_state
    x, Bc, Cc = torch.split(conv, [d_inner, gn, gn], dim=-1)
    x = x.reshape(B_, nh, s.head_dim).float()
    Bc = Bc.reshape(B_, s.n_groups, s.d_state).float()
    Cc = Cc.reshape(B_, s.n_groups, s.d_state).float()
    heads_per_group = nh // s.n_groups
    Bh = torch.repeat_interleave(Bc, heads_per_group, dim=1)       # [B,nh,N]
    Ch = torch.repeat_interleave(Cc, heads_per_group, dim=1)
    dt = F.softplus(dt.float() + dt_bias)                          # [B,nh]
    A = -torch.exp(A_log)
    decay = torch.exp(dt * A)                                      # [B,nh]
    S = ssm * decay[:, :, None, None] + (
        (x * dt[..., None])[..., None] * Bh[:, :, None, :])        # [B,nh,P,N]
    y = torch.einsum("bhn,bhpn->bhp", Ch, S) + D_skip[None, :, None] * x
    return y.reshape(B_, 1, d_inner).to(conv.dtype), S
