"""Multi-Reader Buffer (MRB) semantics (paper §II-C) and the selective MRB
replacement graph transformation (paper Algorithm 1).

An MRB c_m has one writer and multiple readers.  It keeps
  - a write index ω ∈ {0, …, γ−1}, and
  - per-reader read indices ρ_r ∈ {−1, 0, …, γ−1} (−1 ⇔ empty for r).

Available tokens from reader r's perspective:
    T(c_m, r) = 0                                   if ρ_r = −1
              = ((ω − ρ_r − 1) mod γ) + 1           otherwise
Free places from the writer's perspective:
    F(c_m) = γ − max_r T(c_m, r)

Firing the writer (producing ψ tokens): every ρ_r = −1 is set to ω, then
ω ← (ω + ψ) mod γ.  Firing reader r (consuming κ tokens):
    ρ_r ← −1                      if T(c_m, r) = κ      (r's view drained)
        ← (ρ_r + κ) mod γ         otherwise

Two realizations live here:
  * :class:`MRBState` — exact pure-Python semantics used by the scheduler,
    the simulator, and the paper-trace tests (Fig. 3).
  * :func:`torch_mrb_*` — a functional mirror over int32 tensors (index
    arrays), the same index arithmetic the batched simulator and its CUDA
    kernel apply per channel.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import torch

from .graph import ApplicationGraph, Channel, multicast_actors

__all__ = [
    "MRBState",
    "substitute_mrbs",
    "mrb_channel_name",
    "torch_mrb_init",
    "torch_mrb_write",
    "torch_mrb_read",
    "torch_mrb_available",
    "torch_mrb_free",
]


# --------------------------------------------------------------------------
# Exact semantics (pure Python)
# --------------------------------------------------------------------------
@dataclass
class MRBState:
    """Paper-exact MRB index machine."""

    capacity: int                       # γ
    readers: Tuple[str, ...]            # reader ids
    write_index: int = 0                # ω
    read_index: Dict[str, int] = field(default_factory=dict)  # ρ_r

    def __post_init__(self) -> None:
        if self.capacity < 1:
            raise ValueError("MRB capacity must be >= 1")
        for r in self.readers:
            self.read_index.setdefault(r, -1)

    # T(c_m, a_r)
    def available(self, reader: str) -> int:
        rho = self.read_index[reader]
        if rho == -1:
            return 0
        return ((self.write_index - rho - 1) % self.capacity) + 1

    # F(c_m)
    def free(self) -> int:
        return self.capacity - max(self.available(r) for r in self.readers)

    def can_write(self, tokens: int = 1) -> bool:
        return self.free() >= tokens

    def can_read(self, reader: str, tokens: int = 1) -> bool:
        return self.available(reader) >= tokens

    def write(self, tokens: int = 1) -> None:
        """Fire the writer producing ``tokens`` (Eq. 4 then Eq. 5)."""
        if not self.can_write(tokens):
            raise RuntimeError("MRB overflow: writer fired without free places")
        for r in self.readers:
            if self.read_index[r] == -1:
                self.read_index[r] = self.write_index
        self.write_index = (self.write_index + tokens) % self.capacity

    def read(self, reader: str, tokens: int = 1) -> None:
        """Fire reader ``reader`` consuming ``tokens``."""
        if not self.can_read(reader, tokens):
            raise RuntimeError(f"MRB underflow for reader {reader!r}")
        if self.available(reader) == tokens:
            self.read_index[reader] = -1
        else:
            self.read_index[reader] = (self.read_index[reader] + tokens) % self.capacity

    def snapshot(self) -> Tuple[int, Dict[str, int]]:
        return self.write_index, dict(self.read_index)


# --------------------------------------------------------------------------
# Algorithm 1: selective MRB replacement
# --------------------------------------------------------------------------
def mrb_channel_name(channels: Sequence[str]) -> str:
    return "mrb{" + ",".join(sorted(channels)) + "}"


def substitute_mrbs(g: ApplicationGraph, xi: Dict[str, int]) -> ApplicationGraph:
    """substituteMRBs(g_A, ξ) — replace each multi-cast actor a_m with
    ξ(a_m)=1 (and its adjacent channels) by one MRB channel.

    The MRB capacity follows the paper's Fig. 2 derivation:
        γ(c_m) = γ(c_in) + γ(c_out)
    (the most tokens that can ever accumulate across the two FIFOs on any
    producer→reader path through the multi-cast actor), the token size is
    inherited (Eq. 2 guarantees they are all equal), and the initial tokens
    are those of the input channel (outputs have δ=0 by Eq. 3).
    """
    gt = g.copy()
    for am in multicast_actors(g):
        if not xi.get(am, 0):
            continue
        ins = gt.in_channels(am)
        outs = gt.out_channels(am)
        if len(ins) != 1:
            raise ValueError(f"{am} is not a multi-cast actor in transformed graph")
        cin = gt.channels[ins[0]]
        couts = [gt.channels[c] for c in outs]
        writer = gt.producer[cin.name]
        readers: List[str] = []
        for co in couts:
            readers.extend(gt.consumers[co.name])
        name = mrb_channel_name([cin.name] + [co.name for co in couts])
        capacity = cin.capacity + couts[0].capacity
        delay = cin.delay
        token_bytes = cin.token_bytes
        # Remove a_m and the adjacent channels, then wire the MRB.
        del gt.actors[am]
        for c in [cin.name] + [co.name for co in couts]:
            del gt.channels[c]
            del gt.producer[c]
            for r in gt.consumers.pop(c):
                gt.cons_rate.pop((c, r), None)
            gt.prod_rate = {k: v for k, v in gt.prod_rate.items() if k[1] != c}
        gt.add_channel(
            name,
            writer,
            readers,
            delay=delay,
            capacity=capacity,
            token_bytes=token_bytes,
            is_mrb=True,
        )
    return gt


# --------------------------------------------------------------------------
# Functional torch mirror (int32 index tensors)
# --------------------------------------------------------------------------
# ``%`` on integer tensors is floored (the sign follows the divisor), which
# is the modulo the paper's index arithmetic needs.
def torch_mrb_init(capacity: int, n_readers: int, device=None):
    """Return (ω, ρ[n_readers]) as int32 tensors. ρ = −1 ⇔ empty."""
    return (
        torch.zeros((), dtype=torch.int32, device=device),
        torch.full((n_readers,), -1, dtype=torch.int32, device=device),
    )


def torch_mrb_available(omega, rho, capacity: int):
    """Vector of T(c_m, r) per reader."""
    t = ((omega - rho - 1) % capacity) + 1
    return torch.where(rho == -1, torch.zeros_like(t), t)


def torch_mrb_free(omega, rho, capacity: int):
    return capacity - torch_mrb_available(omega, rho, capacity).max()


def torch_mrb_write(omega, rho, capacity: int, tokens: int = 1):
    """Functional writer firing; returns (ω', ρ').  Caller must guard with
    torch_mrb_free >= tokens."""
    rho2 = torch.where(rho == -1, omega, rho)
    omega2 = (omega + tokens) % capacity
    return omega2.to(torch.int32), rho2.to(torch.int32)


def torch_mrb_read(omega, rho, capacity: int, reader: int, tokens: int = 1):
    """Functional reader firing for reader index ``reader``; returns ρ'."""
    avail = torch_mrb_available(omega, rho, capacity)[reader]
    new_val = torch.where(
        avail == tokens,
        torch.tensor(-1, dtype=torch.int32, device=rho.device),
        ((rho[reader] + tokens) % capacity).to(torch.int32),
    )
    out = rho.clone()
    out[reader] = new_val
    return out
