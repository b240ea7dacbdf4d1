"""The JAX package's parameter tree, leaf by leaf, over the port's modules.

The reference stacks each block's leaves over the layers (``init_model``
vmaps the block init), so its ``blocks.attn.wq`` is one ``[L, D, h·hd]``
array, a hybrid's ``blocks.ssm.A_log`` is ``[n_groups, every, nh]`` and its
``tail`` holds the remaining layers.  The port keeps one module per layer.
:func:`layout` maps each reference leaf to

* the port's parameters that make it up, in stacking order (ascending
  layer: the reference's ``blocks[g][i]`` is layer ``g·every + i``,
  ``tail[j]`` is layer ``n_groups·every + j``);
* its stacked shape;
* its dtype in the reference's tree: the reference casts every float32
  leaf with ``ndim >= 2`` to ``cfg.dtype``, so a stacked norm scale or
  ``q_norm`` is bfloat16 there where the port keeps it in float32.

The bridge, the optimizers and the checkpoints read the tree through it:
the optimizers' ``ndim >= 2`` rules and Adafactor's whole-leaf RMS are
rules about the stacked leaf, not about one layer's tensor.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from types import MappingProxyType
from typing import Dict, Mapping, Tuple

import torch

from .config import ModelConfig
from .layers import torch_dtype

__all__ = ["Leaf", "layout", "ref_key", "stack_shape", "stacked", "write_back"]


@dataclass(frozen=True)
class Leaf:
    """One leaf of the reference's tree: its dotted ``key``, the port's
    parameter ``names`` stacked into it, its stacked ``shape`` (``stack`` +
    one parameter's shape) and its ``dtype`` in the reference's tree."""

    key: str
    names: Tuple[str, ...]
    stack: Tuple[int, ...]
    shape: Tuple[int, ...]
    dtype: torch.dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)


def ref_key(cfg: ModelConfig, name: str) -> Tuple[str, Tuple[int, ...]]:
    """(reference key, index into its stacked axes) of the port's parameter
    ``name``: layer ``l`` of ``blocks`` is ``blocks[l]``, or for a hybrid
    ``blocks[l // every][l % every]`` and past the groups ``tail[j]``."""
    if not name.startswith("blocks."):
        return name, ()
    _, layer, rest = name.split(".", 2)
    l = int(layer)
    every = cfg.shared_attn_every
    if not every:
        return f"blocks.{rest}", (l,)
    n_groups = cfg.n_layers // every
    if l < n_groups * every:
        return f"blocks.{rest}", (l // every, l % every)
    return f"tail.{rest}", (l - n_groups * every,)


def stack_shape(cfg: ModelConfig, key: str) -> Tuple[int, ...]:
    """The stacked axes the reference's tree has in front of leaf ``key``."""
    every = cfg.shared_attn_every
    if key.startswith("blocks."):
        return (cfg.n_layers // every, every) if every else (cfg.n_layers,)
    if key.startswith("tail."):
        return (cfg.n_layers - cfg.n_layers // every * every,)
    return ()


@functools.lru_cache(maxsize=32)
def layout(cfg: ModelConfig) -> Mapping[str, Leaf]:
    """Every reference leaf of ``cfg``'s tree, in the order of the port's
    ``named_parameters`` (first parameter of each leaf); read-only, built
    once per configuration from a model on the meta device."""
    from .model import DecoderLM

    meta = DecoderLM(cfg, device="meta")
    names: Dict[str, list] = {}
    shapes: Dict[str, Tuple[Tuple[int, ...], torch.dtype]] = {}
    for name, p in meta.named_parameters():
        key, _ = ref_key(cfg, name)
        names.setdefault(key, []).append(name)
        shapes[key] = (tuple(p.shape), p.dtype)
    out = {}
    for key, ns in names.items():
        stack = stack_shape(cfg, key)
        per, dt = shapes[key]
        shape = stack + per
        if dt == torch.float32 and len(shape) >= 2:
            dt = torch_dtype(cfg.dtype)
        out[key] = Leaf(key, tuple(ns), stack, shape, dt)
    return MappingProxyType(out)


def stacked(leaf: Leaf, tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``tensors``' members of ``leaf`` stacked into its shape: a new tensor
    where the leaf is stacked, the tensor itself where it is not."""
    if not leaf.stack:
        return tensors[leaf.names[0]]
    return torch.stack([tensors[n] for n in leaf.names]).reshape(leaf.shape)


@torch.no_grad()
def write_back(leaf: Leaf, tensors: Mapping[str, torch.Tensor], value: torch.Tensor) -> None:
    """Copy ``value`` (the leaf's stacked shape) into ``tensors``' members
    of ``leaf`` in place, each cast to its own dtype."""
    if tuple(value.shape) != leaf.shape:
        raise ValueError(f"{leaf.key}: value of shape {tuple(value.shape)}, expected {leaf.shape}")
    rows = value.reshape((len(leaf.names),) + leaf.shape[len(leaf.stack):])
    for i, n in enumerate(leaf.names):
        tensors[n].copy_(rows[i])
