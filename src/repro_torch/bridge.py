"""Carry the JAX package's serialized state over to the port's objects.

The exploration's state is the application graph, the architecture, a
decoded schedule and the exploration problem, all of which both packages
serialize to plain JSON-safe dicts.  The serving substrate's state is the
model's parameter tree and the decode cache, carried as numpy arrays (JAX
stacks the layers on axis 0).  These functions take those and return the
port's objects, so a test can build state with the reference, carry it
across, and compare — without the port importing the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Union

import numpy as np
import torch

from .core.architecture import ArchitectureGraph
from .core.explorers import ExplorationRun
from .core.graph import ApplicationGraph
from .core.problem import ExplorationProblem
from .core.schedule import Schedule
from .device import resolve_device
from .models.config import ModelConfig
from .models.model import DecoderLM

__all__ = [
    "graph_from_dict",
    "arch_from_dict",
    "schedule_from_json",
    "problem_from_json",
    "run_from_json",
    "params_from_jax",
    "decode_state_from_jax",
    "decode_state_to_numpy",
]

Json = Union[str, Dict[str, Any]]


def graph_from_dict(d: Dict[str, Any]) -> ApplicationGraph:
    """An ``ApplicationGraph.to_dict()`` of either package."""
    return ApplicationGraph.from_dict(d)


def arch_from_dict(d: Dict[str, Any]) -> ArchitectureGraph:
    """An ``ArchitectureGraph.to_dict()`` of either package."""
    return ArchitectureGraph.from_dict(d)


def schedule_from_json(d: Dict[str, Any]) -> Schedule:
    """A ``Schedule.to_json()`` of either package."""
    return Schedule.from_json(d)


def problem_from_json(d: Json) -> ExplorationProblem:
    """An ``ExplorationProblem.to_json()`` of either package, with the
    graphs embedded or as a scenario spec (plain data, rebuilt by the
    port's own generator)."""
    return ExplorationProblem.from_json(d)


def run_from_json(d: Json) -> ExplorationRun:
    """An ``ExplorationRun.to_json()``: problem, archive and trajectory."""
    return ExplorationRun.from_json(d)


def _to_torch(a: Any, device: torch.device) -> torch.Tensor:
    """A copy of ``a`` on ``device``: never a view of the caller's array,
    since the port updates its decode state in place."""
    a = np.array(a, copy=True, order="C")
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, name + "."))
        else:
            out[name] = v
    return out


def _is_norm_param(name: str) -> bool:
    """A block's norm scale or bias (``norm*``, ``post_norm*``) or an
    attention's ``q_norm``/``k_norm``: float32 in the port."""
    parts = name.split(".")
    return parts[0] == "blocks" and (
        parts[-2].startswith(("norm", "post_norm")) and parts[-1] in ("scale", "bias")
        or parts[-2] == "attn" and parts[-1] in ("q_norm", "k_norm")
    )


def params_from_jax(cfg: ModelConfig, tree: Mapping, *, device="cuda") -> DecoderLM:
    """The JAX ``init_model(rng, cfg)`` tree, leaves as numpy arrays, as the
    port's :class:`~repro_torch.models.model.DecoderLM`.  Layer ``l`` of the
    stacked ``blocks`` tree becomes ``blocks.<l>``; keys, shapes and dtypes
    must match exactly, except that a block's bfloat16 norm scales, biases
    and ``q_norm``/``k_norm`` (what the reference's bfloat16 trees hold)
    are up-cast to the port's float32, which is exact."""
    model = DecoderLM(cfg, device=resolve_device(device))
    flat = _flatten(tree)
    want = set()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("blocks."):
                _, layer, rest = name.split(".", 2)
                key = f"blocks.{rest}"
                src = np.asarray(flat[key])[int(layer)] if key in flat else None
            else:
                key = name
                src = flat.get(key)
            want.add(key)
            if src is None:
                raise KeyError(f"params_from_jax: the JAX tree has no {key!r}")
            x = _to_torch(src, p.device)
            if _is_norm_param(name) and x.dtype == torch.bfloat16 and p.dtype == torch.float32:
                # The reference casts every float32 leaf with ndim >= 2 to
                # cfg.dtype, so stacked [L, d] norm scales arrive in
                # bfloat16.  Its norm_fwd and _rms multiply a float32
                # activation by the scale, promoting it to float32 anyway:
                # the up-cast is exact and computes what the reference does.
                x = x.float()
            if tuple(x.shape) != tuple(p.shape) or x.dtype != p.dtype:
                raise ValueError(
                    f"params_from_jax: {name} is {tuple(x.shape)} {x.dtype}, "
                    f"expected {tuple(p.shape)} {p.dtype}"
                )
            p.copy_(x)
    extra = set(flat) - want
    if extra:
        raise KeyError(f"params_from_jax: the port has no parameters for {sorted(extra)}")
    return model


def decode_state_from_jax(state: Mapping, *, device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX ``init_decode_state``/``decode_step`` cache (``layers`` with
    ``k``, ``v`` [L, B, C, kv, d], ``omega``, ``t`` [L]), leaves as numpy
    arrays, as the port's decode state (copies, on ``device``)."""
    dev = resolve_device(device)
    return {"layers": {k: _to_torch(v, dev) for k, v in state["layers"].items()}}


def decode_state_to_numpy(state: Mapping) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's decode state as numpy arrays (bfloat16 widened to float32)."""
    def arr(x: torch.Tensor) -> np.ndarray:
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    return {"layers": {k: arr(v) for k, v in state["layers"].items()}}
