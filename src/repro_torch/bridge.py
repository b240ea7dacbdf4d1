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
from .models import tree as tree_layout
from .models.model import DecoderLM

__all__ = [
    "graph_from_dict",
    "arch_from_dict",
    "schedule_from_json",
    "problem_from_json",
    "run_from_json",
    "params_from_jax",
    "train_state_from_jax",
    "compressed_state_from_jax",
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


_jax_key = tree_layout.ref_key


def _dtype_name(a) -> str:
    return str(a.dtype).replace("torch.", "")


def params_from_jax(cfg: ModelConfig, tree: Mapping, *, device="cuda") -> DecoderLM:
    """The JAX ``init_model(rng, cfg)`` tree, leaves as numpy arrays, as the
    port's :class:`~repro_torch.models.model.DecoderLM`.  Layer ``l`` of the
    stacked ``blocks`` tree becomes ``blocks.<l>``; a hybrid's grouped
    ``blocks [n_groups, every, …]`` and ``tail`` become ``blocks.<l>`` in
    layer order and its ``shared`` block ``shared`` (``models/tree.py``).
    Keys, stacked axes, shapes and dtypes must match the reference's tree
    exactly; a block's bfloat16 norm scales, biases and ``q_norm``/
    ``k_norm`` (what the reference's bfloat16 trees hold) are up-cast to
    the port's float32, which is exact.  The SSM vectors and the MoE router
    stay in the tree's dtype, as the port keeps them in ``cfg.dtype``."""
    model = DecoderLM(cfg, device=resolve_device(device))
    params = dict(model.named_parameters())
    flat = _flatten(tree)
    leaves = tree_layout.layout(cfg)
    for key, leaf in leaves.items():
        if key not in flat:
            raise KeyError(f"params_from_jax: the JAX tree has no {key!r}")
        src = np.asarray(flat[key])
        if src.shape[:len(leaf.stack)] != leaf.stack:
            raise ValueError(
                f"params_from_jax: {key} is stacked as {src.shape[:len(leaf.stack)]}, "
                f"expected {leaf.stack}"
            )
        if src.shape != leaf.shape or _dtype_name(src) != _dtype_name(leaf):
            raise ValueError(
                f"params_from_jax: {key} is {src.shape} {src.dtype}, "
                f"expected {leaf.shape} {_dtype_name(leaf)}"
            )
        # The reference casts every float32 leaf with ndim >= 2 to
        # cfg.dtype, so stacked [L, d] norm scales arrive in bfloat16.  Its
        # norm_fwd and _rms multiply a float32 activation by the scale,
        # promoting it to float32 anyway: the port's float32 norms take the
        # up-cast (in write_back's copy), which is exact and computes what
        # the reference does.
        tree_layout.write_back(leaf, params, _to_torch(src, model.device))
    extra = set(flat) - set(leaves)
    if extra:
        raise KeyError(f"params_from_jax: the port has no parameters for {sorted(extra)}")
    return model


def _field(obj: Any, name: str) -> Any:
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def train_state_from_jax(cfg: ModelConfig, tree: Any, optimizer: str, *, device="cuda"):
    """A reference ``TrainState`` (``params``, ``opt`` = ``OptState(step,
    inner)``; NamedTuples or dicts, leaves as numpy arrays) as the port's
    :class:`~repro_torch.runtime.train.TrainState` for ``optimizer``
    (``"adamw"``: ``inner`` = ``{"m", "v"}`` trees; ``"adafactor"``: per
    leaf ``{"vr", "vc"}`` or ``{"v"}``), with gradients on.  The optimizer
    state keeps the reference's stacked shapes, so it is copied as is."""
    from .optim import OptState
    from .runtime.train import TrainState

    model = params_from_jax(cfg, _field(tree, "params"), device=device)
    model.requires_grad_(True)
    opt = _field(tree, "opt")
    inner = _field(opt, "inner")
    dev = model.device
    leaves = tree_layout.layout(cfg)
    if optimizer == "adamw":
        state = {part: {k: _to_torch(v, dev) for k, v in _flatten(inner[part]).items()}
                 for part in ("m", "v")}
        keys = [set(state["m"]), set(state["v"])]
    elif optimizer == "adafactor":
        flat = _flatten(inner)
        state = {}
        for name, v in flat.items():
            key, slot = name.rsplit(".", 1)
            state.setdefault(key, {})[slot] = _to_torch(v, dev)
        keys = [set(state)]
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    for k in keys:
        if k != set(leaves):
            raise KeyError(f"train_state_from_jax: optimizer leaves {sorted(k ^ set(leaves))} "
                           "differ from the model's")
    step = _to_torch(np.asarray(_field(opt, "step"), dtype=np.int32), dev)
    return TrainState(model, OptState(step, state))


def compressed_state_from_jax(cfg: ModelConfig, tree: Any, optimizer: str, *, device="cuda"):
    """A reference ``CompressedTrainState`` (``params``, ``opt``, ``err``;
    NamedTuples or dicts, leaves as numpy arrays) as the port's
    :class:`~repro_torch.runtime.compressed_dp.CompressedTrainState`: the
    train state as :func:`train_state_from_jax` gives it, the
    error-feedback residuals as float32 copies keyed by the reference's
    leaves, in their stacked shapes."""
    from .runtime.compressed_dp import CompressedTrainState

    ts = train_state_from_jax(cfg, {"params": _field(tree, "params"), "opt": _field(tree, "opt")},
                              optimizer, device=device)
    err = {k: _to_torch(np.asarray(v, np.float32), ts.model.device)
           for k, v in _flatten(_field(tree, "err")).items()}
    leaves = tree_layout.layout(cfg)
    if set(err) != set(leaves):
        raise KeyError(f"compressed_state_from_jax: residual leaves {sorted(set(err) ^ set(leaves))} "
                       "differ from the model's")
    for k, e in err.items():
        if tuple(e.shape) != leaves[k].shape:
            raise ValueError(f"{k}: residual of shape {tuple(e.shape)}, expected {leaves[k].shape}")
    return CompressedTrainState(ts.model, ts.opt, err)


def decode_state_from_jax(state: Mapping, *, device="cuda") -> Dict[str, Dict[str, torch.Tensor]]:
    """The JAX ``init_decode_state``/``decode_step`` state, leaves as numpy
    arrays, as the port's decode state (copies, on ``device``): every
    top-level key (``layers`` with ``k``, ``v`` [L, B, C, kv, d],
    ``omega``, ``t`` [L] or ``conv``, ``ssm``; a hybrid's ``shared``)."""
    dev = resolve_device(device)
    return {top: {k: _to_torch(v, dev) for k, v in leaves.items()}
            for top, leaves in state.items()}


def decode_state_to_numpy(state: Mapping) -> Dict[str, Dict[str, np.ndarray]]:
    """The port's decode state as numpy arrays (bfloat16 widened to float32)."""
    def arr(x: torch.Tensor) -> np.ndarray:
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()

    return {top: {k: arr(v) for k, v in leaves.items()} for top, leaves in state.items()}
