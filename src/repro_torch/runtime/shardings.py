"""Sharding rules: the counterpart of the JAX package's ``runtime/shardings.py``.

A *spec* has the form of a JAX ``PartitionSpec``: a tuple with one entry
per tensor dim, each ``None`` (replicated), a mesh axis name, or a tuple
of axis names (the dim split over those axes, major to minor).  Rules,
identical to the reference's:

  * batch dims shard over all non-"model" axes (pure DP, pod included);
  * column-parallel weights shard their output dim over "model" and their
    input dim over the data axes (FSDP); row-parallel weights ("wo",
    "out_proj", "out") shard the contracting dim over "model";
  * MoE expert stacks shard the expert dim over "model" when it divides,
    else the hidden dim;
  * a dim that does not divide its axis is replicated, never padded;
  * optimizer states follow their parameter (``m``/``v``); Adafactor's
    factored ``vr``/``vc`` shard their last dim over the data axes.

Parameter specs are keyed by the reference's dotted leaf key
(``blocks.attn.wq``) and cover its stacked shape (``models/tree.py``); the
stacked layer dims are never sharded.  :func:`placements` maps a spec onto
DTensor placements of a ``DeviceMesh``, and :func:`distribute_model` /
:func:`distribute_opt_state` put a model and its optimizer state on a mesh
by these specs.  The rules read only a mesh's ``shape`` and
``mesh_dim_names``, so a ``launch.mesh.AbstractMesh`` does for specs.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import torch
from torch import nn

from ..models import tree
from ..models.config import ModelConfig

__all__ = [
    "param_specs",
    "batch_specs_for_mesh",
    "state_specs",
    "decode_state_specs",
    "named",
    "data_axes",
    "placements",
    "param_placements",
    "distribute_model",
    "distribute_opt_state",
    "distribute_tree",
]

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]

ROW_PARALLEL = ("wo", "out_proj", "out")        # contract-dim model-sharded


def _sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def _data(mesh) -> Axis:
    """The data axes as one spec entry: FSDP over pod×data."""
    dp = data_axes(mesh)
    return dp if len(dp) > 1 else (dp[0] if dp else None)


def _axis_size(mesh, axis: Axis) -> int:
    sizes = _sizes(mesh)
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def _fits(mesh, dim: int, axis: Axis) -> bool:
    return axis is not None and dim % _axis_size(mesh, axis) == 0 and dim >= _axis_size(mesh, axis)


def _leaf_spec(mesh, path: Tuple[str, ...], body: Tuple[int, ...]) -> Spec:
    """Spec for one parameter leaf *body* (stacked dims already stripped)
    given its path names."""
    name = path[-1] if path else ""
    DATA = _data(mesh)
    if len(body) <= 1:
        return (None,) * len(body)  # norm scales, per-head vectors, scalars

    # --- MoE expert stacks [E, D, F]
    if name in ("wi", "wg", "wo") and len(body) == 3 and "moe" in path:
        E = body[0]
        if _fits(mesh, E, "model"):  # EP; FSDP the matrix input dim over data
            return ("model", DATA if _fits(mesh, body[1], DATA) else None, None)
        if name == "wo":  # [E, F, D]: TP on the ffn dim
            return (None, "model" if _fits(mesh, body[1], "model") else None,
                    DATA if _fits(mesh, body[2], DATA) else None)
        return (None, DATA if _fits(mesh, body[1], DATA) else None,
                "model" if _fits(mesh, body[2], "model") else None)

    # --- embeddings [n_emb, V, D] / heads [n_emb, D, V]: vocab-parallel + FSDP
    if name in ("tok", "head") and len(body) == 3:
        v_dim, d_dim = (1, 2) if name == "tok" else (2, 1)
        spec: list = [None, None, None]
        spec[v_dim] = "model" if _fits(mesh, body[v_dim], "model") else None
        spec[d_dim] = DATA if _fits(mesh, body[d_dim], DATA) else None
        return tuple(spec)

    # --- generic trailing-2D matrices
    *mid, d_in, d_out = body
    if name in ROW_PARALLEL:
        a_in = "model" if _fits(mesh, d_in, "model") else None
        a_out = DATA if _fits(mesh, d_out, DATA) else None
    else:
        a_in = DATA if _fits(mesh, d_in, DATA) else None
        a_out = "model" if _fits(mesh, d_out, "model") else None
    return (None,) * len(mid) + (a_in, a_out)


def _stacked_spec(mesh, key: str, leaf: tree.Leaf, shape: Tuple[int, ...]) -> Spec:
    n = len(leaf.stack)
    return (None,) * n + _leaf_spec(mesh, tuple(key.split(".")), tuple(shape[n:]))


def param_specs(cfg: ModelConfig, mesh) -> Dict[str, Spec]:
    """The spec of every reference leaf of ``cfg``'s tree, by dotted key."""
    return {k: _stacked_spec(mesh, k, leaf, leaf.shape) for k, leaf in tree.layout(cfg).items()}


def _dotted(t: Mapping, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in t.items():
        if isinstance(v, Mapping):
            out.update(_dotted(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def state_specs(opt_inner: Mapping, mesh, cfg: ModelConfig) -> Dict[str, Spec]:
    """Specs of an optimizer's per-leaf state (``OptState.inner``), keyed by
    the dotted path of ``opt_inner`` (``m.blocks.attn.wq``,
    ``blocks.attn.wq.vr``): ``m``/``v`` mirror their parameter; factored
    ``vr``/``vc`` shard their trailing dim over the data axes if it
    divides."""
    leaves = tree.layout(cfg)
    out: Dict[str, Spec] = {}
    for path, t in _dotted(opt_inner).items():
        names = tuple(path.split("."))
        shape = tuple(t.shape)
        if names[-1] in ("vr", "vc"):
            spec = [None] * len(shape)
            if shape and _fits(mesh, shape[-1], _data(mesh)):
                spec[-1] = _data(mesh)
            out[path] = tuple(spec)
            continue
        key = ".".join(n for n in names if n not in ("m", "v", "vr", "vc"))
        out[path] = _stacked_spec(mesh, key, leaves[key], shape)
    return out


def decode_state_specs(state: Mapping, mesh) -> Dict[str, Spec]:
    """Decode-cache specs, keyed by dotted path (``layers.k``).  Leaves are
    stacked along layers/invocations at dim 0: KV rings [L, B, C, kv, hd]
    shard batch over data and KV heads over model (else the ring capacity);
    SSM states [L, B, H, P, N] and conv windows [L, B, w, C] shard batch and
    heads/channels; the ring indices ω/t are replicated."""
    daxis = _data(mesh)
    nd = _axis_size(mesh, daxis) if daxis is not None else 1
    out: Dict[str, Spec] = {}
    for path, t in _dotted(state).items():
        name = path.rsplit(".", 1)[-1]
        shape = tuple(t.shape)
        if name in ("omega", "t") or len(shape) <= 1:
            out[path] = (None,) * len(shape)
            continue
        spec: list = [None] * len(shape)
        if daxis is not None and shape[1] % nd == 0 and shape[1] >= nd:
            spec[1] = daxis  # batch
        if name in ("k", "v") and len(shape) == 5:
            if _fits(mesh, shape[3], "model"):
                spec[3] = "model"        # KV heads
            elif _fits(mesh, shape[2], "model"):
                spec[2] = "model"        # else the ring capacity
        elif name == "ssm" and len(shape) == 5:
            spec[2] = "model" if _fits(mesh, shape[2], "model") else None
        elif name == "conv" and len(shape) == 4:
            spec[3] = "model" if _fits(mesh, shape[3], "model") else None
        out[path] = tuple(spec)
    return out


def batch_specs_for_mesh(batch: Mapping[str, Any], mesh) -> Dict[str, Spec]:
    """Batch dim over the data axes where it divides; the rest replicated."""
    axis = _data(mesh)
    n = _axis_size(mesh, axis) if axis is not None else 1

    def rule(shape) -> Spec:
        a = axis if (axis is not None and shape[0] % n == 0 and shape[0] >= n) else None
        return (a,) + (None,) * (len(shape) - 1)

    return {k: rule(tuple(v.shape)) for k, v in batch.items()}


# ------------------------------------------------------------ placements
def placements(spec: Spec, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``: ``Replicate()`` on every
    mesh dim, ``Shard(d)`` on each mesh dim that tensor dim ``d`` is split
    over.  A tuple entry splits its dim over its axes major to minor, which
    DTensor does in mesh-dim order, so a tuple out of mesh order raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order {names}")
        for m in dims:
            if not isinstance(out[m], Replicate):
                raise ValueError(f"mesh axis {names[m]!r} is used twice in {spec!r}")
            out[m] = Shard(d)
    return tuple(out)


def named(mesh, spec_tree: Mapping[str, Spec]) -> Dict[str, Tuple[Any, ...]]:
    """:func:`placements` of every spec of a flat spec dict."""
    return {k: placements(s, mesh) for k, s in spec_tree.items()}


def _distribute(t: torch.Tensor, mesh, spec: Spec):
    from torch.distributed.tensor import distribute_tensor

    # every rank holds the whole tensor: each takes its own shard, no collective
    return distribute_tensor(t, mesh, placements(spec, mesh), src_data_rank=None)


def distribute_tree(tensors: Mapping[str, torch.Tensor], specs: Mapping[str, Spec], mesh
                    ) -> Dict[str, Any]:
    """Each tensor of a flat dict as a DTensor of its spec's placements."""
    return {k: _distribute(t, mesh, specs[k]) for k, t in tensors.items()}


def _layer_specs(cfg: ModelConfig, mesh, specs: Optional[Mapping[str, Spec]]
                 ) -> Dict[str, Spec]:
    """The spec of each of the port's parameters: its leaf's spec with the
    stacked dims stripped (the rules never shard them, so this is the
    leaf's sharding exactly)."""
    specs = param_specs(cfg, mesh) if specs is None else specs
    out = {}
    for key, leaf in tree.layout(cfg).items():
        n = len(leaf.stack)
        if any(specs[key][:n]):
            raise ValueError(f"{key}: a stacked dim is sharded in {specs[key]!r}")
        for name in leaf.names:
            out[name] = specs[key][n:]
    return out


def param_placements(cfg: ModelConfig, mesh, specs: Optional[Mapping[str, Spec]] = None
                     ) -> Dict[str, Tuple[Any, ...]]:
    """DTensor placements of each of the port's parameters, by name (what
    ``make_train_step(grad_shardings=...)`` takes)."""
    return {n: placements(s, mesh) for n, s in _layer_specs(cfg, mesh, specs).items()}


@torch.no_grad()
def distribute_model(model: nn.Module, mesh, specs: Optional[Mapping[str, Spec]] = None
                     ) -> nn.Module:
    """Replace each parameter of ``model`` (a ``DecoderLM``) in place by a
    DTensor on ``mesh`` with its leaf's spec, the stacked dims stripped.
    ``specs`` (by reference key) defaults to :func:`param_specs`."""
    layer_specs = _layer_specs(model.cfg, mesh, specs)
    for name, p in list(model.named_parameters()):
        mod_name, _, attr = name.rpartition(".")
        mod = model.get_submodule(mod_name)
        mod.register_parameter(attr, nn.Parameter(_distribute(p.data, mesh, layer_specs[name]),
                                                  requires_grad=p.requires_grad))
    return model


def distribute_opt_state(opt, mesh, cfg: ModelConfig):
    """An ``OptState`` whose per-leaf state is on ``mesh`` by
    :func:`state_specs` (``step`` stays a plain replicated scalar)."""
    specs = state_specs(opt.inner, mesh, cfg)

    def walk(t: Mapping, prefix: str = "") -> Dict[str, Any]:
        return {k: walk(v, f"{prefix}{k}.") if isinstance(v, Mapping)
                else _distribute(v, mesh, specs[f"{prefix}{k}"]) for k, v in t.items()}

    return type(opt)(opt.step, walk(opt.inner))
