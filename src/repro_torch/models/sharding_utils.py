"""Interior activation sharding constraints (Megatron-SP pattern).

The counterpart of the JAX package's ``models/sharding_utils.py``: the
paper's channel-placement decision pins each buffer to a memory; these
helpers pin intermediate activations to the intended mesh axes, so
sequence-parallel residuals compose with tensor-parallel attention/FFN
interiors instead of gathering whole weight matrices.

The ambient mesh is the one :func:`use_mesh` entered in this context (a
``contextvars.ContextVar``).  Without one every helper returns its input
object unchanged, as the reference's do.  Under a mesh a DTensor is
redistributed to the spec's placements; a plain tensor is returned as it
is.  Dims that do not divide their axis stay replicated.

The rest has no counterpart in the reference, whose compiler plans every
op of a sharded program; DTensor shards op by op and leaves some to the
model: :func:`gathered` reads a block's weights gathered over the data
axes (FSDP), :func:`split_heads` keeps head splits whole,
:func:`reduce_partial` finishes a pending sum, and :func:`on_batch_rows`,
:func:`on_local_heads`, :func:`ring_on_shards` and
:func:`vocab_parallel_logp` run what it has no rule for (index scatters,
the attention core, the decode ring, the cross-entropy over a split
vocabulary) on each device's own shards.  Each is the plain operation,
returned early, without an ambient mesh.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.nn.utils.stateless import _reparametrize_module

from ..kernels import ring_append_kv, ring_decode_attention

__all__ = ["ambient_mesh", "use_mesh", "constrain", "shard_heads", "shard_ffn", "shard_seq",
           "gathered", "splits", "split_heads", "reduce_partial", "like", "on_batch_rows",
           "on_local_heads", "ring_on_shards", "vocab_parallel_logp"]

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


def ambient_mesh():
    """The ``DeviceMesh`` of the innermost :func:`use_mesh`, or None."""
    return _MESH.get()


@contextlib.contextmanager
def use_mesh(mesh) -> Iterator[None]:
    """Make ``mesh`` the ambient mesh of the block.  Tensors that the model
    builds itself (positions, RoPE angles, masks) are plain tensors; inside
    the block they take part in DTensor ops as replicated
    (``implicit_replication``)."""
    token = _MESH.set(mesh)
    try:
        with implicit_replication():
            yield
    finally:
        _MESH.reset(token)


@contextlib.contextmanager
def gathered(module) -> Iterator[None]:
    """FSDP for compute: under a mesh, inside the block ``module``'s DTensor
    parameters read with their shards over the data axes gathered (the
    model-axis split kept); their gradients reduce-scatter back to the
    stored shards.  Left to DTensor, a product of batch-split activations
    with a data-split weight can come out partial over the data axes,
    each device holding a partial sum over the whole batch.  Nothing
    happens without a mesh."""
    mesh = ambient_mesh()
    if mesh is None:
        yield
        return
    full = {}
    names = mesh.mesh_dim_names
    for n, p in module.named_parameters():
        if not isinstance(p, DTensor):
            continue
        want = [Replicate() if (pl.is_shard() and names[i] != "model") else pl
                for i, pl in enumerate(p.placements)]
        if want != list(p.placements):
            full[n] = p.redistribute(p.device_mesh, want)
    if not full:
        yield
        return
    with _reparametrize_module(module, full):
        yield


def _sizes(mesh):
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _data_axes(mesh):
    dp = tuple(a for a in mesh.mesh_dim_names if a != "model")
    if not dp:
        return None
    return dp if len(dp) > 1 else dp[0]


def _size(mesh, axis) -> int:
    if axis is None:
        return 1
    sizes = _sizes(mesh)
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= sizes[a]
        return n
    return sizes[axis]


def _redistribute(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    from ..runtime.shardings import placements  # runtime imports the models: not at the top

    if not isinstance(x, DTensor):
        return x
    want = placements(tuple(spec), mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(mesh, want)


def constrain(x: torch.Tensor, *axes) -> torch.Tensor:
    """Shard ``x``'s leading dims by axis names ("data" means every
    non-"model" axis); dims that do not divide are replicated; the input
    itself without a mesh."""
    mesh = ambient_mesh()
    if mesh is None:
        return x
    names = tuple(mesh.mesh_dim_names)
    spec = []
    for dim, ax in enumerate(axes[: x.ndim]):
        if ax == "data":
            ax = _data_axes(mesh)
        if ax is not None and (ax not in names and not isinstance(ax, tuple)):
            ax = None
        n = _size(mesh, ax)
        if ax is None or n <= 1 or x.shape[dim] % n or x.shape[dim] < n:
            spec.append(None)
        else:
            spec.append(ax)
    spec += [None] * (x.ndim - len(spec))
    return _redistribute(x, mesh, spec)


def shard_heads(x: torch.Tensor, role: str = "q") -> torch.Tensor:
    """[B, L, H, hd] (or [B, H, hd]) → heads over 'model', batch over data.

    Where the head count does not divide the model axis, ``role="q"``
    falls back to sequence sharding and ``role="kv"`` to replication across
    the model axis: the K/V stream is read by every query shard, so it is
    gathered once per layer (the paper's multi-reader buffer as a sharding
    decision)."""
    mesh = ambient_mesh()
    if mesh is None:
        return x
    nm = _sizes(mesh).get("model", 1)
    if x.ndim == 4:
        B, L, H, hd = x.shape
        if H % nm == 0 and H >= nm:
            return constrain(x, "data", None, "model", None)
        if role == "kv":
            return constrain(x, "data", None, None, None)
        if L % nm == 0 and L >= nm and L > 1:
            return constrain(x, "data", "model", None, None)
        return constrain(x, "data", None, None, None)
    if x.ndim == 3:
        B, H, hd = x.shape
        if H % nm == 0 and H >= nm:
            return constrain(x, "data", "model", None)
    return constrain(x, "data", None, None)


def shard_ffn(x: torch.Tensor) -> torch.Tensor:
    """[B, L, F] → ffn hidden over 'model', batch over data."""
    return constrain(x, "data", None, "model")


def shard_seq(x: torch.Tensor) -> torch.Tensor:
    """[B, L, D] → sequence over 'model' (SP residual layout)."""
    return constrain(x, "data", "model", None)


# ---------------------------------------- what DTensor cannot shard itself
def splits(x: torch.Tensor, dim: int) -> int:
    """Into how many pieces a DTensor's ``dim`` is sharded (1 if plain)."""
    if not isinstance(x, DTensor):
        return 1
    dim %= x.ndim
    n = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            n *= x.device_mesh.size(i)
    return n


def split_heads(x: torch.Tensor, n: int) -> torch.Tensor:
    """``[..., n·hd] → [..., n, hd]``.  A DTensor whose last dim is sharded
    into more pieces than ``n`` heads divide is first replicated on that
    dim: DTensor cannot split a shard across a head.  Without a mesh this
    is ``reshape``."""
    if ambient_mesh() is not None:
        last = x.ndim - 1
        k = splits(x, last)
        if k > 1 and n % k:
            x = x.redistribute(x.device_mesh, [Replicate() if p.is_shard(last) else p
                                               for p in x.placements])
    return x.reshape(*x.shape[:-1], n, x.shape[-1] // n)


def reduce_partial(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's partial placements made whole (``Replicate``): the
    all-reduce that a vocab-parallel embedding lookup leaves pending, done
    before any op that is not linear in it.  The input itself otherwise."""
    if not isinstance(x, DTensor) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in x.placements])


def _batch_split(x: DTensor):
    """``x``'s placements with only its batch split kept (dim 0 over the
    data axes)."""
    names = x.device_mesh.mesh_dim_names
    return tuple(p if (p.is_shard(0) and names[i] != "model") else Replicate()
                 for i, p in enumerate(x.placements))


def like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` split as the DTensor ``ref`` is, to be copied into it in place
    (an in-place copy does not redistribute); the input itself otherwise."""
    if not isinstance(ref, DTensor) or tuple(x.placements) == tuple(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: a local
    gradient goes back into a DTensor, whose views need contiguous shards."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _local(a: torch.Tensor, mesh, want, grad=None) -> torch.Tensor:
    """This device's shard of the DTensor ``a`` split as ``want`` (its
    gradient going back split as ``grad``, ``want`` by default)."""
    a = a if tuple(a.placements) == want else a.redistribute(mesh, want)
    return _ContiguousGrad.apply(a.to_local(grad_placements=grad or want))


def on_batch_rows(fn, *rows, whole=(), **kwargs):
    """``fn(*rows, *whole, **kwargs)`` on each device's batch rows, for ops
    that DTensor has no rule to shard (the MoE routing, dispatch and
    combine index by sample; the SSD scan and its recurrence).  ``fn`` runs
    on local tensors: each DTensor of ``rows`` split by the first one's
    batch split (dim 0 over the data axes), each of ``whole`` whole, its
    gradient partial over that split.  Tensor results (alone or in a
    tuple) come back as DTensors split by batch.  Without a mesh, or
    without a DTensor in ``rows``, this is ``fn(*rows, *whole, **kwargs)``."""
    first = (next((a for a in rows if isinstance(a, DTensor)), None)
             if ambient_mesh() is not None else None)
    if first is None:
        return fn(*rows, *whole, **kwargs)
    mesh, split = first.device_mesh, _batch_split(first)
    full = (Replicate(),) * mesh.ndim
    # a whole operand meets each device's rows only: its gradient sums over them
    full_grad = tuple(Partial() if p.is_shard(0) else Replicate() for p in split)

    def wrap(o):
        if not isinstance(o, torch.Tensor):
            return o
        return DTensor.from_local(o, mesh, split, run_check=False)

    out = fn(*[_local(a, mesh, split) if isinstance(a, DTensor) else a for a in rows],
             *[_local(a, mesh, full, full_grad) if isinstance(a, DTensor) else a for a in whole],
             **kwargs)
    if isinstance(out, tuple):
        return type(out)(*map(wrap, out)) if hasattr(out, "_fields") else tuple(map(wrap, out))
    return wrap(out)


def _group_kv(q: DTensor, k: DTensor, v: DTensor):
    """(k, v) for the grouped-query product of ``q`` ``[B, L, h, hd]`` with
    ``k``/``v`` ``[B, Lk, kv, hd]``: as given, or, where ``q``'s heads are
    sharded into pieces that the ``(kv, h/kv)`` split cannot keep whole,
    each KV head repeated for its group, so the product runs over ``h``
    groups of one head each: the same products, the heads split evenly."""
    n, kv = splits(q, 2), k.shape[2]
    if n <= 1 or kv % n == 0:
        return k, v
    g = q.shape[2] // kv

    def rep(t):
        # split like q's heads right away: the backward then meets the
        # repeat with a whole gradient, which it can fold back per group
        t = t.repeat_interleave(g, dim=2)
        want = [qp if qp.is_shard(2) else tp for qp, tp in zip(q.placements, t.placements)]
        return t.redistribute(t.device_mesh, want)

    return rep(k), rep(v)


def on_local_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *rest):
    """``fn(q, k, v, *rest)``, the attention core (q ``[B, L, h, hd]``, k/v
    ``[B, Lk, kv, hd]``, grouped), on each device's own batch rows and
    heads: DTensor cannot fold its einsums, which merge a split batch with
    split heads.  ``q`` keeps its batch split (dim 0 over the data axes)
    and its head split (dim 2), ``k``/``v`` the same (their KV heads
    repeated per group where ``q``'s split cuts a group), every other dim
    whole; the result ``[B, L, …]`` (heads merged into its last dim,
    outermost) comes back split the same way.  Without a mesh this is
    ``fn(q, k, v, *rest)``."""
    if ambient_mesh() is None or not isinstance(q, DTensor):
        return fn(q, k, v, *rest)
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    k, v = _group_kv(q, k, v)
    want = tuple(Shard(0) if (p.is_shard(0) and names[i] != "model")
                 else Shard(2) if p.is_shard(2) else Replicate()
                 for i, p in enumerate(q.placements))
    out = fn(*(_local(t, mesh, want) for t in (q, k, v)), *rest)
    return DTensor.from_local(out.contiguous(), mesh, want, run_check=False)  # views need it


def _over(x: torch.Tensor, mesh, split, parts, op: str) -> torch.Tensor:
    """A per-shard value ``x`` finished over the mesh dims where ``parts``
    is partial (``op``: "sum" or "max"), split as ``split`` elsewhere;
    returns this device's local result."""
    parts = tuple(Partial(op) if p.is_partial() else q for p, q in zip(parts, split))
    return DTensor.from_local(x, mesh, parts, run_check=False).redistribute(
        mesh, split).to_local()


def _offset(mesh, placements, dim: int, local: int) -> int:
    """Where this device's shard of ``dim`` starts (JAX's major-to-minor
    order over the mesh dims that split it)."""
    part = 0
    for i, p in enumerate(placements):
        if p.is_shard(dim):
            part = part * mesh.size(i) + mesh.get_local_rank(i)
    return part * local


def ring_on_shards(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cache, *,
                   window: int = 0, softcap: float = 0.0) -> torch.Tensor:
    """The decode step's ring write and attention under a mesh, each
    device on its own shard of the ring: its batch rows, and its KV heads
    or its slice of the capacity (``decode_state_specs``), never the whole
    ring.  ``q`` ``[B, h, hd]``, the new ``k``/``v`` ``[B, 1, kv, hd]``,
    ``cache`` one layer's ``k``/``v`` rings ``[B, C, kv, hd]`` and its
    replicated ``omega`` and ``t``.  The new K/V go into slot ω (on the
    device whose slice holds it), ω ← (ω + 1) mod C; returns ``[B, h,
    hd]`` split as ``q``'s batch and heads.  Where the capacity is not
    split, the kernels run on the local rings (``ring_append_kv``,
    ``ring_decode_attention``); where it is, each slice's softmax partials
    (max, sum, P·V in float32) are merged over the split, the ring
    semantics of ``kernels/ref.py::decode_attention_ref``."""
    bk, bv = cache["k"], cache["v"]
    mesh, pl = bk.device_mesh, tuple(bk.placements)
    q_pl = tuple(Shard(0) if p.is_shard(0) else Shard(1) if p.is_shard(2) else Replicate()
                 for p in pl)
    kv_pl = tuple(Shard(0) if p.is_shard(0) else Shard(2) if p.is_shard(2) else Replicate()
                  for p in pl)
    ql = _local(q, mesh, q_pl)
    kl, vl = _local(k, mesh, kv_pl), _local(v, mesh, kv_pl)
    lk, lv = bk.to_local(), bv.to_local()  # views: written in place
    om, t = cache["omega"].to_local(), cache["t"].to_local()
    C, Cl = bk.shape[1], lk.shape[1]
    if not any(p.is_shard(1) for p in pl):
        ring_append_kv(lk, lv, om, kl, vl)
        out = ring_decode_attention(ql, lk, lv, t, window=window, softcap=softcap)
        return DTensor.from_local(out, mesh, q_pl, run_check=False)
    c0 = _offset(mesh, pl, 1, Cl)
    # the write: slot ω (negative from the end, clamped, as mrb_append_ref),
    # on the device whose slice holds it; the others write back what they hold
    idx = om.reshape(1).long()
    idx = torch.where(idx < 0, idx + C, idx).clamp(0, C - 1) - c0
    mine = ((idx >= 0) & (idx < Cl)).reshape(1, 1, 1, 1)
    at = idx.clamp(0, Cl - 1)
    for buf, new in ((lk, kl), (lv, vl)):
        buf.index_copy_(1, at, torch.where(mine, new.to(buf.dtype), buf.index_select(1, at)))
    om.add_(1).remainder_(C)
    # the attention: this slice's scores, then max, sum and P·V over the split
    b, kvl, d = lk.shape[0], lk.shape[2], lk.shape[3]
    hl = ql.shape[1]
    qh = ql.reshape(b, kvl, hl // kvl, d).float()
    slot = c0 + torch.arange(Cl, device=lk.device)
    pos = t - torch.remainder(t - slot, C)
    valid = pos >= 0
    if window > 0:
        valid &= pos > t - window
    s = torch.einsum("bkgd,bckd->bkgc", qh, lk.float()) / math.sqrt(d)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    parts = tuple(Partial() if p.is_shard(1) else Replicate() for p in pl)
    rows = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in pl)
    top = _over(s.amax(-1), mesh, rows, parts, "max")
    e = torch.exp(s - top[..., None])
    den = _over(e.sum(-1), mesh, rows, parts, "sum")
    num = _over(torch.einsum("bkgc,bckd->bkgd", e, lv.float()), mesh, rows, parts, "sum")
    out = (num / den[..., None]).reshape(b, hl, d).to(ql.dtype)
    return DTensor.from_local(out, mesh, q_pl, run_check=False)


def vocab_parallel_logp(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The label's log-probability ``l[y] − max − log Σ exp(l − max)`` of
    logits that are a DTensor with the vocabulary split, computed on each
    device's own vocab slice (Megatron's vocab-parallel cross-entropy): the
    max, the sum of exponentials and the picked logit (0 off the slice) are
    finished over the split on ``[B, c]`` tensors, so no device holds, and
    no gradient expands to, a ``[B, c, V]`` tensor of the whole vocabulary.
    ``y`` is ``[B, c, 1]``; returns ``[B, c]`` split by batch."""
    mesh, last = logits.device_mesh, logits.ndim - 1
    lp = tuple(logits.placements)
    rows = tuple(p if p.is_shard(0) else Replicate() for p in lp)  # the batch split only
    parts = tuple(Partial() if p.is_shard(last) else Replicate() for p in lp)

    ll = logits.to_local(grad_placements=lp)
    yl = (y if tuple(y.placements) == rows else y.redistribute(mesh, rows)).to_local()
    Vl = ll.shape[-1]
    yl = yl[..., 0] - _offset(mesh, lp, last, Vl)
    mine = (yl >= 0) & (yl < Vl)
    m = _over(ll.amax(-1).detach(), mesh, rows, parts, "max")
    se = _over(torch.exp(ll - m[..., None]).sum(-1), mesh, rows, parts, "sum")
    picked = _over(ll.gather(-1, yl.clamp(0, Vl - 1)[..., None])[..., 0] * mine, mesh, rows,
                   parts, "sum")
    return DTensor.from_local(picked - m - torch.log(se), mesh, rows, run_check=False)
