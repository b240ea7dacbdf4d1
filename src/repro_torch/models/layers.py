"""Common transformer building blocks in torch.

Counterpart of the JAX package's ``models/layers.py``.  Parameters live in
small ``nn.Module`` s whose attribute names are the JAX tree keys (``wq``,
``wk``, ``scale``, ``tok``, …) and keep the JAX layout ``[in, out]`` with
``x @ w``; the forward functions take those modules the way the JAX
functions take param dicts.  Matrices are in ``cfg.dtype``, norm scales in
float32.

The decode path keeps K/V in a *ring buffer* with one write index — the
runtime realization of the paper's Multi-Reader Buffer: each KV head's
buffer is written once per step (:func:`~repro_torch.kernels.ring_append_kv`
writes K and V and advances ω in one call) and read by ``n_heads / n_kv_heads`` query-head readers
(:func:`~repro_torch.kernels.ring_decode_attention`).  The ring and its
``omega``/``t`` counters live on the tensors' device and are updated in
place.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels import ring_append_kv, ring_decode_attention
from .config import ModelConfig
from .sharding_utils import (ambient_mesh, on_local_heads, reduce_partial, ring_on_shards,
                             shard_ffn, shard_heads, split_heads)

__all__ = [
    "Norm",
    "Attention",
    "MLP",
    "Embed",
    "torch_dtype",
    "init_norm",
    "norm_fwd",
    "apply_rope",
    "init_attention",
    "attention_fwd",
    "attention_decode",
    "init_mlp",
    "mlp_fwd",
    "init_embed",
    "embed_fwd",
    "logits_fwd",
    "softcap",
    "make_attention_mask",
    "init_cache",
]


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` → ``torch.bfloat16``; a ``torch.dtype`` passes through."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


# ---------------------------------------------------------------- norms
class Norm(nn.Module):
    """``scale`` (and ``bias`` for layernorm), float32."""

    def __init__(self, cfg: ModelConfig, d: int, device=None):
        super().__init__()
        self.scale = _param((d,), torch.float32, device)
        if cfg.norm == "layernorm":
            self.bias = _param((d,), torch.float32, device)
        else:
            self.register_parameter("bias", None)

    @torch.no_grad()
    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> "Norm":
        self.scale.fill_(1.0)
        if self.bias is not None:
            self.bias.zero_()
        return self


def init_norm(cfg: ModelConfig, d: int, device=None) -> Norm:
    return Norm(cfg, d, device).reset_parameters()


def norm_fwd(p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if p.bias is not None:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, correction=0)  # population variance, as jnp.var
        out = (xf - mu) * torch.rsqrt(var + eps) * p.scale + p.bias
    else:
        ms = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + eps) * p.scale
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma-2 style logit soft-capping: cap·tanh(x/cap)."""
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


# ----------------------------------------------------------------- RoPE
def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    half = head_dim // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freqs  # [..., half]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., L, H, hd] (or [..., H, hd] with scalar positions broadcast).
    Rotates the two halves of the head dim (not interleaved pairs)."""
    hd = x.shape[-1]
    cos, sin = _rope_angles(positions, hd, theta)  # [..., L, half]
    cos = cos[..., None, :]  # broadcast over heads
    sin = sin[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------ attention
class Attention(nn.Module):
    """``wq [D, h·hd]``, ``wk``/``wv [D, kv·hd]``, ``wo [h·hd, D]`` and, with
    qk-norm, ``q_norm``/``k_norm [hd]`` (float32)."""

    def __init__(self, cfg: ModelConfig, cross: bool = False, device=None):
        super().__init__()
        D, hd = cfg.d_model, cfg.resolved_head_dim
        h, kv = cfg.n_heads, cfg.n_kv_heads
        dt = torch_dtype(cfg.dtype)
        self.wq = _param((D, h * hd), dt, device)
        self.wk = _param((D, kv * hd), dt, device)
        self.wv = _param((D, kv * hd), dt, device)
        self.wo = _param((h * hd, D), dt, device)
        if cfg.qk_norm and not cross:
            self.q_norm = _param((hd,), torch.float32, device)
            self.k_norm = _param((hd,), torch.float32, device)
        else:
            self.register_parameter("q_norm", None)
            self.register_parameter("k_norm", None)

    @torch.no_grad()
    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> "Attention":
        s = 1.0 / math.sqrt(self.wq.shape[0])
        for w in (self.wq, self.wk, self.wv, self.wo):
            w.normal_(0.0, s, generator=gen)
        for n in (self.q_norm, self.k_norm):
            if n is not None:
                n.fill_(1.0)
        return self


def init_attention(gen: Optional[torch.Generator], cfg: ModelConfig, cross: bool = False,
                   device=None) -> Attention:
    return Attention(cfg, cross, device).reset_parameters(gen)


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * scale
    return out.to(x.dtype)


def make_attention_mask(L: int, window: int = 0, dtype=torch.float32, device=None) -> torch.Tensor:
    """[L, L] additive mask: causal, optionally sliding-window limited."""
    i = torch.arange(L, device=device)[:, None]
    j = torch.arange(L, device=device)[None, :]
    ok = j <= i
    if window > 0:
        ok &= (i - j) < window
    return torch.where(ok, 0.0, -1e30).to(dtype)


def attention_fwd(
    p: Attention,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    mask: torch.Tensor,
    kv_src: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Full-sequence attention.  x: [B, L, D].  mask: [Lq, Lk] additive.
    ``kv_src`` switches to cross-attention (keys/values from kv_src)."""
    h, kv = cfg.n_heads, cfg.n_kv_heads
    src = x if kv_src is None else kv_src
    q = shard_heads(split_heads(x @ p.wq, h))
    k = shard_heads(split_heads(src @ p.wk, kv), role="kv")
    v = shard_heads(split_heads(src @ p.wv, kv), role="kv")
    if p.q_norm is not None:
        q = _rms(q, p.q_norm)
        k = _rms(k, p.k_norm)
    if kv_src is None:  # RoPE only for self-attention
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return on_local_heads(_attend, q, k, v, mask, cfg.attn_softcap) @ p.wo


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
            cap: float) -> torch.Tensor:
    """softmax(q·k/√hd + mask)·v for q [B, L, h, hd], k/v [B, Lk, kv, hd]
    (grouped: h/kv query heads per KV head), mask [L, Lk] additive;
    returns [B, L, h·hd]."""
    B, L, h, hd = q.shape
    kv = k.shape[2]
    q = q.reshape(B, L, kv, h // kv, hd)
    scores = torch.einsum("blkgd,bmkd->bkglm", q.float(), k.float()) / math.sqrt(hd)
    scores = softcap(scores, cap)
    scores = scores + mask  # [B,kv,g,L,Lk] + [L,Lk]
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkglm,bmkd->blkgd", w, v).reshape(B, L, -1)


def init_cache(cfg: ModelConfig, batch: int, capacity: int, dtype=torch.bfloat16,
               device=None) -> Dict[str, torch.Tensor]:
    """MRB ring KV cache for one attention layer: one write index ω shared
    by all readers; capacity = sliding window (local) or max context."""
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = torch_dtype(dtype)
    return {
        "k": torch.zeros((batch, capacity, kv, hd), dtype=dt, device=device),
        "v": torch.zeros((batch, capacity, kv, hd), dtype=dt, device=device),
        "omega": torch.zeros((), dtype=torch.int32, device=device),  # next write slot
        "t": torch.zeros((), dtype=torch.int32, device=device),      # absolute position
    }


def attention_decode(
    p: Attention,
    cfg: ModelConfig,
    x: torch.Tensor,
    cache: Dict[str, torch.Tensor],
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode step with the MRB ring cache.  x: [B, 1, D].

    ``window`` (0/None = unlimited) additionally restricts attention to the
    last ``window`` positions — used when layers of different window sizes
    share one stacked cache capacity (e.g. Gemma-2).

    Ring semantics: slot s of a capacity-C buffer holds absolute position
    p = t − ((t − s) mod C); a slot is readable iff p ≥ 0 (written) and
    p > t − W (inside the window).  The cache is updated **in place**: the
    new K/V go into slot ω, then ω ← (ω + 1) mod C and t ← t + 1, all on
    the cache's device; the same dict is returned.

    Where the JAX path casts the softmax weights to the cache dtype before
    P·V, the kernel (and its plain version) accumulates P·V in float32: the
    two agree to rounding in float32 and at bfloat16 level in bfloat16."""
    B = x.shape[0]
    hd = cfg.resolved_head_dim
    h, kv = cfg.n_heads, cfg.n_kv_heads
    t = cache["t"]
    q = split_heads(x @ p.wq, h)
    k = split_heads(x @ p.wk, kv)
    v = split_heads(x @ p.wv, kv)
    if p.q_norm is not None:
        q = _rms(q, p.q_norm)
        k = _rms(k, p.k_norm)
    pos = t.reshape(1)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)  # store rotated keys
    if ambient_mesh() is None:
        ring_append_kv(cache["k"], cache["v"], cache["omega"], k, v)  # and ω ← (ω + 1) mod C
        out = ring_decode_attention(
            q.reshape(B, h, hd), cache["k"], cache["v"], t,
            window=int(window or 0), softcap=cfg.attn_softcap,
        )
    else:  # each device on its own shard of the ring
        out = ring_on_shards(q.reshape(B, h, hd), k, v, cache, window=int(window or 0),
                             softcap=cfg.attn_softcap)
    cache["t"].add_(1)
    return out.reshape(B, 1, h * hd) @ p.wo, cache


# -------------------------------------------------------------------- MLP
class MLP(nn.Module):
    """``wi``/``wg [D, F]``, ``wo [F, D]``; ``wg`` only for gated kinds."""

    def __init__(self, cfg: ModelConfig, d_ff: Optional[int] = None, device=None):
        super().__init__()
        D, Fd = cfg.d_model, d_ff or cfg.d_ff
        dt = torch_dtype(cfg.dtype)
        self.wi = _param((D, Fd), dt, device)
        if cfg.mlp in ("swiglu", "geglu"):
            self.wg = _param((D, Fd), dt, device)
        else:
            self.register_parameter("wg", None)
        self.wo = _param((Fd, D), dt, device)

    @torch.no_grad()
    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> "MLP":
        s = 1.0 / math.sqrt(self.wi.shape[0])
        so = 1.0 / math.sqrt(self.wi.shape[1])
        for w in (self.wi, self.wg):
            if w is not None:
                w.normal_(0.0, s, generator=gen)
        self.wo.normal_(0.0, so, generator=gen)
        return self


def init_mlp(gen: Optional[torch.Generator], cfg: ModelConfig, d_ff: Optional[int] = None,
             device=None) -> MLP:
    return MLP(cfg, d_ff, device).reset_parameters(gen)


def mlp_fwd(p: MLP, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation; torch's to the exact form
    if cfg.mlp == "swiglu":
        h = F.silu(shard_ffn(x @ p.wg)) * shard_ffn(x @ p.wi)
    elif cfg.mlp == "geglu":
        h = F.gelu(shard_ffn(x @ p.wg), approximate="tanh") * shard_ffn(x @ p.wi)
    elif cfg.mlp == "relu2":  # nemotron squared-ReLU
        h = torch.relu(shard_ffn(x @ p.wi)).square()
    else:
        h = F.gelu(shard_ffn(x @ p.wi), approximate="tanh")
    return h @ p.wo


# ------------------------------------------------------------- embeddings
class Embed(nn.Module):
    """``tok [n_emb, V, D]`` and, untied, ``head [n_emb, D, V]``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        n_emb = max(1, cfg.n_codebooks) if cfg.n_codebooks else 1
        dt = torch_dtype(cfg.dtype)
        self.tok = _param((n_emb, cfg.vocab, cfg.d_model), dt, device)
        if not cfg.tie_embeddings:
            self.head = _param((n_emb, cfg.d_model, cfg.vocab), dt, device)
        else:
            self.register_parameter("head", None)

    @torch.no_grad()
    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> "Embed":
        for w in (self.tok, self.head):
            if w is not None:
                w.normal_(0.0, 0.02, generator=gen)
        return self


def init_embed(gen: Optional[torch.Generator], cfg: ModelConfig, device=None) -> Embed:
    return Embed(cfg, device).reset_parameters(gen)


def embed_fwd(p: Embed, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: [B, L] or [B, n_codebooks, L] (audio).  Returns [B, L, D]."""
    if cfg.n_codebooks:
        # sum of per-codebook embeddings (MusicGen)
        x = sum(reduce_partial(F.embedding(tokens[:, i, :], p.tok[i]))
                for i in range(cfg.n_codebooks))
    else:
        x = reduce_partial(F.embedding(tokens, p.tok[0]))
    if cfg.name.startswith("gemma"):
        # JAX rounds the weakly typed scale to x's dtype before multiplying
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
    return x.to(torch_dtype(cfg.dtype))


class _MatmulF32(torch.autograd.Function):
    """``x @ w`` for a bfloat16 ``w`` on the card with float32 accumulation
    and output (``torch.mm(..., out_dtype=torch.float32)``, which has no
    derivative); the backward takes the two products in ``w``'s dtype with
    float32 accumulation, the incoming gradient rounded to it."""

    @staticmethod
    def forward(ctx, x2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        xw = x2.to(w.dtype)
        ctx.save_for_backward(xw, w)
        ctx.x_dtype = x2.dtype
        return torch.mm(xw, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        xw, w = ctx.saved_tensors
        gw = g.to(w.dtype)
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = torch.mm(gw, w.t(), out_dtype=torch.float32).to(ctx.x_dtype)
        if ctx.needs_input_grad[1]:
            dw = torch.mm(xw.t(), gw, out_dtype=torch.float32).to(w.dtype)
        return dx, dw


def _matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x.float() @ w.float()`` for w [D, V], without a float32 copy of a
    bfloat16 ``w`` on the card (float32 accumulation and output)."""
    if w.dtype == torch.float32 or not w.is_cuda:
        return x.float() @ w.float()
    lead = x.shape[:-1]
    out = _MatmulF32.apply(x.reshape(-1, x.shape[-1]), w)
    return out.reshape(*lead, w.shape[-1])


def logits_fwd(p: Embed, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [B, L, D] → [B, L, V] (or [B, n_codebooks, L, V] for audio), float32."""
    if cfg.n_codebooks:
        w = p.tok.transpose(1, 2) if cfg.tie_embeddings else p.head  # [n, D, V]
        lg = torch.stack([_matmul_f32(x, w[i]) for i in range(w.shape[0])], dim=1)
    else:
        w = p.tok[0].t() if cfg.tie_embeddings else p.head[0]
        lg = _matmul_f32(x, w)
    return softcap(lg, cfg.final_softcap)
