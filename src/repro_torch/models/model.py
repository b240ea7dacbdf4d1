"""Model assembly for every configuration of the JAX package.

Counterpart of the JAX package's ``models/model.py``.  :class:`DecoderLM`
holds the weights as ``nn.Module`` s named after the JAX tree
(``embed.tok``, ``blocks.<l>.attn.wq``, ``blocks.<l>.ssm.A_log``,
``blocks.<l>.moe.router``, ``shared.fuse``, ``final_norm.scale``, …), one
module per layer where JAX stacks layers on axis 0.  Every block has the
structure of the first layer's kind, as the reference's vmapped init
gives it:

  * attention blocks: pre-norms, optional Gemma-2 post-norms, a
    cross-attention (``norm_x`` + ``xattn``) where the config has
    conditioning tokens, and ``moe`` in place of ``mlp`` for MoE configs;
  * SSM blocks (``norm1`` + ``ssm``: Mamba2);
  * Zamba2 hybrids: ``n_groups × every`` blocks, a ``tail`` of the
    remaining layers, and one ``shared`` attention block whose parameters
    are stored once and read by every invocation (the reference's
    ``blocks[g][i]`` is layer ``g·every + i`` here, ``tail[j]`` layer
    ``n_groups·every + j``).

:func:`decode_step` runs one token per request through every layer with
the MRB ring KV caches and SSM states of :func:`init_decode_state`, which
it updates in place; every attention layer, the shared one included, goes
through ``layers.attention_decode`` and so through the ring kernels.
:func:`forward` is the full-sequence path (image prefix, conditioning,
``(logits, aux)`` or the final hidden states), with the online-softmax
:func:`attention_fwd_chunked` above ``CHUNKED_ATTN_THRESHOLD``;
:func:`prefill_step` returns the last position's logits.
``CHUNKED_ATTN_THRESHOLD``, ``ATTN_Q_BLOCK``, ``ATTN_K_BLOCK`` and
``ATTN_UNROLL_Q`` are read at call time.

With ``cfg.remat`` and gradients enabled, :func:`forward` recomputes each
block in the backward (``torch.utils.checkpoint``, non-reentrant), and a
hybrid's whole group body (the shared block and its ``every`` blocks), as
the reference's ``jax.checkpoint`` does; inference paths are unaffected.

Under a mesh (``sharding_utils.use_mesh``, with the parameters and the
batch as DTensors: ``runtime/shardings.py``) the activations are pinned
where the reference pins them: :func:`constrain_activation` on every
block's output and the embedding, heads and FFN hiddens in the layers.
Without a mesh every constraint returns its input unchanged.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from .config import ModelConfig
from .layers import (
    MLP,
    Attention,
    Embed,
    Norm,
    _param,
    _rms,
    apply_rope,
    attention_decode,
    attention_fwd,
    embed_fwd,
    init_cache,
    logits_fwd,
    mlp_fwd,
    norm_fwd,
    softcap,
    torch_dtype,
)
from .moe import MoE, moe_fwd
from .sharding_utils import (ambient_mesh, constrain, gathered, on_local_heads, reduce_partial,
                             shard_heads, split_heads)
from .ssm import SSM, init_ssm_state, ssm_decode, ssm_fwd

__all__ = [
    "DecoderLM",
    "init_model",
    "init_decode_state",
    "decode_step",
    "prefill",
    "prefill_step",
    "forward",
    "attention_fwd_chunked",
    "decode_windows",
    "constrain_activation",
    "CHUNKED_ATTN_THRESHOLD",
]

CHUNKED_ATTN_THRESHOLD = 2048  # direct quadratic path below, chunked above
ATTN_Q_BLOCK = 512
ATTN_K_BLOCK = 1024
# each q block visits only its causal prefix of k blocks (no upper triangle);
# False visits every k block, masked, as the reference's uniform variant
ATTN_UNROLL_Q = True

DecodeState = Dict[str, Dict[str, torch.Tensor]]


class Block(nn.Module):
    """One decoder block of ``kind`` ('s' SSM, else attention)."""

    def __init__(self, cfg: ModelConfig, kind: str, device=None):
        super().__init__()
        self.norm1 = Norm(cfg, cfg.d_model, device)
        self.attn = self.post_norm1 = self.post_norm2 = None
        self.norm_x = self.xattn = self.norm2 = self.mlp = self.moe = self.ssm = None
        if kind == "s":
            self.ssm = SSM(cfg, device)
            return
        self.attn = Attention(cfg, device=device)
        if cfg.post_block_norm:
            self.post_norm1 = Norm(cfg, cfg.d_model, device)
            self.post_norm2 = Norm(cfg, cfg.d_model, device)
        if cfg.n_cond_tokens:
            self.norm_x = Norm(cfg, cfg.d_model, device)
            self.xattn = Attention(cfg, cross=True, device=device)
        self.norm2 = Norm(cfg, cfg.d_model, device)
        if cfg.moe:
            self.moe = MoE(cfg, device)
        else:
            self.mlp = MLP(cfg, device=device)


class SharedBlock(nn.Module):
    """Zamba2 shared attention block: ``fuse [2D, D]`` of concat(x, x0),
    ``norm1``, ``attn``, ``norm2``, ``mlp``, ``out [D, D]``."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        D = cfg.d_model
        dt = torch_dtype(cfg.dtype)
        self.fuse = _param((2 * D, D), dt, device)
        self.norm1 = Norm(cfg, D, device)
        self.attn = Attention(cfg, device=device)
        self.norm2 = Norm(cfg, D, device)
        self.mlp = MLP(cfg, device=device)
        self.out = _param((D, D), dt, device)

    @torch.no_grad()
    def reset_parameters(self, gen: Optional[torch.Generator] = None) -> "SharedBlock":
        D = self.out.shape[0]
        self.fuse.normal_(0.0, 1.0 / math.sqrt(2 * D), generator=gen)
        self.out.normal_(0.0, 1.0 / math.sqrt(D), generator=gen)
        return self


class DecoderLM(nn.Module):
    """Decoder-only LM of any family with the JAX package's parameter tree.

    Constructed empty (``torch.empty``); :func:`init_model` fills it at
    random and :func:`repro_torch.bridge.params_from_jax` from a JAX tree.
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.embed = Embed(cfg, device)
        kind = cfg.layer_kinds()[0]  # every layer has the first one's structure
        self.blocks = nn.ModuleList(Block(cfg, kind, device) for _ in range(cfg.n_layers))
        self.shared = SharedBlock(cfg, device) if cfg.shared_attn_every else None
        self.final_norm = Norm(cfg, cfg.d_model, device)
        self.windows = decode_windows(cfg)

    @property
    def device(self) -> torch.device:
        return self.embed.tok.device


def decode_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer decode windows (0 = unlimited): 'l' layers, and 'a' layers
    of an arch that uses a sliding window everywhere, are windowed."""
    return [
        cfg.sliding_window if (cfg.sliding_window and k in ("l", "a")) else 0
        for k in cfg.layer_kinds()
    ]


def _layer_windows(cfg: ModelConfig, L: int) -> List[int]:
    """Per-layer attention window of the full-sequence path (L + 1 =
    unlimited): the decode windows, with 0 read as L + 1."""
    return [w if w else L + 1 for w in decode_windows(cfg)]


def _groups(cfg: ModelConfig) -> Tuple[int, int]:
    """(n_groups, layers in groups) of a hybrid: the tail is the rest."""
    every = cfg.shared_attn_every
    n_groups = cfg.n_layers // every
    return n_groups, n_groups * every


def init_model(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> DecoderLM:
    """Random weights with the JAX package's scales, drawn from a
    ``torch.Generator`` seeded with ``seed`` on the target device, directly
    in ``cfg.dtype`` (matrices, SSM and MoE leaves) and float32 (norm
    scales)."""
    dev = resolve_device(device)
    model = DecoderLM(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (Norm, Attention, MLP, Embed, SSM, MoE, SharedBlock)):
            m.reset_parameters(gen)
    return model


def constrain_activation(x: torch.Tensor) -> torch.Tensor:
    """Pin activations to (batch over the data axes, sequence over 'model')
    under an ambient mesh, each where it divides (Megatron-SP residuals:
    the stored residuals shard over the model axis too).  The input itself
    without a mesh, without data axes or below two dims."""
    mesh = ambient_mesh()
    if mesh is None or x.ndim < 2 or all(a == "model" for a in mesh.mesh_dim_names):
        return x
    return constrain(x, "data", "model" if x.ndim >= 3 else None)


def _ring(n: int, cfg: ModelConfig, batch: int, capacity: int, dtype, device
          ) -> Dict[str, torch.Tensor]:
    one = init_cache(cfg, batch, capacity, dtype, device)
    return {k: torch.zeros((n,) + tuple(v.shape), dtype=v.dtype, device=device)
            for k, v in one.items()}


def init_decode_state(cfg: ModelConfig, batch: int, context: int, dtype=None,
                      device="cuda") -> DecodeState:
    """Per-layer decode state on the device, stacked over layers:

    * attention configs: ``layers`` = MRB ring KV cache ``k``/``v [L, B,
      C, kv, d]`` in ``dtype`` (default ``cfg.dtype``) and int32
      ``omega``/``t [L]``; every layer has the largest capacity any layer
      needs (sliding window where bounded, else ``context``), windows
      bound the local layers;
    * SSM configs: ``layers`` = ``conv [L, B, d_conv - 1, conv_dim]`` and
      ``ssm [L, B, nh, P, N]``, float32;
    * hybrids also: ``shared``, one ring per shared invocation
      (``n_layers // every``) of capacity ``min(context, sliding_window or
      context)``."""
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype if dtype is None else dtype)
    L = cfg.n_layers
    if cfg.layer_kinds()[0] == "s":
        one = init_ssm_state(cfg, batch, device=dev)
        layers = {k: torch.zeros((L,) + tuple(v.shape), dtype=v.dtype, device=dev)
                  for k, v in one.items()}
    else:
        cap = max(min(context, w) if w else context for w in decode_windows(cfg))
        layers = _ring(L, cfg, batch, cap, dt, dev)
    state: DecodeState = {"layers": layers}
    if cfg.shared_attn_every:
        w = cfg.sliding_window or context
        state["shared"] = _ring(L // cfg.shared_attn_every, cfg, batch, min(context, w), dt, dev)
    return state


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------
def _at(bufs: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s views of a stacked state (updated in place)."""
    return {name: buf[i] for name, buf in bufs.items()}


def _block_step(blk: Block, cfg: ModelConfig, x: torch.Tensor, cache, window: int,
                cond: Optional[torch.Tensor]) -> torch.Tensor:
    h = norm_fwd(blk.norm1, x)
    if blk.ssm is not None:
        out, _ = ssm_decode(blk.ssm, cfg, h, cache)
        return x + out
    out, _ = attention_decode(blk.attn, cfg, h, cache, window)
    if blk.post_norm1 is not None:
        out = norm_fwd(blk.post_norm1, out)
    x = x + out
    if cond is not None and blk.xattn is not None:
        hx = norm_fwd(blk.norm_x, x)
        zero = torch.zeros((1, cond.shape[1]), dtype=torch.float32, device=x.device)
        x = x + attention_fwd(blk.xattn, cfg, hx, None, zero, kv_src=cond)
    h2 = norm_fwd(blk.norm2, x)
    if blk.moe is not None:
        out2, _ = moe_fwd(blk.moe, cfg, h2)  # the aux loss is not used in decode
    else:
        out2 = mlp_fwd(blk.mlp, cfg, h2)
    if blk.post_norm2 is not None:
        out2 = norm_fwd(blk.post_norm2, out2)
    return x + out2


def _shared_step(p: SharedBlock, cfg: ModelConfig, x: torch.Tensor, x0: torch.Tensor,
                 cache) -> torch.Tensor:
    h = torch.cat([x, x0], dim=-1) @ p.fuse
    a, _ = attention_decode(p.attn, cfg, norm_fwd(p.norm1, h), cache, cfg.sliding_window or 0)
    h = h + a
    h = h + mlp_fwd(p.mlp, cfg, norm_fwd(p.norm2, h))
    return x + h @ p.out


@torch.no_grad()
def decode_step(model: DecoderLM, tokens: torch.Tensor, state: DecodeState, *,
                cond_embeds: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step.  tokens: [B, 1] (or [B, K, 1] audio).  Returns
    (logits [B, 1, V] / [B, K, 1, V] float32, state), the state updated in
    place.  ``cond_embeds`` [B, Lc, D] feeds every cross-attention."""
    cfg = model.cfg
    with gathered(model.embed):
        x = embed_fwd(model.embed, cfg, tokens)
    cond = cond_embeds.to(x.dtype) if cond_embeds is not None else None
    layers = state["layers"]
    blocks, windows = model.blocks, model.windows
    start = 0
    if cfg.shared_attn_every:
        x0 = x
        n_groups, start = _groups(cfg)
        every = cfg.shared_attn_every
        for g in range(n_groups):
            with gathered(model.shared):
                x = _shared_step(model.shared, cfg, x, x0, _at(state["shared"], g))
            for l in range(g * every, (g + 1) * every):
                with gathered(blocks[l]):
                    x = _block_step(blocks[l], cfg, x, _at(layers, l), windows[l], cond)
    for l in range(start, cfg.n_layers):  # every layer, or a hybrid's tail
        with gathered(blocks[l]):
            x = _block_step(blocks[l], cfg, x, _at(layers, l), windows[l], cond)
    x = norm_fwd(model.final_norm, x)
    with gathered(model.embed):
        return logits_fwd(model.embed, cfg, x), state


def prefill(model: DecoderLM, tokens: torch.Tensor, context: int, *,
            cond_embeds: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, DecodeState]:
    """Sequential prefill via decode steps (the reference implementation the
    equivalence tests use).  Returns (last logits, state)."""
    state = init_decode_state(model.cfg, tokens.shape[0], context, device=model.device)
    logits = None
    for i in range(tokens.shape[-1]):
        logits, state = decode_step(model, tokens[..., i:i + 1], state, cond_embeds=cond_embeds)
    return logits, state


# ---------------------------------------------------------------------------
# full sequence
# ---------------------------------------------------------------------------
def attention_fwd_chunked(p: Attention, cfg: ModelConfig, x: torch.Tensor,
                          positions: torch.Tensor, window: int) -> torch.Tensor:
    """Causal (optionally sliding-window) self-attention with O(L·K_block)
    memory: online softmax over k blocks of ``ATTN_K_BLOCK`` for each q
    block of ``ATTN_Q_BLOCK``, accumulated in float32, each q block's output
    cast to ``x.dtype``.  ``window`` ≥ L disables the window.  Raises where
    L is not a multiple of both block sizes."""
    L = x.shape[1]
    QB, KB = ATTN_Q_BLOCK, ATTN_K_BLOCK
    if L % QB or L % KB:
        raise ValueError(f"chunked attention: L={L} must be a multiple of the q block {QB} "
                         f"and the k block {KB}")
    h, kv = cfg.n_heads, cfg.n_kv_heads
    q = shard_heads(split_heads(x @ p.wq, h))
    k = shard_heads(split_heads(x @ p.wk, kv), role="kv")
    v = shard_heads(split_heads(x @ p.wv, kv), role="kv")
    if p.q_norm is not None:
        q = _rms(q, p.q_norm)
        k = _rms(k, p.k_norm)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return on_local_heads(_attend_chunked, q, k, v, window, cfg.attn_softcap) @ p.wo


def _attend_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
                    cap: float) -> torch.Tensor:
    """The online-softmax core of :func:`attention_fwd_chunked`: q [B, L,
    h, hd], k/v [B, L, kv, hd]; returns [B, L, h·hd] in q's dtype."""
    B, L, h, hd = q.shape
    kv = k.shape[2]
    g = h // kv
    QB, KB = ATTN_Q_BLOCK, ATTN_K_BLOCK
    scale = 1.0 / math.sqrt(hd)
    nq, nk = L // QB, L // KB
    qb = q.reshape(B, nq, QB, kv, g, hd)
    kb = k.reshape(B, nk, KB, kv, hd)
    vb = v.reshape(B, nk, KB, kv, hd)
    dev = q.device

    outs = []
    for qi in range(nq):
        q_i = qb[:, qi].float()
        q_pos = qi * QB + torch.arange(QB, device=dev)
        hi = (qi * QB + QB - 1) // KB + 1 if ATTN_UNROLL_Q else nk
        m = torch.full((B, kv, g, QB), -1e30, dtype=torch.float32, device=dev)
        l = torch.zeros((B, kv, g, QB), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, kv, g, QB, hd), dtype=torch.float32, device=dev)
        for kj in range(hi):
            k_j, v_j = kb[:, kj], vb[:, kj]
            k_pos = kj * KB + torch.arange(KB, device=dev)
            s = torch.einsum("bqkgd,bmkd->bkgqm", q_i, k_j.float()) * scale
            s = softcap(s, cap)
            ok = (k_pos[None, :] <= q_pos[:, None]) & (q_pos[:, None] - k_pos[None, :] < window)
            s = torch.where(ok, s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            pexp = torch.exp(s - m_new[..., None])
            l = l * alpha + pexp.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqm,bmkd->bkgqd", pexp.to(v_j.dtype), v_j).float()
            m = m_new
        outs.append((acc / torch.clamp(l[..., None], min=1e-30)).to(q.dtype))  # [B,kv,g,QB,hd]
    out = torch.stack(outs, dim=3).reshape(B, h, L, hd)                       # [B,kv,g,nq,QB,hd]
    return out.transpose(1, 2).reshape(B, L, h * hd)


def _self_attention(p: Attention, cfg: ModelConfig, h: torch.Tensor, positions: torch.Tensor,
                    window: int) -> torch.Tensor:
    L = h.shape[1]
    if L > CHUNKED_ATTN_THRESHOLD:
        return attention_fwd_chunked(p, cfg, h, positions, window)
    i, j = positions[:, None], positions[None, :]
    mask = torch.where((j <= i) & ((i - j) < window), 0.0, -1e30).to(torch.float32)
    return attention_fwd(p, cfg, h, positions, mask)


def _whole_seq(x: torch.Tensor) -> torch.Tensor:
    """The SP → full-sequence gather of a block's input, under a mesh: the
    reference pins it on the normed input before long-sequence attention;
    DTensor needs the whole block on whole sequences (its products cannot
    fold a split sequence into their rows, forward or backward), so the
    residual is gathered on entry and split again by
    :func:`constrain_activation` on exit.  The input itself without a
    mesh."""
    return constrain(x, "data", None, None)


def _block_fwd(blk: Block, cfg: ModelConfig, x: torch.Tensor, positions: torch.Tensor,
               window: int, cond: Optional[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoder block.  Returns (x, aux_loss)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = _whole_seq(x)
    h = norm_fwd(blk.norm1, x)
    if blk.ssm is not None:
        return constrain_activation(x + ssm_fwd(blk.ssm, cfg, h)), aux
    # under a mesh the row-parallel outputs are partial sums over the model
    # axis: finished before they join the whole-sequence residual
    out = reduce_partial(_self_attention(blk.attn, cfg, h, positions, window))
    if blk.post_norm1 is not None:
        out = norm_fwd(blk.post_norm1, out)
    x = x + out
    if cond is not None and blk.xattn is not None:
        hx = norm_fwd(blk.norm_x, x)
        zero = torch.zeros((x.shape[1], cond.shape[1]), dtype=torch.float32, device=x.device)
        x = x + reduce_partial(attention_fwd(blk.xattn, cfg, hx, positions, zero, kv_src=cond))
    h2 = norm_fwd(blk.norm2, x)
    if blk.moe is not None:
        out2, aux = moe_fwd(blk.moe, cfg, h2)
    else:
        out2 = mlp_fwd(blk.mlp, cfg, h2)
    if blk.post_norm2 is not None:
        out2 = norm_fwd(blk.post_norm2, out2)
    return constrain_activation(x + out2), aux


def _shared_block_fwd(p: SharedBlock, cfg: ModelConfig, x: torch.Tensor, x0: torch.Tensor,
                      positions: torch.Tensor, window: int) -> torch.Tensor:
    x, x0 = _whole_seq(x), _whole_seq(x0)
    h = torch.cat([x, x0], dim=-1) @ p.fuse
    h = h + reduce_partial(_self_attention(p.attn, cfg, norm_fwd(p.norm1, h), positions, window))
    h = h + reduce_partial(mlp_fwd(p.mlp, cfg, norm_fwd(p.norm2, h)))
    return x + reduce_partial(h @ p.out)


def forward(model: DecoderLM, tokens: torch.Tensor, *,
            img_embeds: Optional[torch.Tensor] = None,
            cond_embeds: Optional[torch.Tensor] = None,
            return_hidden: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  tokens: [B, L] (or [B, K, L] audio);
    ``img_embeds`` [B, n_img, D] are prepended, ``cond_embeds`` [B, Lc, D]
    feed every cross-attention.  Returns (logits [B, L, V] / [B, K, L, V]
    float32, aux_loss) — or the final normed hidden states in place of the
    logits with ``return_hidden``."""
    cfg = model.cfg
    with gathered(model.embed):
        x = embed_fwd(model.embed, cfg, tokens)
    if img_embeds is not None:
        x = torch.cat([img_embeds.to(x.dtype), x], dim=1)
    x = constrain_activation(x)
    L = x.shape[1]
    positions = torch.arange(L, device=x.device)
    windows = _layer_windows(cfg, L)
    cond = cond_embeds.to(x.dtype) if cond_embeds is not None else None
    remat = cfg.remat and torch.is_grad_enabled()

    def block(l, x):
        with gathered(model.blocks[l]):
            return _block_fwd(model.blocks[l], cfg, x, positions, windows[l], cond)

    def run_block(l, x):
        return checkpoint(block, l, x, use_reentrant=False) if remat else block(l, x)

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    start = 0
    if cfg.shared_attn_every:
        x0 = x
        n_groups, start = _groups(cfg)
        every = cfg.shared_attn_every
        shared_win = min(cfg.sliding_window, L + 1) if cfg.sliding_window else L + 1

        def group(g, x, aux):
            with gathered(model.shared):
                x = _shared_block_fwd(model.shared, cfg, x, x0, positions, shared_win)
            for l in range(g * every, (g + 1) * every):
                x, a = run_block(l, x)
                aux = aux + a
            return x, aux

        for g in range(n_groups):
            # the shared block's activations are not kept per group either
            x, aux = (checkpoint(group, g, x, aux, use_reentrant=False) if remat
                      else group(g, x, aux))
    for l in range(start, cfg.n_layers):  # every layer, or a hybrid's tail
        x, a = run_block(l, x)
        aux = aux + a
    x = norm_fwd(model.final_norm, x)
    if return_hidden:
        return x, aux
    with gathered(model.embed):
        return logits_fwd(model.embed, cfg, x), aux


def prefill_step(model: DecoderLM, tokens: torch.Tensor, *,
                 img_embeds: Optional[torch.Tensor] = None,
                 cond_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Production prefill: the full forward, then the next-token logits of
    the last position only ([B, 1, V] / [B, K, 1, V]).  Under
    ``inference_mode``, or ``no_grad`` under a mesh (DTensor parameters
    cannot run in inference mode)."""
    with torch.no_grad() if ambient_mesh() is not None else torch.inference_mode():
        hidden, _ = forward(model, tokens, img_embeds=img_embeds, cond_embeds=cond_embeds,
                            return_hidden=True)
        with gathered(model.embed):
            return logits_fwd(model.embed, model.cfg, _whole_seq(hidden)[:, -1:, :])
