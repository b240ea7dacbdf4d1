"""Model assembly, decode half: dense attention decoders.

Counterpart of the decode half of the JAX package's ``models/model.py``.
:class:`DecoderLM` holds the weights as ``nn.Module`` s named after the JAX
tree (``embed.tok``, ``blocks.<l>.attn.wq``, ``blocks.<l>.post_norm1.scale``,
``final_norm.scale``, …), one module per layer where JAX stacks layers on
axis 0.  :func:`decode_step` runs one token per request through every
layer with the MRB ring KV cache of :func:`init_decode_state`, which it
updates in place; :func:`prefill` is sequential decode steps.

The full-sequence ``forward``/``prefill_step``/``attention_fwd_chunked``,
MoE, SSM and hybrid blocks, cross-attention and image/audio inputs are not
ported yet: a configuration that needs them makes :class:`DecoderLM` raise
``NotImplementedError``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..device import resolve_device
from .config import ModelConfig
from .layers import (
    MLP,
    Attention,
    Embed,
    Norm,
    attention_decode,
    embed_fwd,
    logits_fwd,
    mlp_fwd,
    norm_fwd,
    torch_dtype,
)

__all__ = ["DecoderLM", "init_model", "init_decode_state", "decode_step", "prefill",
           "decode_windows"]

DecodeState = Dict[str, Dict[str, torch.Tensor]]


def _unsupported(cfg: ModelConfig) -> Optional[str]:
    if cfg.moe:
        return "MoE blocks (ROADMAP module item 9: models/moe.py)"
    if "s" in cfg.layer_kinds() or cfg.ssm:
        return "SSM blocks (ROADMAP module item 9: models/ssm.py)"
    if cfg.shared_attn_every:
        return "Zamba2 shared attention (ROADMAP module item 9: the hybrid branch)"
    if cfg.n_cond_tokens:
        return "cross-attention (ROADMAP module item 9: cross-attention)"
    if cfg.n_img_tokens or cfg.n_codebooks:
        return "image or audio inputs (ROADMAP module item 9: image and audio inputs)"
    return None


class Block(nn.Module):
    """One dense attention block: pre-norms, optional Gemma-2 post-norms."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.norm1 = Norm(cfg, cfg.d_model, device)
        self.attn = Attention(cfg, device=device)
        if cfg.post_block_norm:
            self.post_norm1 = Norm(cfg, cfg.d_model, device)
            self.post_norm2 = Norm(cfg, cfg.d_model, device)
        else:
            self.post_norm1 = self.post_norm2 = None
        self.norm2 = Norm(cfg, cfg.d_model, device)
        self.mlp = MLP(cfg, device=device)


class DecoderLM(nn.Module):
    """Dense decoder-only LM with the JAX package's parameter tree.

    Constructed empty (``torch.empty``); :func:`init_model` fills it at
    random and :func:`repro_torch.bridge.params_from_jax` from a JAX tree.
    """

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        why = _unsupported(cfg)
        if why:
            raise NotImplementedError(f"{cfg.name}: the port does not run {why} yet")
        self.cfg = cfg
        self.embed = Embed(cfg, device)
        self.blocks = nn.ModuleList(Block(cfg, device) for _ in range(cfg.n_layers))
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


def init_model(cfg: ModelConfig, *, seed: int = 0, device="cuda") -> DecoderLM:
    """Random weights with the JAX package's scales, drawn from a
    ``torch.Generator`` seeded with ``seed`` on the target device, directly
    in ``cfg.dtype`` (matrices) and float32 (norm scales)."""
    dev = resolve_device(device)
    model = DecoderLM(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (Norm, Attention, MLP, Embed)):
            m.reset_parameters(gen)
    return model


def init_decode_state(cfg: ModelConfig, batch: int, context: int, dtype=None,
                      device="cuda") -> DecodeState:
    """Stacked MRB ring KV cache: ``k``/``v [n_layers, B, C, kv, d]`` in
    ``dtype`` (default ``cfg.dtype``) and per-layer int32 ``omega``/``t``
    ``[n_layers]``, all on the device.  Every layer has the same capacity,
    the largest any layer needs (sliding window where bounded, else
    ``context``); windows bound the local layers."""
    why = _unsupported(cfg)
    if why:
        raise NotImplementedError(f"{cfg.name}: the port does not run {why} yet")
    dev = resolve_device(device)
    dt = torch_dtype(cfg.dtype if dtype is None else dtype)
    cap = max(min(context, w) if w else context for w in decode_windows(cfg))
    L, kv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
    return {"layers": {
        "k": torch.zeros((L, batch, cap, kv, hd), dtype=dt, device=dev),
        "v": torch.zeros((L, batch, cap, kv, hd), dtype=dt, device=dev),
        "omega": torch.zeros((L,), dtype=torch.int32, device=dev),
        "t": torch.zeros((L,), dtype=torch.int32, device=dev),
    }}


@torch.no_grad()
def decode_step(model: DecoderLM, tokens: torch.Tensor, state: DecodeState
                ) -> Tuple[torch.Tensor, DecodeState]:
    """One decode step.  tokens: [B, 1].  Returns (logits [B, 1, V] float32,
    state), the state updated in place."""
    cfg = model.cfg
    x = embed_fwd(model.embed, cfg, tokens)
    layers = state["layers"]
    for l, (blk, window) in enumerate(zip(model.blocks, model.windows)):
        cache = {name: buf[l] for name, buf in layers.items()}
        out, _ = attention_decode(blk.attn, cfg, norm_fwd(blk.norm1, x), cache, window)
        if blk.post_norm1 is not None:
            out = norm_fwd(blk.post_norm1, out)
        x = x + out
        out2 = mlp_fwd(blk.mlp, cfg, norm_fwd(blk.norm2, x))
        if blk.post_norm2 is not None:
            out2 = norm_fwd(blk.post_norm2, out2)
        x = x + out2
    x = norm_fwd(model.final_norm, x)
    return logits_fwd(model.embed, cfg, x), state


def prefill(model: DecoderLM, tokens: torch.Tensor, context: int
            ) -> Tuple[torch.Tensor, DecodeState]:
    """Sequential prefill via decode steps (the reference implementation the
    equivalence tests use).  Returns (last logits [B, 1, V], state)."""
    state = init_decode_state(model.cfg, tokens.shape[0], context, device=model.device)
    logits = None
    for i in range(tokens.shape[-1]):
        logits, state = decode_step(model, tokens[..., i:i + 1], state)
    return logits, state
