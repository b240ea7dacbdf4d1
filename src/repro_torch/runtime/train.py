"""Step factories: the counterpart of the JAX package's ``runtime/train.py``.

It holds only :func:`make_serve_step` for now; the training step lands
here in a later slice of the port.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..models.config import ModelConfig
from ..models.model import DecoderLM, decode_step

__all__ = ["make_serve_step"]


def make_serve_step(cfg: ModelConfig):
    """serve_step(model, tokens, state[, cond_embeds]) → (next_tokens,
    logits, state).  One new greedy token per request ([B, 1], or [B, K, 1]
    for audio) with the MRB ring KV cache; the state is updated in place.
    ``model`` must have been built for ``cfg``."""

    def serve_step(model: DecoderLM, tokens: torch.Tensor, state,
                   cond_embeds: Optional[torch.Tensor] = None):
        if model.cfg != cfg:
            raise ValueError(f"serve_step for {cfg.name} got a model of {model.cfg.name}")
        logits, state = decode_step(model, tokens, state, cond_embeds=cond_embeds)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        return nxt, logits, state

    return serve_step
