"""Int8 error-feedback gradient compression.

The counterpart of the JAX package's ``optim/compression.py``: a tensor is
quantized to int8 with one float32 scale *after adding the carried
error-feedback residual*, and the quantization error is carried into the
next step, so the bias does not accumulate.  The reduction that sends the
int8 values over the wire (``compressed_psum``) is a collective and comes
with distribution (ROADMAP module item 11).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

__all__ = ["int8_error_feedback_compress", "int8_decompress", "init_error_state"]


def int8_error_feedback_compress(g: torch.Tensor, err: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q int8, scale float32, new_err)."""
    gf = g.to(torch.float32) + err
    scale = gf.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, gf - deq


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A float32 zero residual for each of ``model``'s parameters, by name."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in model.named_parameters()}
