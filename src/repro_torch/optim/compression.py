"""Int8 error-feedback gradient compression.

The counterpart of the JAX package's ``optim/compression.py``: a tensor is
quantized to int8 with one float32 scale *after adding the carried
error-feedback residual*, and the quantization error is carried into the
next step, so the bias does not accumulate.  :func:`compressed_psum` is
the mean-reduction over a process group that moves the int8 values (and
one float32 scale per rank) on the wire, a 4× cut of the gradient bytes
against float32.

The error state is kept per leaf of the reference's tree
(``models/tree.py``): one float32 residual in the leaf's stacked shape, as
the reference's ``init_error_state`` gives it.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist
from torch import nn

from ..models import tree

__all__ = ["int8_error_feedback_compress", "int8_decompress", "compressed_psum",
           "init_error_state"]


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def int8_error_feedback_compress(g: torch.Tensor, err: torch.Tensor
                                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (q int8, scale float32, new_err)."""
    gf = g.to(torch.float32) + err
    # a tensor divisor: CUDA divides by a Python number through its
    # reciprocal, one ulp off the CPU's (and the reference's) quotient
    scale = gf.abs().max() / _f32(127.0, gf.device) + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return q, scale, gf - deq


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def init_error_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A float32 zero residual for each leaf of the reference's tree of
    ``model``, by its dotted key, in the leaf's stacked shape."""
    dev = next(model.parameters()).device
    return {k: torch.zeros(leaf.shape, dtype=torch.float32, device=dev)
            for k, leaf in tree.layout(model.cfg).items()}


def compressed_psum(g: torch.Tensor, err: torch.Tensor, group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8-compressed mean of ``g`` over ``group``'s ranks: each rank
    quantizes ``g + err``, the int8 values and the float32 scales are
    all-gathered (flat outputs: gloo refuses a stacked one), and each rank
    sums the dequantized values in rank order and divides by n.  Returns
    (mean float32, new_err).  Collectives stay on ``g``'s device."""
    q, scale, new_err = int8_error_feedback_compress(g, err)
    n = dist.get_world_size(group)
    qs = torch.empty(n * q.numel(), dtype=torch.int8, device=q.device)
    dist.all_gather_into_tensor(qs, q.reshape(-1).contiguous(), group=group)
    ss = torch.empty(n, dtype=torch.float32, device=q.device)
    dist.all_gather_into_tensor(ss, scale.reshape(1), group=group)
    qs = qs.view((n,) + tuple(q.shape))
    summed = qs[0].to(torch.float32) * ss[0]
    for r in range(1, n):
        summed = summed + qs[r].to(torch.float32) * ss[r]
    return summed / _f32(n, summed.device), new_err
