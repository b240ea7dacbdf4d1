"""Plain torch versions of the MRB ring kernels.

They compute what the JAX package's ``kernels/ref.py`` oracles compute and
are what the kernel wrappers run on CPU tensors; ``chip_smoke.py`` and the
card tests hold the CUDA kernels against them.  Unlike the functional JAX
oracles, :func:`mrb_append_ref` writes its slot in place.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = ["mrb_append_ref", "mrb_read_window_ref", "decode_attention_ref"]


def mrb_append_ref(buf: torch.Tensor, omega: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """Write one token into the ring at slot ω, in place; returns ``buf``.

    buf:   [B, C, H, d]   ring buffer (capacity C)
    omega: []             write index (int32 tensor or int); as in
                          ``dynamic_update_slice``, a negative index counts
                          from the end (ω + C) and the result is clamped
                          into [0, C)
    token: [B, 1, H, d]   cast to ``buf.dtype``
    """
    C = buf.shape[1]
    idx = torch.as_tensor(omega, device=buf.device).reshape(1).long()
    idx = torch.where(idx < 0, idx + C, idx).clamp(0, C - 1)
    return buf.index_copy_(1, idx, token.to(buf.dtype))


def mrb_read_window_ref(
    buf: torch.Tensor, t: torch.Tensor, window: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather the last ``window`` tokens (positions t-window+1 … t) in ring
    order.  Returns (tokens [B, window, H, d], validity [window]).

    Window entry w maps to position t − window + 1 + w, held in slot
    (t − window + 1 + w) mod C (floored); it is valid iff that position ≥ 0.
    """
    C = buf.shape[1]
    w = torch.arange(window, device=buf.device)
    pos = torch.as_tensor(t, device=buf.device) - window + 1 + w
    slot = torch.remainder(pos, C)
    return buf.index_select(1, slot), pos >= 0


def decode_attention_ref(
    q: torch.Tensor,
    buf_k: torch.Tensor,
    buf_v: torch.Tensor,
    t: torch.Tensor,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Multi-reader GQA decode attention over the MRB ring cache.

    q:          [B, H, d]       H = kv_heads · G query-head readers
    buf_k/v:    [B, C, kv, d]   one ring per kv head, written once (MRB)
    t:          []              current absolute position (token t just
                                written at slot t mod C)
    window:     attend to the last ``window`` positions (0 = unlimited)
    Returns [B, H, d] in ``q.dtype``; scores, softmax and P·V in float32.
    """
    B, C, kv, d = buf_k.shape
    H = q.shape[1]
    G = H // kv
    qh = q.reshape(B, kv, G, d).float()
    slot = torch.arange(C, device=q.device)
    t = torch.as_tensor(t, device=q.device)
    slot_pos = t - torch.remainder(t - slot, C)
    valid = slot_pos >= 0
    if window > 0:
        valid &= slot_pos > t - window
    s = torch.einsum("bkgd,bckd->bkgc", qh, buf_k.float()) / math.sqrt(d)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckd->bkgd", p, buf_v.float())
    return out.reshape(B, H, d).to(q.dtype)
