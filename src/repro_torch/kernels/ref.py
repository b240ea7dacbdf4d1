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

__all__ = [
    "mrb_append_ref", "mrb_append_kv_ref", "mrb_read_window_ref", "decode_attention_ref",
    "decode_attention_split_ref",
]


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


def mrb_append_kv_ref(buf_k: torch.Tensor, buf_v: torch.Tensor, omega: torch.Tensor,
                      k: torch.Tensor, v: torch.Tensor) -> None:
    """The decode step's ring update, in place: ``k`` and ``v`` into slot ω
    of ``buf_k`` and ``buf_v`` (:func:`mrb_append_ref`), then
    ``ω ← (ω + 1) mod C``, floored as the reference's ``(omega + 1) % C``.
    ``omega`` is a one-element int32 tensor."""
    mrb_append_ref(buf_k, omega, k)
    mrb_append_ref(buf_v, omega, v)
    omega.add_(1).remainder_(buf_k.shape[1])


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


def decode_attention_split_ref(
    q: torch.Tensor,
    buf_k: torch.Tensor,
    buf_v: torch.Tensor,
    t,
    window: int = 0,
    softcap: float = 0.0,
    splits: int = 1,
    tile: int = 32,
) -> torch.Tensor:
    """The CUDA kernel's split-and-merge arithmetic, in plain torch.

    Walks the readable positions ``[lo, t]``, ``lo = max(0, t - min(W, C) + 1)``
    (W = ``window``, or C when it is 0), in slots ``p mod C``; cuts them into
    ``splits`` ranges of ``ceil(n / splits)`` positions rounded up to
    ``tile`` (a later range may be empty); computes each range's float32
    partial (m, l, acc) and merges them with weights ``exp(m_r - M)``, an
    empty range (m = -inf) weighing exactly 0 without forming
    ``-inf - (-inf)``.  With no readable position (``t < 0``) it walks all
    C slots with every score 0, so the output is the mean of V over the
    ring, as the reference's softmax over C equally masked scores gives.
    Equals :func:`decode_attention_ref` up to float32 summation order.
    Used by tests and ``chip_smoke.py`` only.
    """
    B, C, kv, d = buf_k.shape
    H = q.shape[1]
    G = H // kv
    t = int(torch.as_tensor(t))
    span = window if 0 < window < C else C
    n = min(t + 1, span) if t >= 0 else C
    lo = t - n + 1 if t >= 0 else 0
    per = -(-n // splits)
    per = -(-per // tile) * tile
    qh = q.reshape(B, kv, G, d).float()
    ms, ls, accs = [], [], []
    for r in range(splits):
        cnt = max(0, min(per, n - r * per))
        if cnt == 0:
            ms.append(torch.full((B, kv, G), -math.inf, device=q.device))
            ls.append(torch.zeros((B, kv, G), device=q.device))
            accs.append(torch.zeros((B, kv, G, d), device=q.device))
            continue
        slot = torch.remainder(lo + r * per + torch.arange(cnt, device=q.device), C)
        if t < 0:  # nothing readable: C equal scores
            s = torch.zeros((B, kv, G, cnt), device=q.device)
        else:
            s = torch.einsum("bkgd,bckd->bkgc", qh, buf_k[:, slot].float()) / math.sqrt(d)
            if softcap > 0:
                s = softcap * torch.tanh(s / softcap)
        m = s.amax(dim=-1)
        p = torch.exp(s - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bkgc,bckd->bkgd", p, buf_v[:, slot].float()))
    m_all = torch.stack(ms)
    top = m_all.amax(dim=0)
    top = torch.where(torch.isinf(top), torch.zeros_like(top), top)  # all empty: every m is -inf
    coef = torch.exp(m_all - top)  # exp(-inf - finite) = 0 for an empty range
    l_tot = (coef * torch.stack(ls)).sum(dim=0)
    acc = (coef[..., None] * torch.stack(accs)).sum(dim=0)
    out = torch.where(l_tot[..., None] > 0, acc / l_tot.clamp_min(1e-30)[..., None],
                      torch.zeros_like(acc))
    return out.reshape(B, H, d).to(q.dtype)
