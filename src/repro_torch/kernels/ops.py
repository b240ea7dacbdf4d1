"""Public kernel entry points of the port.

The counterpart of the JAX package's ``kernels/ops.py`` without its
``use_pallas``/``interpret`` switches: the tensors' device decides.  A CPU
tensor goes to the plain torch version; a CUDA tensor goes to the
hand-written kernel, or the call raises.

``ring_append(buf, omega, token)`` is :func:`.mrb_ring.mrb_append` (in
place); ``ring_append_kv(buf_k, buf_v, omega, k, v)`` is
:func:`.mrb_ring.mrb_append_kv`, the decode step's K and V write and ω
advance in one call (in place); ``ring_decode_attention(q, buf_k, buf_v,
t, *, window, softcap)`` is :func:`.decode_attention.mrb_decode_attention`.
"""
from __future__ import annotations

from .decode_attention import mrb_decode_attention as ring_decode_attention
from .mrb_ring import mrb_append as ring_append
from .mrb_ring import mrb_append_kv as ring_append_kv

__all__ = ["ring_append", "ring_append_kv", "ring_decode_attention"]
