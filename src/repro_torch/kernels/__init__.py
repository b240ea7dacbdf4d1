"""Hand-written Hopper kernels of the port and their wrappers."""
from .ops import ring_append, ring_append_kv, ring_decode_attention

__all__ = ["ring_append", "ring_append_kv", "ring_decode_attention"]
