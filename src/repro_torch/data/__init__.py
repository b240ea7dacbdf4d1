"""Deterministic synthetic data for the port (numpy streams, torch tensors)."""
from .pipeline import Batch, SyntheticStream, make_batch

__all__ = ["Batch", "SyntheticStream", "make_batch"]
