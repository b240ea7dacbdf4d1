"""Deterministic synthetic data for the port (numpy streams, torch tensors)."""
from .pipeline import Batch, SyntheticStream, batch_specs, make_batch

__all__ = ["Batch", "SyntheticStream", "make_batch", "batch_specs"]
