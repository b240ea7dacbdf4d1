"""Optimizers of the port: AdamW, Adafactor, clipping, schedule, int8
error-feedback compression (the counterpart of ``repro.optim``)."""
from .compression import (compressed_psum, init_error_state, int8_decompress,
                          int8_error_feedback_compress)
from .optimizers import (
    OptState,
    adafactor,
    adamw,
    clip_by_global_norm,
    cosine_schedule,
    make_optimizer,
)

__all__ = [
    "OptState",
    "adamw",
    "adafactor",
    "clip_by_global_norm",
    "cosine_schedule",
    "make_optimizer",
    "int8_error_feedback_compress",
    "int8_decompress",
    "compressed_psum",
    "init_error_state",
]
