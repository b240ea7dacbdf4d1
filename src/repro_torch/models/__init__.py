"""Model zoo of the port: configurations, layers, SSM and MoE blocks, the
decode path and the full-sequence forward."""
from .config import ModelConfig, MoEConfig, SSMConfig
from .model import (
    DecoderLM,
    decode_step,
    forward,
    init_decode_state,
    init_model,
    prefill,
    prefill_step,
)

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "DecoderLM",
    "init_model",
    "init_decode_state",
    "decode_step",
    "prefill",
    "prefill_step",
    "forward",
]
