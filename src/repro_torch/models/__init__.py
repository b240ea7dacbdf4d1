"""Model zoo of the port: configurations, layers and the decode path."""
from .config import ModelConfig, MoEConfig, SSMConfig
from .model import DecoderLM, decode_step, init_decode_state, init_model, prefill

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "DecoderLM",
    "init_model",
    "init_decode_state",
    "decode_step",
    "prefill",
]
