"""Architecture registry: ``get_config(name)`` → :class:`ArchSpec`.

Each assigned architecture has one module defining the exact published
configuration, a reduced smoke configuration of the same family, and its
shape-cell applicability (long_500k only for sub-quadratic archs)."""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

from ..models.config import ModelConfig

__all__ = ["ArchSpec", "Shape", "get_config", "list_archs", "SHAPES"]


@dataclass(frozen=True)
class Shape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[Shape, ...] = (
    Shape("train_4k", 4_096, 256, "train"),
    Shape("prefill_32k", 32_768, 32, "prefill"),
    Shape("decode_32k", 32_768, 128, "decode"),
    Shape("long_500k", 524_288, 1, "decode"),
)


@dataclass(frozen=True)
class ArchSpec:
    name: str
    model: ModelConfig
    smoke: ModelConfig                      # reduced same-family config
    long_context_ok: bool = False           # sub-quadratic ⇒ run long_500k
    skip_notes: Dict[str, str] = field(default_factory=dict)
    optimizer: str = "adamw"                # adafactor for the very large
    train_microbatches: int = 1             # gradient-accumulation splits
    grad_dtype: str = "float32"             # bfloat16 for the 100B+ models

    def applicable(self, shape: Shape) -> bool:
        if shape.name == "long_500k" and not self.long_context_ok:
            return False
        return True


_ARCHS = (
    "nemotron_4_340b",
    "qwen3_0_6b",
    "gemma2_9b",
    "stablelm_1_6b",
    "mixtral_8x7b",
    "qwen3_moe_235b_a22b",
    "mamba2_370m",
    "internvl2_2b",
    "musicgen_medium",
    "zamba2_7b",
)

# assigned IDs (with dots) → module names
_CANON = {
    "nemotron-4-340b": "nemotron_4_340b",
    "qwen3-0.6b": "qwen3_0_6b",
    "gemma2-9b": "gemma2_9b",
    "stablelm-1.6b": "stablelm_1_6b",
    "mixtral-8x7b": "mixtral_8x7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "mamba2-370m": "mamba2_370m",
    "internvl2-2b": "internvl2_2b",
    "musicgen-medium": "musicgen_medium",
    "zamba2-7b": "zamba2_7b",
}


def list_archs():
    return list(_CANON)


def get_config(name: str) -> ArchSpec:
    mod_name = _CANON.get(name) or name.replace("-", "_").replace(".", "_")
    if mod_name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {list_archs()}")
    mod = importlib.import_module(f"{__name__}.{mod_name}")
    return mod.SPEC
