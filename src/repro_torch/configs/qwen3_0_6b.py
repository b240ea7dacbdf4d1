"""Qwen3-0.6B [hf:Qwen/Qwen3-8B family]: GQA + per-head qk-norm, SwiGLU."""
from ..models.config import ModelConfig
from . import ArchSpec

MODEL = ModelConfig(
    name="qwen3-0.6b",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=3072, vocab=151936, mlp="swiglu", pattern="a", qk_norm=True,
    rope_theta=1_000_000.0, tie_embeddings=True,
)
SMOKE = MODEL.replace(
    name="qwen3-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=256, vocab=512, dtype="float32", remat=False,
)
SPEC = ArchSpec(
    name="qwen3-0.6b", model=MODEL, smoke=SMOKE, long_context_ok=False,
    skip_notes={"long_500k": "pure full attention"},
)
