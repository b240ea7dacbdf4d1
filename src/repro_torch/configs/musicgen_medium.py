"""MusicGen-medium [arXiv:2306.05284]: decoder-only over 4 EnCodec
codebooks (delay pattern applied by the data pipeline), cross-attention to
a conditioning STUB (input_specs provides precomputed T5 embeddings)."""
from ..models.config import ModelConfig
from . import ArchSpec

MODEL = ModelConfig(
    name="musicgen-medium",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab=2048, mlp="gelu", pattern="a", norm="layernorm",
    n_codebooks=4, n_cond_tokens=256, tie_embeddings=False,
)
SMOKE = MODEL.replace(
    name="musicgen-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    head_dim=32, d_ff=256, vocab=128, n_codebooks=2, n_cond_tokens=16,
    dtype="float32", remat=False,
)
SPEC = ArchSpec(
    name="musicgen-medium", model=MODEL, smoke=SMOKE, long_context_ok=False,
    skip_notes={"long_500k": "full attention over EnCodec token stream"},
    train_microbatches=4,
)
