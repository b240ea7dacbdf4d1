"""Nemotron-4-340B [arXiv:2402.16819]: dense GQA decoder, squared-ReLU MLP."""
from ..models.config import ModelConfig
from . import ArchSpec

MODEL = ModelConfig(
    name="nemotron-4-340b",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8, head_dim=192,
    d_ff=73728, vocab=256000, mlp="relu2", pattern="a",
    rope_theta=10000.0, tie_embeddings=False,
)
SMOKE = MODEL.replace(
    name="nemotron-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=512, vocab=512, dtype="float32", remat=False,
)
SPEC = ArchSpec(
    name="nemotron-4-340b", model=MODEL, smoke=SMOKE, long_context_ok=False,
    skip_notes={"long_500k": "pure full attention; 500k KV is unbounded-window quadratic"},
    optimizer="adafactor", grad_dtype="bfloat16", train_microbatches=16,
)
