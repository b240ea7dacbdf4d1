"""Mixtral-8x7B [arXiv:2401.04088]: 8-expert top-2 MoE, GQA, sliding-window
attention (window 4096 ⇒ sub-quadratic ⇒ long_500k runs)."""
from ..models.config import MoEConfig, ModelConfig
from . import ArchSpec

MODEL = ModelConfig(
    name="mixtral-8x7b",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    vocab=32000, mlp="swiglu", pattern="a", sliding_window=4096,
    rope_theta=1_000_000.0, tie_embeddings=False,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=14336),
)
SMOKE = MODEL.replace(
    name="mixtral-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, vocab=512, sliding_window=64, dtype="float32", remat=False,
    moe=MoEConfig(num_experts=4, top_k=2, d_ff=256),
)
SPEC = ArchSpec(
    name="mixtral-8x7b", model=MODEL, smoke=SMOKE, long_context_ok=True,
    train_microbatches=4,
)
