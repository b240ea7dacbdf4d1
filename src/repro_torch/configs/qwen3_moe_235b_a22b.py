"""Qwen3-MoE-235B-A22B [hf:Qwen/Qwen3-30B-A3B family]: 128-expert top-8
fine-grained MoE, GQA kv=4, qk-norm."""
from ..models.config import MoEConfig, ModelConfig
from . import ArchSpec

MODEL = ModelConfig(
    name="qwen3-moe-235b-a22b",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, head_dim=128,
    vocab=151936, mlp="swiglu", pattern="a", qk_norm=True,
    rope_theta=1_000_000.0, tie_embeddings=False,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff=1536),
)
SMOKE = MODEL.replace(
    name="qwen3moe-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, vocab=512, dtype="float32", remat=False,
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=128),
)
SPEC = ArchSpec(
    name="qwen3-moe-235b-a22b", model=MODEL, smoke=SMOKE, long_context_ok=False,
    skip_notes={"long_500k": "pure full attention"},
    optimizer="adafactor", grad_dtype="bfloat16", train_microbatches=8,
)
