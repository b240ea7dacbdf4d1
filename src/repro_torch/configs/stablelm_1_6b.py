"""StableLM-2 1.6B [hf:stabilityai/stablelm-2-1_6b]: MHA (kv=heads),
LayerNorm, SwiGLU."""
from ..models.config import ModelConfig
from . import ArchSpec

MODEL = ModelConfig(
    name="stablelm-1.6b",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab=100352, mlp="swiglu", pattern="a", norm="layernorm",
    tie_embeddings=False,
)
SMOKE = MODEL.replace(
    name="stablelm-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    head_dim=32, d_ff=256, vocab=512, dtype="float32", remat=False,
)
SPEC = ArchSpec(
    name="stablelm-1.6b", model=MODEL, smoke=SMOKE, long_context_ok=False,
    skip_notes={"long_500k": "pure full attention",
                "mrb_heads": "kv=heads ⇒ per-head KV sharing degenerates to"
                " one reader; MRB applies only to residual/pipeline channels"},
)
