"""Gemma-2 9B [arXiv:2408.00118]: alternating local/global attention,
logit soft-capping, GeGLU, post-block norms."""
from ..models.config import ModelConfig
from . import ArchSpec

MODEL = ModelConfig(
    name="gemma2-9b",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab=256000, mlp="geglu", pattern="lg",
    sliding_window=4096, attn_softcap=50.0, final_softcap=30.0,
    post_block_norm=True, tie_embeddings=True,
)
SMOKE = MODEL.replace(
    name="gemma2-smoke", n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=256, vocab=512, sliding_window=64,
    dtype="float32", remat=False,
)
SPEC = ArchSpec(
    name="gemma2-9b", model=MODEL, smoke=SMOKE, long_context_ok=False,
    train_microbatches=2,
    skip_notes={"long_500k": "global layers are full attention over the"
                " entire 500k context (not sub-quadratic)"},
)
