"""InternVL2-2B [arXiv:2404.16821]: InternLM2-1.8B language backbone behind
an InternViT frontend STUB (input_specs provides 256 precomputed patch
embeddings prepended to the text sequence)."""
from ..models.config import ModelConfig
from . import ArchSpec

MODEL = ModelConfig(
    name="internvl2-2b",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=92553, mlp="swiglu", pattern="a",
    n_img_tokens=256, tie_embeddings=False,
)
SMOKE = MODEL.replace(
    name="internvl2-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    head_dim=32, d_ff=256, vocab=512, n_img_tokens=16,
    dtype="float32", remat=False,
)
SPEC = ArchSpec(
    name="internvl2-2b", model=MODEL, smoke=SMOKE, long_context_ok=False,
    skip_notes={"long_500k": "pure full attention"},
)
