"""Zamba2-7B [arXiv:2411.15242]: Mamba2 backbone + one SHARED attention
block invoked every 6 blocks — the shared block's parameters are stored
once and multi-read (the paper's MRB idea applied to parameters).  The
shared attention uses a 4096 sliding window (long-context adaptation,
documented in DESIGN.md) ⇒ sub-quadratic ⇒ long_500k runs."""
from ..models.config import ModelConfig, SSMConfig
from . import ArchSpec

MODEL = ModelConfig(
    name="zamba2-7b",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab=32000, pattern="s", shared_attn_every=6,
    sliding_window=4096, tie_embeddings=True,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=256),
)
SMOKE = MODEL.replace(
    name="zamba2-smoke", n_layers=7, d_model=128, n_heads=4, n_kv_heads=4,
    head_dim=32, d_ff=256, vocab=512, shared_attn_every=3, sliding_window=64,
    dtype="float32", remat=False,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32),
)
SPEC = ArchSpec(
    name="zamba2-7b", model=MODEL, smoke=SMOKE, long_context_ok=True,
    train_microbatches=4,
)
