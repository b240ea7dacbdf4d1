"""Mamba2-370M [arXiv:2405.21060]: attention-free SSD, O(1) decode state
⇒ long_500k runs."""
from ..models.config import ModelConfig, SSMConfig
from . import ArchSpec

MODEL = ModelConfig(
    name="mamba2-370m",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50280, pattern="s", tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
)
SMOKE = MODEL.replace(
    name="mamba2-smoke", n_layers=2, d_model=128, vocab=512,
    dtype="float32", remat=False,
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32, chunk=32),
)
SPEC = ArchSpec(
    name="mamba2-370m", model=MODEL, smoke=SMOKE, long_context_ok=True,
    skip_notes={"mrb_kv": "attention-free: KV-level MRB inapplicable; MRB"
                " applies to residual/stream channels and the conv ring state"},
)
