"""Model configuration schema for all assigned architectures.

One :class:`ModelConfig` describes any member of the supported families:
dense / MoE / SSM / hybrid decoder-only transformers, with optional
modality-frontend stubs (VLM patch embeddings, audio codebooks with
cross-attention conditioning).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

__all__ = ["MoEConfig", "SSMConfig", "ModelConfig"]


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden size
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64             # Mamba2 P (channels per SSD head)
    chunk: int = 256               # SSD chunk length
    n_groups: int = 1              # B/C groups


@dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    # attention
    n_heads: int = 0               # 0 => attention-free (pure SSM)
    n_kv_heads: int = 0
    head_dim: int = 0              # 0 => d_model // n_heads
    # mlp
    d_ff: int = 0
    mlp: str = "swiglu"            # swiglu | geglu | relu2 | gelu
    # block pattern: one char per layer, cycled:  a=attention, s=ssm,
    # l=local(sliding-window) attention, g=global attention
    pattern: str = "a"
    # normalization & stabilizers
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    qk_norm: bool = False
    attn_softcap: float = 0.0      # 0 = off (gemma2: 50.0)
    final_softcap: float = 0.0     # 0 = off (gemma2: 30.0)
    post_block_norm: bool = False  # gemma2 style post-norms
    rope_theta: float = 10000.0
    sliding_window: int = 0        # window for 'l' layers (and SWA archs)
    # families
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # zamba2-style shared attention block applied every `shared_attn_every`
    # blocks (0 = off).  The shared block's parameters are stored ONCE and
    # multi-read by all invocations — the paper's MRB idea applied to params.
    shared_attn_every: int = 0
    # modality frontends (stubs: precomputed embeddings via input_specs)
    n_img_tokens: int = 0          # VLM: patch embeddings prepended
    n_codebooks: int = 0           # audio: EnCodec codebooks (MusicGen: 4)
    n_cond_tokens: int = 0         # audio: cross-attention conditioning length
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    remat: bool = True             # activation checkpointing per block
    scan_layers: bool = True       # lax.scan over stacked layer params

    # ------------------------------------------------------------- derived
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(1, self.n_heads)

    @property
    def attention_free(self) -> bool:
        return self.n_heads == 0

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind from the cycled pattern."""
        p = self.pattern or "a"
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    @property
    def d_inner(self) -> int:
        return (self.ssm.expand * self.d_model) if self.ssm else 0

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm.head_dim if self.ssm else 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # -------------------------------------------------------------- counts
    def _norm_params(self) -> int:
        return 2 * self.d_model if self.norm == "layernorm" else self.d_model

    def _attn_params(self) -> int:
        D, hd = self.d_model, self.resolved_head_dim
        q = D * self.n_heads * hd
        kv = 2 * D * self.n_kv_heads * hd
        o = self.n_heads * hd * D
        return q + kv + o + (2 * hd if self.qk_norm else 0)

    def param_count(self) -> int:
        """Exact parameter count of this implementation (used for roofline
        MODEL_FLOPS = 6·N·D and memory budgeting)."""
        D, V = self.d_model, self.vocab
        n_emb = max(1, self.n_codebooks) if self.n_codebooks else 1
        total = n_emb * V * D              # embed
        if not self.tie_embeddings:
            total += n_emb * D * V
        for kind in self.layer_kinds():
            total += self._norm_params()   # pre-norm
            if kind == "s":
                total += self._ssm_params()
                continue
            total += self._attn_params()
            if self.post_block_norm:
                total += 2 * self._norm_params()
            if self.n_cond_tokens:         # cross-attention (no qk-norm)
                total += self._attn_params() - (2 * self.resolved_head_dim if self.qk_norm else 0)
                total += self._norm_params()
            total += self._norm_params()   # mlp pre-norm
            total += self._mlp_params()
        if self.shared_attn_every and self.n_heads:
            # Zamba2 shared block: fuse + norm + attn + norm + mlp + out
            total += 2 * D * D             # fuse
            total += D * D                 # out
            total += 2 * self._norm_params()
            total += self._attn_params() - (2 * self.resolved_head_dim if self.qk_norm else 0)
            total += self._shared_mlp_params()
        total += self._norm_params()       # final norm
        return total

    def _shared_mlp_params(self) -> int:
        D = self.d_model
        if self.mlp in ("swiglu", "geglu"):
            return 3 * D * self.d_ff
        return 2 * D * self.d_ff

    def _mlp_params(self) -> int:
        D = self.d_model
        if self.moe:
            e = self.moe.num_experts
            per = (
                3 * D * self.moe.d_ff
                if self.mlp in ("swiglu", "geglu")
                else 2 * D * self.moe.d_ff
            )
            return D * e + e * per         # router + experts
        if self.mlp in ("swiglu", "geglu"):
            return 3 * D * self.d_ff
        return 2 * D * self.d_ff

    def _ssm_params(self) -> int:
        D, s = self.d_model, self.ssm
        di = s.expand * D
        ng, ns = s.n_groups, s.d_state
        nh = di // s.head_dim
        conv_dim = di + 2 * ng * ns
        in_proj = D * (2 * di + 2 * ng * ns + nh)
        conv = conv_dim * s.d_conv + conv_dim        # weight + bias
        out = di * D
        # + A_log, D_skip, dt_bias, gated-norm scale
        return in_proj + conv + out + 3 * nh + di

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top-k experts count)."""
        if not self.moe:
            return self.param_count()
        total = self.param_count()
        e, k = self.moe.num_experts, self.moe.top_k
        per = (
            3 * self.d_model * self.moe.d_ff
            if self.mlp in ("swiglu", "geglu")
            else 2 * self.d_model * self.moe.d_ff
        )
        moe_layers = sum(1 for kind in self.layer_kinds() if kind in ("a", "l", "g"))
        return total - moe_layers * (e - k) * per
