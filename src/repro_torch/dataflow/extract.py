"""Model → application-graph extraction: the bridge from the LM framework
to the paper's formalism.

A model configuration at a given shape becomes a dataflow application
graph whose actors are pipeline stages (groups of decoder blocks) plus the
modality/embedding frontends, and whose channels carry the real activation
buffers (token size φ = actual bytes per microbatch).  The *multi-cast
actors* are the model's genuine fan-out points:

  * MusicGen: the conditioning embeddings are read by the cross-attention
    of every block — one producer, ``n_stages`` readers.  Replicating per
    stage (multi-cast) costs n_stages·φ; an MRB stores them once.
  * Zamba2: the initial embedding x0 is concatenated into every shared-
    attention invocation — again one producer, many readers.
  * MoE: the router's dispatched token buffers fan out to top-k expert
    banks.
  * GQA decode: each KV page is read by n_heads/n_kv_heads query groups
    (modeled at stage granularity as one KV channel per stage with the
    reader multiplicity folded into φ).

The resulting specification graph feeds the unmodified paper machinery
(selective MRB replacement, channel placement, CAPS-HMS / ILP, NSGA-II),
so the trade-off the paper studies — buffer sharing vs. period — is
explored for the actual LM workloads.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional

from ..core.graph import ApplicationGraph
from ..models.config import ModelConfig

__all__ = ["extract_application_graph", "stage_flops", "ExtractOptions"]


@dataclass(frozen=True)
class ExtractOptions:
    n_stages: int = 16          # blocks grouped into pipeline stages
    microbatch: int = 8         # tokens batch split for pipelining
    kind: str = "train"         # train | decode
    time_unit_us: float = 1.0


def stage_flops(cfg: ModelConfig, tokens: int, blocks: int, seq_len: int) -> float:
    """Forward+backward FLOPs of `blocks` decoder blocks on `tokens` tokens
    (6·params_active·tokens plus quadratic attention term)."""
    per_layer = (cfg.active_param_count() - cfg.vocab * cfg.d_model * (
        2 if not cfg.tie_embeddings else 1)) / max(1, cfg.n_layers)
    flops = 6.0 * per_layer * tokens * blocks
    if cfg.n_heads:
        attn_ctx = min(seq_len, cfg.sliding_window or seq_len)
        flops += blocks * 4.0 * tokens * attn_ctx * cfg.n_heads * cfg.resolved_head_dim * 3
    return flops


def extract_application_graph(
    cfg: ModelConfig,
    seq_len: int,
    batch: int,
    opts: Optional[ExtractOptions] = None,
) -> ApplicationGraph:
    """Build the application graph for one (arch × shape) workload."""
    o = opts or ExtractOptions()
    g = ApplicationGraph(f"{cfg.name}:{o.kind}")
    n_stages = min(o.n_stages, cfg.n_layers)
    blocks_per_stage = cfg.n_layers / n_stages
    mb_tokens = (batch // max(1, o.microbatch)) * (seq_len if o.kind == "train" else 1)
    act_bytes = max(1, (batch // max(1, o.microbatch))) * (
        seq_len if o.kind == "train" else 1
    ) * cfg.d_model * 2  # bf16 residual activation per microbatch

    # Execution times in µs per core type from the roofline of the
    # modelled TPU pod (ϑ1 = v5p-class 459 TF, ϑ2 = v5e 197 TF, ϑ3 =
    # v4-class 138 TF per chip-group): model parameters, not measurements.
    peak = {"t1": 459e12, "t2": 197e12, "t3": 138e12}

    def et(flops: float) -> Dict[str, int]:
        return {
            k: max(1, int(math.ceil(flops / p / 16 / (o.time_unit_us * 1e-6))))
            for k, p in peak.items()
        }

    emb_flops = 2.0 * mb_tokens * cfg.d_model  # gather + scale
    g.add_actor("embed", et(emb_flops * 100))  # embedding bandwidth-bound proxy
    stage_names = []
    for s in range(n_stages):
        name = f"stage{s}"
        stage_names.append(name)
        g.add_actor(name, et(stage_flops(cfg, mb_tokens, blocks_per_stage, seq_len)))
    head_flops = 2.0 * mb_tokens * cfg.d_model * cfg.vocab * (
        3 if o.kind == "train" else 1
    )
    g.add_actor("head", et(head_flops))

    prev = "embed"
    for s, name in enumerate(stage_names):
        g.add_channel(
            f"resid{s}", prev, name, token_bytes=act_bytes, capacity=2, delay=1
        )
        prev = name
    g.add_channel(
        f"resid{n_stages}", prev, "head", token_bytes=act_bytes, capacity=2, delay=1
    )

    # --- fan-out points (the multi-cast actors to explore with ξ) --------
    if cfg.n_cond_tokens:
        # MusicGen conditioning: one producer, every stage a reader.
        cond_bytes = max(1, batch // max(1, o.microbatch)) * cfg.n_cond_tokens * cfg.d_model * 2
        g.add_actor("cond_src", et(2.0 * cfg.n_cond_tokens * cfg.d_model * 1000))
        g.add_actor("cond_cast", et(cond_bytes // 64), multicast=True)
        g.add_channel("cond_in", "cond_src", "cond_cast", token_bytes=cond_bytes,
                      capacity=1, delay=1)
        for s, name in enumerate(stage_names):
            g.add_channel(
                f"cond_out{s}", "cond_cast", name, token_bytes=cond_bytes, capacity=1
            )

    if cfg.shared_attn_every:
        # Zamba2: x0 read by every shared-attention invocation.
        g.add_actor("x0_cast", et(act_bytes // 64), multicast=True)
        g.add_channel("x0_in", "embed", "x0_cast", token_bytes=act_bytes,
                      capacity=1, delay=1)
        for s, name in enumerate(stage_names):
            g.add_channel(
                f"x0_out{s}", "x0_cast", name, token_bytes=act_bytes, capacity=1
            )

    if cfg.moe:
        # One representative router fan-out per stage: dispatched tokens
        # read by top-k expert banks (collapsed to min(k, 4) reader banks).
        banks = min(cfg.moe.top_k, 4)
        disp_bytes = act_bytes // max(1, cfg.moe.num_experts // cfg.moe.top_k)
        for s, name in enumerate(stage_names):
            g.add_actor(f"router{s}", et(2.0 * mb_tokens * cfg.moe.num_experts),
                        multicast=True)
            g.add_actor(f"combine{s}", et(2.0 * mb_tokens * cfg.d_model))
            g.add_channel(f"moe_in{s}", name, f"router{s}",
                          token_bytes=disp_bytes, capacity=1)
            for b in range(banks):
                g.add_actor(f"exp{s}_{b}", et(
                    6.0 * mb_tokens * cfg.d_model * cfg.moe.d_ff * cfg.moe.top_k / banks
                ))
                g.add_channel(f"moe_disp{s}_{b}", f"router{s}", f"exp{s}_{b}",
                              token_bytes=disp_bytes, capacity=1)
                g.add_channel(f"moe_out{s}_{b}", f"exp{s}_{b}", f"combine{s}",
                              token_bytes=disp_bytes, capacity=1, delay=1)

    g.validate()
    return g
