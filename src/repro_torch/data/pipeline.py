"""Deterministic synthetic data pipeline.

The counterpart of the JAX package's ``data/pipeline.py``: the same numpy
streams, so the tokens are bit-identical, handed out as torch tensors on a
given device.

  * *stateless indexing* — batch(step) is a pure function of (seed, step),
    so a restart resumes bit-identically with no data state to persist;
  * *per-host sharding* — each host materializes only its slice of the
    global batch;
  * token streams built from a linear-congruential generator (cheap, seeds
    the whole fleet identically without a filesystem).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig

__all__ = ["Batch", "SyntheticStream", "make_batch", "batch_specs"]

Batch = Dict[str, torch.Tensor]


def _lcg(seed: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):  # modular 2^64 arithmetic is intended
        return (
            seed * np.uint64(6364136223846793005) + np.uint64(1442695040888963407)
        ).astype(np.uint64)


@dataclass
class SyntheticStream:
    """Deterministic, resumable token stream."""

    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    device: str = "cuda"

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.host_count:
            raise ValueError(
                f"global batch {self.global_batch} does not split over {self.host_count} hosts"
            )
        return self.global_batch // self.host_count

    def batch(self, step: int) -> Batch:
        """Pure function of (seed, step): the resume contract."""
        return make_batch(
            self.cfg,
            self.seq_len,
            self.host_batch,
            seed=np.uint64(self.seed)
            + np.uint64(step) * np.uint64(self.host_count)
            + np.uint64(self.host_index),
            device=self.device,
        )


def _tokens(seed: np.uint64, shape: Tuple[int, ...], vocab: int) -> np.ndarray:
    n = int(np.prod(shape))
    with np.errstate(over="ignore"):
        idx = np.arange(n, dtype=np.uint64) + seed * np.uint64(0x9E3779B97F4A7C15)
    x = _lcg(_lcg(idx))
    return (x % np.uint64(vocab)).astype(np.int32).reshape(shape)


def _embeds(seed: np.uint64, shape: Tuple[int, ...]) -> np.ndarray:
    n = int(np.prod(shape))
    with np.errstate(over="ignore"):
        idx = np.arange(n, dtype=np.uint64) + seed * np.uint64(0xD1B54A32D192ED03)
    x = _lcg(idx)
    u = (x >> np.uint64(11)).astype(np.float64) / float(1 << 53)
    return ((u - 0.5) * 0.25).astype(np.float32).reshape(shape)


def make_batch(cfg: ModelConfig, seq_len: int, batch: int, seed: np.uint64 = np.uint64(0),
               *, device="cuda") -> Batch:
    """Tokens + next-token labels (+ modality stubs) on ``device``.  Loss
    positions with label -100 are masked (image prefix, last position)."""
    dev = resolve_device(device)

    def put(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    out: Batch = {}
    if cfg.n_codebooks:
        toks = _tokens(seed, (batch, cfg.n_codebooks, seq_len), cfg.vocab)
        labels = np.concatenate(
            [toks[..., 1:], np.full((batch, cfg.n_codebooks, 1), -100, np.int32)], -1
        )
        out["tokens"] = put(toks)
        out["labels"] = put(labels)
        out["cond_embeds"] = put(
            _embeds(seed + np.uint64(1), (batch, cfg.n_cond_tokens, cfg.d_model))
        )
        return out
    if cfg.n_img_tokens:
        text_len = seq_len - cfg.n_img_tokens
        toks = _tokens(seed, (batch, text_len), cfg.vocab)
        out["img_embeds"] = put(
            _embeds(seed + np.uint64(2), (batch, cfg.n_img_tokens, cfg.d_model))
        )
        # labels over the full (img+text) sequence; img positions masked
        lab = np.full((batch, seq_len), -100, np.int32)
        lab[:, cfg.n_img_tokens : seq_len - 1] = toks[:, 1:]
        out["tokens"] = put(toks)
        out["labels"] = put(lab)
        return out
    toks = _tokens(seed, (batch, seq_len), cfg.vocab)
    labels = np.concatenate([toks[:, 1:], np.full((batch, 1), -100, np.int32)], -1)
    out["tokens"] = put(toks)
    out["labels"] = put(labels)
    return out


def batch_specs(cfg: ModelConfig, seq_len: int, global_batch: int) -> Batch:
    """The batch's shapes and dtypes as ``device="meta"`` tensors (no
    allocation): the reference's ``ShapeDtypeStruct`` stand-ins."""
    def spec(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cfg.n_codebooks:
        return {
            "tokens": spec(global_batch, cfg.n_codebooks, seq_len),
            "labels": spec(global_batch, cfg.n_codebooks, seq_len),
            "cond_embeds": spec(global_batch, cfg.n_cond_tokens, cfg.d_model, dtype=torch.float32),
        }
    if cfg.n_img_tokens:
        return {
            "tokens": spec(global_batch, seq_len - cfg.n_img_tokens),
            "labels": spec(global_batch, seq_len),
            "img_embeds": spec(global_batch, cfg.n_img_tokens, cfg.d_model, dtype=torch.float32),
        }
    return {"tokens": spec(global_batch, seq_len), "labels": spec(global_batch, seq_len)}
