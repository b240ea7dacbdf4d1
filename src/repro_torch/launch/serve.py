"""Serving launcher: batched greedy decoding with the MRB ring KV cache.

Prefills a batch of prompts token by token, then decodes new tokens step
by step.  Each attention layer's step appends K and V to its ring with
the ``mrb_append`` kernel and attends with the multi-reader
``mrb_decode_attention`` kernel; on the CPU both run their plain torch
versions.  The ring cache is in the model's dtype.  Every step gets
``make_batch``'s ``cond_embeds`` (MusicGen's cross-attention); audio
prompts ``[B, K, L]`` decode ``[B, K, 1]`` tokens; InternVL2 decodes its
text tokens (the image prefix goes through ``prefill_step`` only, as in the
JAX launcher).

Example:
  python -m repro_torch.launch.serve --arch gemma2-9b --smoke --device cpu
  python -m repro_torch.launch.serve --arch gemma2-9b --batch 4 \\
      --prompt-len 32 --new-tokens 32 --context 64          # on the card
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Optional

import torch

from ..configs import get_config
from ..data import make_batch
from ..device import resolve_device
from ..models.model import DecoderLM, init_decode_state, init_model
from ..runtime import make_serve_step

__all__ = ["generate", "serve", "main"]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(model: DecoderLM, prompt: torch.Tensor, new_tokens: int, context: int,
             *, cond_embeds: Optional[torch.Tensor] = None, keep_logits: bool = False) -> Dict:
    """Greedy decoding of ``prompt`` [B, L] (audio: [B, K, L]) on the
    model's device, ``cond_embeds`` passed to every step.

    Returns ``generated`` [B, new_tokens] (audio: [B, K, new_tokens])
    int32, the final ``state``, the ``last_logits`` [B, 1, V] (audio: [B,
    K, 1, V]), the wall seconds of ``prefill_s`` and ``decode_s`` (each
    ending in a device synchronise) and, with ``keep_logits``, every
    step's logits in ``logits``.
    """
    cfg = model.cfg
    dev = model.device
    step = make_serve_step(cfg)
    state = init_decode_state(cfg, prompt.shape[0], context, device=dev)
    seen: List[torch.Tensor] = []
    nxt = logits = None
    _sync(dev)
    t0 = time.perf_counter()
    for i in range(prompt.shape[-1]):
        nxt, logits, state = step(model, prompt[..., i:i + 1], state, cond_embeds)
        if keep_logits:
            seen.append(logits)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    out = []
    t0 = time.perf_counter()
    for _ in range(new_tokens):
        nxt, logits, state = step(model, nxt, state, cond_embeds)
        out.append(nxt)
        if keep_logits:
            seen.append(logits)
    _sync(dev)
    decode_s = time.perf_counter() - t0
    return dict(
        generated=torch.cat(out, dim=-1) if out else prompt[..., :0],
        state=state, last_logits=logits, logits=seen,
        prefill_s=prefill_s, decode_s=decode_s,
    )


def serve(arch: str, *, smoke: bool = False, batch: int = 4, prompt_len: int = 32,
          new_tokens: int = 32, context: int = 0, seed: int = 0, device="cuda") -> Dict:
    """Build ``arch`` at random (``seed``), prefill a ``make_batch`` prompt
    and decode ``new_tokens`` greedily.  ``context`` is the ring capacity
    (0: prompt + new tokens).  Returns the summary printed by :func:`main`
    under ``summary`` beside :func:`generate`'s results and the ``model``."""
    spec = get_config(arch)
    cfg = spec.smoke if smoke else spec.model
    dev = resolve_device(device)
    context = context or (prompt_len + new_tokens)
    _sync(dev)
    t0 = time.perf_counter()
    model = init_model(cfg, seed=seed, device=dev)
    _sync(dev)
    init_s = time.perf_counter() - t0
    data = make_batch(cfg, prompt_len, batch, device=dev)
    res = generate(model, data["tokens"], new_tokens, context,
                   cond_embeds=data.get("cond_embeds"))
    steps = max(new_tokens, 1)
    res["summary"] = {
        "arch": cfg.name,
        "prefill_s": res["prefill_s"],
        "decode_tok_per_s": new_tokens * batch / max(res["decode_s"], 1e-9),
        "ring_capacity": context,
        "device": str(dev) if dev.type == "cpu" else torch.cuda.get_device_name(dev),
        "decode_ms_per_step": res["decode_s"] / steps * 1e3,
        "init_s": init_s,
    }
    res["model"] = model
    return res


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--context", type=int, default=0, help="ring capacity")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    res = serve(args.arch, smoke=args.smoke, batch=args.batch, prompt_len=args.prompt_len,
                new_tokens=args.new_tokens, context=args.context, seed=args.seed,
                device=args.device)
    print("generated (first request):", res["generated"][0, :16].tolist())
    print(json.dumps(res["summary"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
