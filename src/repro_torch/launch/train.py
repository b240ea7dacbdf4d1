"""Training launcher: a single-process entry point around the runtime loop, on
the card unless ``--device cpu`` is given.

Examples:
  python -m repro_torch.launch.train --arch qwen3-0.6b --smoke --steps 50 --device cpu
  python -m repro_torch.launch.train --arch mamba2-370m --smoke --steps 200 \
      --ckpt-dir runs/ckpt_mamba --global-batch 8 --seq-len 256

Prints the loss every ``--log-every`` steps and, last, the JAX package's
JSON line (arch, steps, final loss, restarts, wall s, steps/s).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional

from ..configs import get_config
from ..runtime import TrainLoopConfig, run_training


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--peak-lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    spec = get_config(args.arch)
    cfg = spec.smoke if args.smoke else spec.model

    def on_step(step, metrics):
        if step % args.log_every == 0:
            print(f"step {step:6d}  loss {float(metrics['loss']):.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}", flush=True)

    t0 = time.time()
    rep = run_training(
        cfg,
        TrainLoopConfig(
            steps=args.steps, ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
            optimizer=spec.optimizer, peak_lr=args.peak_lr, seq_len=args.seq_len,
            global_batch=args.global_batch, microbatches=args.microbatches, seed=args.seed,
        ),
        on_step=on_step,
        device=args.device,
    )
    wall = time.time() - t0
    print(json.dumps({
        "arch": cfg.name,
        "steps": rep.steps_done,
        "final_loss": rep.final_loss,
        "restarts": rep.restarts,
        "wall_s": round(wall, 1),
        "steps_per_s": round(rep.steps_done / max(wall, 1e-9), 3),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
