"""Fault-tolerant checkpointing: the counterpart of the JAX package's
``ckpt/checkpoint.py``, with its on-disk layout.

  * step-indexed directories ``<root>/step_<n:08d>/`` holding
    ``shard_<host>.npz`` with every leaf under its ``/``-joined tree path
    (``params/blocks/attn/wq``, ``opt/step``, ``opt/inner/m/...``);
  * *atomic commit*: writes go to ``step_<n>.tmp``, which is renamed into
    place only after its files are fsynced, so a crash mid-write never
    corrupts the latest checkpoint; a ``DONE`` JSON file carries the step,
    the time and the caller's metadata;
  * *async*: :meth:`CheckpointManager.save` copies every tensor to host
    memory before it returns (a copy, never a view of a live tensor: the
    optimizer updates the weights in place while the writer runs) and
    writes in a background thread; ``wait()`` joins and raises the
    writer's error;
  * retention: the ``keep`` most recent steps are kept, older ones pruned.

bfloat16 leaves are stored as their raw 16 bits (int16) and named in
``DONE``'s ``"dtypes"``, so a host without JAX or ml_dtypes reads them back
exactly.  Float32 and integer leaves are plain npz arrays: a float32
checkpoint of either package restores into the other.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_pytree", "restore_pytree", "latest_step", "CheckpointManager"]

Tree = Mapping[str, Any]


def _flatten(tree: Tree, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflatten(template: Tree, flat: Mapping[str, torch.Tensor], prefix: str = "") -> Dict:
    out = {}
    for k, leaf in template.items():
        key = f"{prefix}{k}"
        if isinstance(leaf, Mapping):
            out[k] = _unflatten(leaf, flat, key + "/")
            continue
        if key not in flat:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(
                f"checkpoint leaf {key!r} shape {tuple(arr.shape)} != expected {tuple(leaf.shape)}"
            )
        out[k] = arr
    return out


def _encode(x: torch.Tensor) -> Tuple[np.ndarray, Optional[str]]:
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy(), "bfloat16"
    return x.numpy(), None


def save_pytree(root: str, step: int, tree: Tree, *, host: int = 0,
                meta: Optional[Dict] = None) -> str:
    """Atomic single-host save of a nested dict of tensors (the manager
    snapshots and runs this in the background)."""
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    flat, dtypes = {}, {}
    for key, x in _flatten(tree).items():
        flat[key], dt = _encode(x.detach().cpu())
        if dt:
            dtypes[key] = dt
    with open(os.path.join(tmp, f"shard_{host}.npz"), "wb") as f:
        np.savez(f, **flat)
        f.flush()
        os.fsync(f.fileno())
    with open(os.path.join(tmp, "DONE"), "w") as f:
        json.dump({"step": step, "time": time.time(), **(meta or {}), "dtypes": dtypes}, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps: List[int] = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(root, name, "DONE")):
                steps.append(int(name[len("step_"):]))
    return max(steps) if steps else None


def restore_pytree(root: str, step: int, template: Tree, *, host: int = 0) -> Dict:
    """The checkpoint of ``step`` as a nested dict of host tensors shaped
    like ``template`` (whose leaves need only a ``shape``: meta tensors do);
    raises ``KeyError`` for a missing leaf and ``ValueError`` for a shape
    that differs."""
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "DONE")) as f:
        dtypes = json.load(f).get("dtypes", {})
    with np.load(os.path.join(d, f"shard_{host}.npz")) as data:
        flat = {k: torch.from_numpy(data[k]) for k in data.files}
    for key, dt in dtypes.items():
        if dt != "bfloat16":
            raise ValueError(f"checkpoint leaf {key!r} has an unknown encoding {dt!r}")
        flat[key] = flat[key].view(torch.bfloat16)
    return _unflatten(template, flat)


class CheckpointManager:
    """Async, retained, atomic checkpoints.  ``write_s`` lists each save's
    seconds from its snapshot to its commit."""

    def __init__(self, root: str, keep: int = 3) -> None:
        self.root = root
        self.keep = keep
        self.write_s: List[float] = []
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(root, exist_ok=True)

    def save(self, step: int, tree: Tree, *, blocking: bool = False, meta=None) -> None:
        self.wait()
        t0 = time.perf_counter()
        # snapshot to host memory now: copies, never views of live tensors
        host_tree = _unflatten(tree, {k: v.detach().to("cpu", copy=True)
                                      for k, v in _flatten(tree).items()})

        def work():
            try:
                save_pytree(self.root, step, host_tree, meta=meta)
                self._prune()
                self.write_s.append(time.perf_counter() - t0)
            except Exception as e:  # surfaced on the next wait()
                self._error = e

        if blocking:
            work()
            self.wait()
        else:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore_latest(self, template: Tree):
        """(step, tree) of the newest complete checkpoint, or (None, None)."""
        self.wait()
        step = latest_step(self.root)
        if step is None:
            return None, None
        return step, restore_pytree(self.root, step, template)

    def _prune(self) -> None:
        steps = sorted(
            int(n[len("step_"):])
            for n in os.listdir(self.root)
            if n.startswith("step_") and not n.endswith(".tmp")
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"), ignore_errors=True)
