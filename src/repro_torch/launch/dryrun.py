"""Multi-pod dry run: prove the distribution config is coherent, on fake tensors.

The counterpart of the JAX package's ``launch/dryrun.py``.  For every
(architecture × input shape × mesh) cell this program

  1. opens a fake process group of the mesh's size in this process
     (``launch.mesh.fake_process_group``: rank 0 of 256 or 512, every
     collective a no-op) and builds the production ``DeviceMesh`` on it;
  2. builds the model, the optimizer state and the step's inputs as fake
     tensors (shapes and dtypes only, no memory) and distributes them as
     DTensors by the sharding rules (``runtime/shardings.py``);
  3. runs one step (train, decode or prefill) under the ambient mesh, so
     the activation constraints redistribute where the reference pins its
     activations, and records what device 0 does: its FLOPs and bytes read
     and written, counted on its local shards, each collective's output
     bytes on it, and the peak of the storages its ops bring into being
     (the temporaries; the ops holding most at the peak named) against
     the H100's 80 GB.  The peak is kept by the trace's own dispatch mode:
     ``torch.distributed._tools.mem_tracker.MemTracker`` on these fake
     tensors took an in-place write into an argument for a new allocation
     of its whole storage, and on torch 2.11 read Qwen3-0.6B's ``train_4k``
     temporaries as 81.6 GB a device where the same ops hold 5.3 GB.

Any sharding mismatch, missing DTensor rule or shape error fails the
cell: those are bugs in the system, not in the harness.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod --out runs/dryrun_torch
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from collections import defaultdict
from typing import Any, Dict, Optional, Union

import torch

from ..configs import SHAPES, ArchSpec, Shape, get_config, list_archs
from ..data import batch_specs
from ..models.config import ModelConfig
from ..models.model import DecoderLM, decode_step, init_decode_state, prefill_step
from ..models.sharding_utils import use_mesh
from ..optim import make_optimizer
from ..runtime.shardings import (batch_specs_for_mesh, decode_state_specs, distribute_model,
                                 distribute_opt_state, distribute_tree, param_placements)
from ..runtime.train import TrainState, make_train_step
from .mesh import HW, AbstractMesh, fake_process_group, make_mesh, production_shape

__all__ = ["run_cell", "input_specs", "main"]

# the c10d functional collectives DTensor calls, by the reference's names
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def input_specs(cfg: ModelConfig, shape: Shape) -> Dict[str, torch.Tensor]:
    """Meta-tensor stand-ins for every model input of this cell."""
    return batch_specs(cfg, shape.seq_len, shape.global_batch)


def _nbytes(t: torch.Tensor) -> int:
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


class _DeviceCost(torch.utils._python_dispatch.TorchDispatchMode):
    """What one device does in the traced step: FLOPs (PyTorch's flop
    formulas), bytes read and written by every op that is not a view
    (each eager kernel reads its inputs and writes its outputs), each
    collective's output bytes, and the memory its temporaries hold.  It
    counts the local ops that DTensor runs on device 0's shards: an op on
    DTensors is handed back to DTensor (``NotImplemented``), and DTensor's
    own shape propagation, which runs under another fake mode, is not
    counted.  With ``count=False`` it keeps the memory only.

    Memory is kept by storage: a storage that an op's output brings into
    being (not an input's: ``wait_tensor`` hands its input back, views and
    ``_unsafe_view`` alias it) holds its bytes, charged to that op, until
    the last tensor on it (its views included) is freed.  At the highest
    total it keeps the ``PEAK_OPS`` ops that hold most: which ops make the
    step's peak.  The arguments' storages existed before and are not
    counted, in-place writes into them included."""

    PEAK_OPS = 8

    def __init__(self, count: bool = True) -> None:
        super().__init__()
        self.count = count
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, float] = defaultdict(float)
        self._fake = None
        self._storages: Dict[int, list] = {}  # storage → [bytes, live tensors, op]
        self.live: Dict[str, int] = defaultdict(int)
        self.live_total = 0
        self.peak_total = 0
        self.peak_ops: Dict[str, int] = {}

    def _hold(self, name: str, out, inputs) -> None:
        given = {t.untyped_storage()._cdata for t in _tensors(inputs)}
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            ent = self._storages.get(key)
            if ent is None:
                if key in given or not st.nbytes():
                    continue  # an argument's storage, or an input's
                ent = self._storages[key] = [st.nbytes(), 0, name]
                self.live[name] += ent[0]
                self.live_total += ent[0]
            ent[1] += 1
            weakref.finalize(t, self._release, key)
        if self.live_total > self.peak_total:
            self.peak_total = self.live_total
            top = sorted(self.live.items(), key=lambda kv: -kv[1])[:self.PEAK_OPS]
            self.peak_ops = {k: v for k, v in top if v > 0}

    def _release(self, key: int) -> None:
        ent = self._storages[key]
        ent[1] -= 1
        if ent[1] == 0:
            del self._storages[key]
            self.live[ent[2]] -= ent[0]
            self.live_total -= ent[0]

    def __enter__(self):
        from torch._guards import active_fake_mode

        self._fake = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake:
            return out
        packet = func._overloadpacket
        self._hold(packet.__name__, out, (args, kwargs))
        if not self.count:
            return out
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs, out_val=out))
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d_functional"):
            kind = _COLLECTIVES.get(packet.__name__)
            if kind is not None:
                self.collectives[kind] += sum(_nbytes(t) for t in _tensors(out))
        elif not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs, out)))
        return out


# ------------------------------------------------------------------ cells
def _fake_model(cfg: ModelConfig, mesh):
    return distribute_model(DecoderLM(cfg, device="cpu"), mesh)  # fake: empty weights


def _fake_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="cpu")


def _train_cell(spec: ArchSpec, shape: Shape, mesh):
    cfg = spec.model
    opt_init, opt_update = make_optimizer(spec.optimizer, 1e-4)
    model = _fake_model(cfg, mesh).requires_grad_(True)
    opt = distribute_opt_state(opt_init(model), mesh, cfg)
    batch = {k: _fake_like(v) for k, v in input_specs(cfg, shape).items()}
    batch = distribute_tree(batch, batch_specs_for_mesh(batch, mesh), mesh)

    # cap microbatches so each microbatch's batch dim still shards over
    # every data axis (pod included): B/mb must divide pod·data
    dp = 1
    for a, n in zip(mesh.mesh_dim_names, mesh.shape):
        if a != "model":
            dp *= n
    mb = spec.train_microbatches
    B = shape.global_batch
    while mb > 1 and (B // mb) % dp:
        mb //= 2
    step = make_train_step(cfg, opt_update, vocab_chunk=512, microbatches=mb,
                           grad_dtype=spec.grad_dtype,
                           grad_shardings=param_placements(cfg, mesh))
    state = TrainState(model, opt)
    return (lambda: step(state, batch)), (model, opt, batch)


def _decode_cell(spec: ArchSpec, shape: Shape, mesh):
    cfg = spec.model
    model = _fake_model(cfg, mesh)
    B = shape.global_batch
    cache = init_decode_state(cfg, B, shape.seq_len, device="cpu")
    c_specs = decode_state_specs(cache, mesh)
    cache = {part: distribute_tree(bufs, {k: c_specs[f"{part}.{k}"] for k in bufs}, mesh)
             for part, bufs in cache.items()}
    inputs = {"t": torch.empty((B, cfg.n_codebooks, 1) if cfg.n_codebooks else (B, 1),
                               dtype=torch.int32)}
    if cfg.n_codebooks:
        inputs["c"] = torch.empty((B, cfg.n_cond_tokens, cfg.d_model), dtype=torch.float32)
    inputs = distribute_tree(inputs, batch_specs_for_mesh(inputs, mesh), mesh)
    return ((lambda: decode_step(model, inputs["t"], cache, cond_embeds=inputs.get("c"))),
            (model, cache, inputs))


def _prefill_cell(spec: ArchSpec, shape: Shape, mesh):
    cfg = spec.model
    model = _fake_model(cfg, mesh)
    batch = {k: _fake_like(v) for k, v in input_specs(cfg, shape).items() if k != "labels"}
    batch = distribute_tree(batch, batch_specs_for_mesh(batch, mesh), mesh)
    return ((lambda: prefill_step(model, batch["tokens"], img_embeds=batch.get("img_embeds"),
                                  cond_embeds=batch.get("cond_embeds"))),
            (model, batch))


def _arguments(args):
    """Every tensor the step is given: parameters, state, inputs."""
    for a in args:
        if isinstance(a, torch.nn.Module):
            yield from a.parameters()
        else:
            yield from _tensors(a._asdict() if hasattr(a, "_asdict") else a)


def _trace(build, spec: ArchSpec, shape: Shape, dmesh, collect_text_cost: bool):
    """(argument bytes, temporary bytes at the peak, the step's
    ``_DeviceCost``) of one step of the cell ``build`` makes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    # build under the fake mode; the step runs outside it (the fake tensors
    # carry their mode), so DTensor's own bookkeeping tensors stay real, and
    # the few tensors the model makes itself (positions, masks) are real too
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = build(spec, shape, dmesh)
    cost = _DeviceCost(count=collect_text_cost)
    with use_mesh(dmesh), cost:
        step()
    return sum(_nbytes(t) for t in _arguments(args)), cost.peak_total, cost


def run_cell(
    arch: Union[str, ArchSpec],
    shape_name: Union[str, Shape],
    *,
    multi_pod: bool = False,
    mesh: Optional[AbstractMesh] = None,
    collect_text_cost: bool = True,
) -> Dict[str, Any]:
    """Trace one cell on fake tensors; return the analysis record.  ``arch``
    and ``shape_name`` may be names or an ``ArchSpec`` / ``Shape``;
    ``mesh`` (shape and axis names) defaults to the production mesh."""
    spec = get_config(arch) if isinstance(arch, str) else arch
    shape = (next(s for s in SHAPES if s.name == shape_name) if isinstance(shape_name, str)
             else shape_name)
    if not spec.applicable(shape):
        return {
            "arch": spec.name, "shape": shape.name, "status": "skipped",
            "reason": spec.skip_notes.get(shape.name, "inapplicable"),
        }
    mesh = mesh if mesh is not None else production_shape(multi_pod=multi_pod)
    build = {"train": _train_cell, "decode": _decode_cell}.get(shape.kind, _prefill_cell)
    t0 = time.time()
    with fake_process_group(mesh.size):
        dmesh = make_mesh(mesh.shape, mesh.mesh_dim_names, device_type="cpu")
        arg_bytes, temp, cost = _trace(build, spec, shape, dmesh, collect_text_cost)
    per_device = arg_bytes + temp
    rec: Dict[str, Any] = {
        "arch": spec.name,
        "shape": shape.name,
        "mesh": list(mesh.shape),
        "axes": list(mesh.mesh_dim_names),
        "devices": int(mesh.size),
        "status": "ok",
        "trace_s": round(time.time() - t0, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "temp_bytes": temp,
            "per_device_bytes": per_device,
            "hbm_bytes": HW.HBM_BYTES,
            "fits_hbm": per_device <= HW.HBM_BYTES,
            # DTensor's sharding strategies differ across torch releases, and
            # with them the step's temporaries: the plan is this version's
            "torch": torch.__version__,
        },
    }
    rec["memory"]["peak_by_op"] = cost.peak_ops
    if collect_text_cost:
        coll = dict(cost.collectives)
        coll_bytes = float(sum(coll.values()))
        link = HW.NVLINK_BW if mesh.size <= HW.GPUS_PER_NODE else HW.INTER_NODE_BW
        rec["hlo_cost"] = {
            "flops": float(cost.flops),               # per device
            "hbm_bytes": float(cost.bytes),            # eager: every op's reads and writes
            "collectives": coll,
            "collective_bytes": coll_bytes,
        }
        rec["roofline"] = {
            "compute_s": cost.flops / HW.PEAK_FLOPS_BF16,
            "memory_s": cost.bytes / HW.HBM_BW,
            "collective_s": coll_bytes / link,
        }
    cfg = spec.model
    rec["model"] = {
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "tokens_per_step": shape.global_batch
        * (shape.seq_len if shape.kind in ("train", "prefill") else 1),
    }
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="runs/dryrun_torch")
    ap.add_argument("--no-text-cost", action="store_true")
    args = ap.parse_args(argv)

    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    shapes = [s.name for s in SHAPES] if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                try:
                    rec = run_cell(arch, shape, multi_pod=mp,
                                   collect_text_cost=not args.no_text_cost)
                except Exception as e:  # a cell failure is a system bug
                    rec = {
                        "arch": arch, "shape": shape, "status": "FAILED",
                        "mesh": "multi" if mp else "single",
                        "error": f"{type(e).__name__}: {e}",
                        "trace": traceback.format_exc()[-2000:],
                    }
                    failures += 1
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=2)
                extra = ""
                if rec["status"] == "ok":
                    gb = rec["memory"]["per_device_bytes"] / (1 << 30)
                    extra = (f" mem/dev={gb:.2f}GiB fits={rec['memory']['fits_hbm']}"
                             f" trace={rec['trace_s']}s")
                print(f"[{tag}] {rec['status']}{extra}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
