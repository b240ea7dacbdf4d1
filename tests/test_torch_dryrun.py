"""The port's multi-pod dry run and its HLO analyser, on the CPU.

* ``run_cell`` on a fake (2, 4) mesh for a train, a decode and a prefill
  cell of Qwen3 smoke: each record is ``"ok"``, with the reference's
  fields.
* ``memory.argument_bytes`` equals, exactly, the local-shard bytes of the
  step's inputs summed from the reference's own specs (``param_specs``,
  ``state_specs``, ``decode_state_specs``, ``batch_specs_for_mesh`` on a
  ``jax.sharding.AbstractMesh``) over the reference's ``eval_shape`` d
  trees.
* ``hlo_cost.flops`` is device 0's share: the prefill cell's equals the
  matrix products counted by hand (q/k/v/o projections, QKᵀ and PV, the
  SwiGLU FFN, the last position's logits) divided by the 8 devices,
  exactly, and it grows with the layers by exactly that count.
* The train cell moves collective bytes (the gradients' reduce-scatter
  among them).
* The trace's peak memory is kept by storage: an in-place write into an
  argument holds nothing new, and a temporary holds its bytes until its
  last view is freed (a hand count); the record names the ops at the
  peak and the torch release that planned it.
* ``launch/hlo.py`` gives the reference's ``analyze_hlo`` result, exactly,
  on HLO text that the reference compiles on the CPU.

The reference's own dry run cannot lower on this jax (ROADMAP §3), so the
records are held against the reference's specs and hand counts.  torch
runs at one intra-op thread here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec

import repro.configs as jconfigs
import repro.data as jdata
import repro.launch.hlo as jhlo
import repro.models.model as JM
import repro.optim as jopt
import repro.runtime.shardings as RS
import repro_torch.configs as tconfigs
import repro_torch.launch.hlo as thlo
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HW, AbstractMesh

MESH = ((2, 4), ("data", "model"))
SEQ, BATCH = 64, 8


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke_spec(arch="qwen3-0.6b", mod=tconfigs, **kw):
    spec = mod.get_config(arch)
    return dataclasses.replace(spec, model=spec.smoke.replace(**kw))


_RECORDS = {}


def record(kind, **kw):
    """The port's record of one Qwen3-smoke cell (cached per module)."""
    key = (kind, tuple(sorted(kw.items())))
    if key not in _RECORDS:
        shape = tconfigs.Shape(f"{kind}_tiny", SEQ, BATCH, kind)
        _RECORDS[key] = dryrun.run_cell(smoke_spec(**kw), shape, mesh=AbstractMesh(*MESH))
    return _RECORDS[key]


def local_bytes(tree, specs, mesh):
    """Bytes of rank 0's shards of ``tree``'s leaves under ``specs``."""
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    total = 0
    leaves = jax.tree_util.tree_leaves(tree)
    spec_leaves = jax.tree_util.tree_leaves(specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    assert len(leaves) == len(spec_leaves)
    for leaf, spec in zip(leaves, spec_leaves):
        n = 1
        for d, entry in enumerate(tuple(spec) + (None,) * (len(leaf.shape) - len(spec))):
            axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            div = int(np.prod([sizes[a] for a in axes])) if axes else 1
            assert leaf.shape[d] % div == 0
            n *= leaf.shape[d] // div
        total += n * np.dtype(leaf.dtype).itemsize
    return total


def reference_argument_bytes(kind):
    spec = smoke_spec(mod=jconfigs)
    cfg = spec.model
    mesh = JaxAbstractMesh(*MESH)
    params = jax.eval_shape(lambda r: JM.init_model(r, cfg), jax.random.PRNGKey(0))
    total = local_bytes(params, RS.param_specs(params, mesh), mesh)
    if kind == "decode":
        cache = jax.eval_shape(lambda: JM.init_decode_state(cfg, BATCH, SEQ))
        tok = {"t": jax.ShapeDtypeStruct((BATCH, 1), jnp.int32)}
        total += local_bytes(cache, RS.decode_state_specs(cache, mesh), mesh)
        return total + local_bytes(tok, RS.batch_specs_for_mesh(tok, mesh), mesh)
    batch = jdata.batch_specs(cfg, SEQ, BATCH)
    if kind == "prefill":
        batch.pop("labels")
    total += local_bytes(batch, RS.batch_specs_for_mesh(batch, mesh), mesh)
    if kind == "train":
        opt_init, _ = jopt.make_optimizer(spec.optimizer, 1e-4)
        opt = jax.eval_shape(opt_init, params)
        total += local_bytes(opt.inner, RS.state_specs(opt.inner, mesh), mesh)
        total += np.dtype(opt.step.dtype).itemsize
    return total


@pytest.mark.parametrize("kind", ["train", "decode", "prefill"])
def test_cell_on_a_fake_mesh_is_ok(kind):
    rec = record(kind)
    assert rec["status"] == "ok"
    assert (rec["mesh"], rec["axes"], rec["devices"]) == ([2, 4], ["data", "model"], 8)
    mem = rec["memory"]
    assert mem["hbm_bytes"] == HW.HBM_BYTES
    assert mem["per_device_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["fits_hbm"] is (mem["per_device_bytes"] <= HW.HBM_BYTES)
    assert mem["temp_bytes"] > 0
    cost = rec["hlo_cost"]
    assert cost["flops"] > 0 and cost["hbm_bytes"] > 0
    assert cost["collective_bytes"] == pytest.approx(sum(cost["collectives"].values()))
    assert set(cost["collectives"]) <= {"all-gather", "all-reduce", "reduce-scatter", "all-to-all"}
    tokens = BATCH * (SEQ if kind != "decode" else 1)
    assert rec["model"]["tokens_per_step"] == tokens
    cfg = tconfigs.get_config("qwen3-0.6b").smoke
    assert rec["model"]["params"] == cfg.param_count()


def test_peak_memory_is_kept_by_storage_until_the_last_view():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        ring = torch.empty(64, 1024)       # an argument: 262,144 bytes
        row = torch.empty(1, 1024)
        at = torch.zeros(1, dtype=torch.long)
    cost = dryrun._DeviceCost()
    with cost:
        ring.index_copy_(0, at, row)       # in place into the argument: nothing new
        t = ring * 2                       # 262,144 new ("mul")
        v = t.view(-1)[:10]                # keeps t's storage alive
        del t
        u = ring + 1                       # 262,144 new ("add"): the peak
        del v                              # frees the product's storage
        w = u.sum()                        # 4 bytes ("sum")
        del u
    assert cost.peak_total == 2 * 262144
    assert cost.peak_ops == {"mul": 262144, "add": 262144}
    assert cost.live_total == 4 and w.shape == ()
    rec = record("decode")
    assert rec["memory"]["torch"] == torch.__version__
    assert sum(rec["memory"]["peak_by_op"].values()) <= rec["memory"]["temp_bytes"]


@pytest.mark.parametrize("kind", ["train", "decode", "prefill"])
def test_argument_bytes_are_the_reference_specs_local_shards(kind):
    assert record(kind)["memory"]["argument_bytes"] == reference_argument_bytes(kind)


def test_prefill_flops_are_device_zero_share_of_the_hand_count():
    """Qwen3 smoke prefill at B=8, L=64 (direct attention): every matrix
    product is split evenly over the 8 devices, so device 0 does exactly
    1/8 of the hand count; two more layers add exactly two layers' share."""
    c = tconfigs.get_config("qwen3-0.6b").smoke
    B, L, D, h, kv, hd, F, V = (BATCH, SEQ, c.d_model, c.n_heads, c.n_kv_heads,
                                c.resolved_head_dim, c.d_ff, c.vocab)
    layer = (2 * B * L * D * h * hd            # q
             + 2 * (2 * B * L * D * kv * hd)   # k, v
             + 2 * (2 * B * h * L * L * hd)    # QKᵀ, PV
             + 2 * B * L * h * hd * D          # o
             + 3 * (2 * B * L * D * F))        # SwiGLU
    logits = 2 * B * D * V                     # the last position only
    two, four = record("prefill")["hlo_cost"]["flops"], record("prefill", n_layers=4)["hlo_cost"]["flops"]
    assert two == (c.n_layers * layer + logits) / 8
    assert four == (4 * layer + logits) / 8
    assert four - two == 2 * layer / 8


def test_train_cell_reduces_gradients():
    cost = record("train")["hlo_cost"]
    assert cost["collective_bytes"] > 0
    assert cost["collectives"].get("reduce-scatter", 0) > 0  # gradients back to their shards
    assert cost["flops"] > record("prefill")["hlo_cost"]["flops"]


def test_failed_cell_is_recorded_and_main_returns_one(tmp_path, capsys, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no rule")

    monkeypatch.setattr(dryrun, "run_cell", boom)
    rc = dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--out", str(tmp_path)])
    assert rc == 1
    import json

    rec = json.loads((tmp_path / "qwen3-0.6b__decode_32k__single.json").read_text())
    assert rec["status"] == "FAILED" and "no rule" in rec["error"]
    assert "FAILED" in capsys.readouterr().out


def _compiled_text():
    def body(i, c):
        h, acc = c
        h = jnp.tanh(h @ jnp.ones((64, 64), jnp.float32))
        return h, acc + h.sum()

    def f(x):
        return jax.lax.fori_loop(0, 5, body, (x, jnp.float32(0)))

    return jax.jit(f).lower(jnp.ones((32, 64), jnp.float32)).compile().as_text()


def test_hlo_analyser_is_the_reference_on_compiled_text():
    text = _compiled_text()
    want, got = jhlo.analyze_hlo(text), thlo.analyze_hlo(text)
    assert (got.flops, got.bytes, got.collectives) == (want.flops, want.bytes, want.collectives)
    assert got.flops >= 5 * 2 * 32 * 64 * 64  # the loop body counted five times
    assert thlo.collective_bytes(text) == jhlo.collective_bytes(text)
    assert thlo.top_collectives(text) == jhlo.top_collectives(text)
    for s in ("bf16[16,4096,512]{2,1,0}", "(f32[3], s8[2,2])", "pred[]"):
        assert thlo.parse_shape_bytes(s) == jhlo.parse_shape_bytes(s)
