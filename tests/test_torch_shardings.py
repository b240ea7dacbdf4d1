"""The port's sharding rules and activation constraints against the JAX
package's, on the CPU.

* ``param_specs`` and ``state_specs`` (each architecture's own optimizer)
  of all ten architectures at full width, on the (2, 4), (16, 16) and
  (2, 16, 16) meshes: the reference's are computed on
  ``jax.sharding.AbstractMesh`` over ``jax.eval_shape`` d trees, the port's
  on ``launch.mesh.AbstractMesh`` over ``models/tree.py``'s layout of a
  meta model; they must be equal leaf by leaf.
* ``decode_state_specs`` and ``batch_specs_for_mesh`` on smoke decode
  states and batches of four families.
* ``placements`` on a mesh of a fake process group, a tuple axis included.
* The constraint helpers: without a mesh each returns its input object;
  under a fake (2, 4) mesh each DTensor comes out with the placements of
  the spec the reference's helper asks ``with_sharding_constraint`` for
  (its fallbacks for heads that do not divide and ``role="kv"``).
* The distributed model computes what the plain model does: on a (2, 2)
  mesh of four gloo ranks (spawned; a file store under a temporary
  directory), five families' smoke models with DTensor parameters and
  inputs under ``use_mesh`` against the same model undistributed: the
  loss within 1e-5 relative, every gradient within 1e-4 of its largest
  magnitude, two decode steps' and ``prefill_step``'s logits within 1e-4.

A fake process group lives only inside one test (``fake_process_group``
destroys it on exit).  torch runs at one intra-op thread here.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import PartitionSpec

import repro.configs as jconfigs
import repro.data as jdata
import repro.models.model as JM
import repro.models.sharding_utils as jsu
import repro.optim as jopt
import repro.runtime.shardings as RS
import repro_torch.configs as tconfigs
import repro_torch.data as tdata
import repro_torch.models.model as TM
import repro_torch.models.sharding_utils as tsu
import repro_torch.optim as topt
import repro_torch.runtime.shardings as TS
from repro_torch.launch.mesh import AbstractMesh, fake_process_group, make_mesh

MESHES = {
    "2x4": ((2, 4), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}
ARCHS = jconfigs.list_archs()


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flat_specs(tree):
    """A reference spec tree as {dotted path: tuple}."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]
    return {".".join(str(getattr(p, "key", getattr(p, "name", getattr(p, "idx", p))))
                     for p in path): tuple(spec) for path, spec in leaves}


def meshes(name):
    shape, axes = MESHES[name]
    return JaxAbstractMesh(shape, axes), AbstractMesh(shape, axes)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference_at_full_width(arch, mesh):
    jm, tm = meshes(mesh)
    jcfg = jconfigs.get_config(arch).model
    params = jax.eval_shape(lambda r: JM.init_model(r, jcfg), jax.random.PRNGKey(0))
    want = flat_specs(RS.param_specs(params, jm, grouped_blocks=jcfg.shared_attn_every > 0))
    got = TS.param_specs(tconfigs.get_config(arch).model, tm)
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_match_reference_at_full_width(arch, mesh):
    jm, tm = meshes(mesh)
    spec = jconfigs.get_config(arch)
    jcfg = spec.model
    params = jax.eval_shape(lambda r: JM.init_model(r, jcfg), jax.random.PRNGKey(0))
    j_init, _ = jopt.make_optimizer(spec.optimizer, 1e-4)
    inner = jax.eval_shape(j_init, params).inner
    want = flat_specs(RS.state_specs(inner, jm, grouped_blocks=jcfg.shared_attn_every > 0))
    tcfg = tconfigs.get_config(arch).model
    t_init, _ = topt.make_optimizer(spec.optimizer, 1e-4)
    got = TS.state_specs(t_init(TM.DecoderLM(tcfg, device="meta")).inner, tm, tcfg)
    assert got == want


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "mamba2-370m", "zamba2-7b", "musicgen-medium"])
def test_decode_state_and_batch_specs_match_reference(arch, mesh):
    jm, tm = meshes(mesh)
    jcfg = jconfigs.get_config(arch).smoke
    tcfg = tconfigs.get_config(arch).smoke
    B, ctx = 32, 64
    jstate = jax.eval_shape(lambda: JM.init_decode_state(jcfg, B, ctx))
    tstate = TM.init_decode_state(tcfg, B, ctx, device="cpu")
    assert TS.decode_state_specs(tstate, tm) == flat_specs(RS.decode_state_specs(jstate, jm))
    for L, batch in ((64, 32), (64, 2)):
        want = {k: tuple(v) for k, v in
                RS.batch_specs_for_mesh(jdata.batch_specs(jcfg, L, batch), jm).items()}
        assert TS.batch_specs_for_mesh(tdata.batch_specs(tcfg, L, batch), tm) == want


def test_placements_map_specs_onto_a_mesh():
    from torch.distributed.tensor import Replicate, Shard

    with fake_process_group(8):
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), device_type="cpu")
        assert TS.placements((("pod", "data"), "model"), mesh) == (Shard(0), Shard(0), Shard(1))
        assert TS.placements((None, "model", None), mesh) == (Replicate(), Replicate(), Shard(1))
        assert TS.placements(("data", None), mesh) == (Replicate(), Shard(0), Replicate())
        assert TS.placements((None, None), mesh) == (Replicate(),) * 3
        with pytest.raises(ValueError):
            TS.placements((("data", "pod"),), mesh)  # out of the mesh's order
        with pytest.raises(ValueError):
            TS.placements(("data", "data"), mesh)
        named = TS.named(mesh, {"a": ("data", None), "b": (None,)})
        assert named == {"a": (Replicate(), Shard(0), Replicate()), "b": (Replicate(),) * 3}


def test_distribute_model_gives_each_parameter_its_leaf_spec():
    """Each per-layer parameter is a DTensor of its leaf's spec with the
    stacked dims stripped; its local shard is the slice of rank 0."""
    from torch.distributed.tensor import DTensor

    cfg = tconfigs.get_config("zamba2-7b").smoke
    model = TM.init_model(cfg, device="cpu")
    ref = {n: p.detach().clone() for n, p in model.named_parameters()}
    with fake_process_group(8):
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        specs = TS.param_specs(cfg, AbstractMesh((2, 4), ("data", "model")))
        TS.distribute_model(model, mesh)
        from repro_torch.models import tree

        for name, p in model.named_parameters():
            assert isinstance(p, DTensor), name
            key, _ = tree.ref_key(cfg, name)
            n = len(tree.layout(cfg)[key].stack)
            assert p.placements == TS.placements(specs[key][n:], mesh), name
            assert tuple(p.shape) == tuple(ref[name].shape)
            idx = tuple(slice(0, s) for s in p.to_local().shape)
            assert torch.equal(p.to_local(), ref[name][idx]), name


# ------------------------------------------------------------ constraints
@pytest.mark.parametrize("helper, shape", [
    ("shard_heads", (8, 16, 4, 32)), ("shard_ffn", (8, 16, 64)), ("shard_seq", (8, 16, 32)),
    ("constrain", (8, 16, 32)), ("constrain_activation", (8, 16, 32)),
    ("split_heads", (8, 16, 64)), ("reduce_partial", (8, 16, 32)), ("like", (8, 16, 32)),
])
def test_constraints_return_their_input_without_a_mesh(helper, shape):
    x = torch.randn(shape)
    fn = getattr(TM, helper) if helper == "constrain_activation" else getattr(tsu, helper)
    if helper == "constrain":
        assert fn(x, "data", "model", None) is x
    elif helper == "split_heads":
        assert torch.equal(fn(x, 2), x.reshape(8, 16, 2, 32))
    elif helper == "like":
        assert fn(x, torch.zeros(shape)) is x
    else:
        assert fn(x) is x
    assert tsu.ambient_mesh() is None


def reference_spec(monkeypatch, fn, shape, *args):
    """The spec the reference's helper asks ``with_sharding_constraint``
    for under an ambient (2, 4) mesh (captured, not lowered)."""
    seen = []
    mesh = JaxAbstractMesh((2, 4), ("data", "model"))
    monkeypatch.setattr(jsu, "ambient_mesh", lambda: mesh)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(tuple(s.spec)) or x)
    fn(jax.ShapeDtypeStruct(shape, np.float32), *args)
    return seen[-1]


CASES = [  # (helper, shape, extra args): heads that divide 4 and that do not
    ("shard_heads", (8, 16, 4, 32), ()),
    ("shard_heads", (8, 16, 6, 32), ()),              # q: sequence fallback
    ("shard_heads", (8, 16, 6, 32), ("kv",)),         # kv: replicated
    ("shard_heads", (8, 1, 6, 32), ()),               # L=1: replicated
    ("shard_heads", (8, 4, 32), ()),
    ("shard_heads", (8, 6, 32), ()),
    ("shard_heads", (3, 16, 4, 32), ()),              # batch does not divide
    ("shard_ffn", (8, 16, 64), ()),
    ("shard_ffn", (8, 16, 6), ()),
    ("shard_seq", (8, 16, 32), ()),
    ("shard_seq", (8, 6, 32), ()),
    ("constrain", (8, 16, 32), ("data", "model", None)),
    ("constrain", (8, 16, 32), ("data", None, "nope")),
]


@pytest.mark.parametrize("helper, shape, args", CASES, ids=[f"{c[0]}-{c[1]}-{c[2]}" for c in CASES])
def test_constraints_match_reference_fallbacks(monkeypatch, helper, shape, args):
    from torch.distributed.tensor import Replicate, distribute_tensor

    want = reference_spec(monkeypatch, getattr(jsu, helper), shape, *args)
    with fake_process_group(8):
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        x = distribute_tensor(torch.zeros(shape), mesh, [Replicate(), Replicate()],
                              src_data_rank=None)
        with tsu.use_mesh(mesh):
            y = getattr(tsu, helper)(x, *args)
        assert tuple(y.placements) == TS.placements(want, mesh)
        assert tsu.ambient_mesh() is None


@pytest.mark.parametrize("shape, want", [
    ((8, 16, 32), ("data", "model", None)),
    ((3, 16, 32), (None, "model", None)),
    ((8, 1, 32), ("data", None, None)),
    ((8, 32), ("data", None)),
])
def test_constrain_activation_pins_batch_and_sequence(shape, want):
    """The reference's rule: batch over the data axes and, at three dims
    or more, sequence over 'model', each where it divides."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    with fake_process_group(8):
        mesh = make_mesh((2, 4), ("data", "model"), device_type="cpu")
        x = distribute_tensor(torch.zeros(shape), mesh, [Replicate(), Replicate()],
                              src_data_rank=None)
        with tsu.use_mesh(mesh):
            y = TM.constrain_activation(x)
        assert tuple(y.placements) == TS.placements(want, mesh)


# ------------------------------------------------- a real distributed run
DIST_ARCHS = ["qwen3-0.6b", "mixtral-8x7b", "zamba2-7b", "musicgen-medium", "gemma2-9b"]

DIST_SCRIPT = textwrap.dedent("""
    import json, sys
    import multiprocessing as mp


    def rank_main(rank, store, archs):
        import torch
        torch.set_num_threads(1)
        import torch.distributed as dist
        from repro_torch.configs import get_config
        from repro_torch.data import make_batch
        from repro_torch.launch.mesh import make_mesh
        from repro_torch.models.model import decode_step, init_decode_state, init_model, prefill_step
        from repro_torch.models.sharding_utils import use_mesh
        from repro_torch.runtime.shardings import (batch_specs_for_mesh, decode_state_specs,
                                                   distribute_model, distribute_tree)
        from repro_torch.runtime.train import make_loss_fn

        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=4)
        try:
            mesh = make_mesh((2, 2), ("data", "model"), device_type="cpu")

            def on_mesh(t):
                return distribute_tree(t, batch_specs_for_mesh(t, mesh), mesh)

            for arch in archs:
                cfg = get_config(arch).smoke
                plain = init_model(cfg, seed=0, device="cpu").requires_grad_(True)
                model = distribute_model(init_model(cfg, seed=0, device="cpu").requires_grad_(True),
                                         mesh)
                batch = make_batch(cfg, 64, 4, device="cpu")
                loss_fn = make_loss_fn(cfg)
                want, _ = loss_fn(plain, batch)
                want_g = torch.autograd.grad(want, list(plain.parameters()))
                with use_mesh(mesh):
                    got, _ = loss_fn(model, on_mesh(batch))
                    got_g = torch.autograd.grad(got, list(model.parameters()))
                grad_err = max(float((g.full_tensor() - w).abs().max() / w.abs().max().clamp(min=1e-12))
                               for g, w in zip(got_g, want_g))
                toks, cond = batch["tokens"][..., :1], batch.get("cond_embeds")
                st_p = init_decode_state(cfg, 4, 16, device="cpu")
                st_d = init_decode_state(cfg, 4, 16, device="cpu")
                specs = decode_state_specs(st_d, mesh)
                st_d = {part: distribute_tree(b, {k: specs[f"{part}.{k}"] for k in b}, mesh)
                        for part, b in st_d.items()}
                d_in = on_mesh({k: v for k, v in batch.items() if k != "labels"})
                d_tok = on_mesh({"t": toks})["t"]
                dec = 0.0
                with torch.no_grad():
                    for _ in range(2):
                        want_l, st_p = decode_step(plain, toks, st_p, cond_embeds=cond)
                        with use_mesh(mesh):
                            got_l, st_d = decode_step(model, d_tok, st_d,
                                                      cond_embeds=d_in.get("cond_embeds"))
                        dec = max(dec, float((got_l.full_tensor() - want_l).abs().max()))
                    want_p = prefill_step(plain, batch["tokens"], img_embeds=batch.get("img_embeds"),
                                          cond_embeds=cond)
                    with use_mesh(mesh):
                        got_p = prefill_step(model, d_in["tokens"], img_embeds=d_in.get("img_embeds"),
                                             cond_embeds=d_in.get("cond_embeds"))
                pre = float((got_p.full_tensor() - want_p).abs().max())
                loss = float(got.detach().full_tensor())  # a collective: on every rank
                if rank == 0:
                    print(json.dumps({"arch": arch, "loss": loss, "want": float(want),
                                      "grad_err": grad_err, "decode_err": dec,
                                      "prefill_err": pre}), flush=True)

            # a ring split by capacity: 2 KV heads do not divide a model axis of 4
            mesh = make_mesh((1, 4), ("data", "model"), device_type="cpu")
            cfg = get_config("qwen3-0.6b").smoke
            plain = init_model(cfg, seed=0, device="cpu")
            model = distribute_model(init_model(cfg, seed=0, device="cpu"), mesh)
            st_p = init_decode_state(cfg, 4, 16, device="cpu")
            st_d = init_decode_state(cfg, 4, 16, device="cpu")
            specs = decode_state_specs(st_d, mesh)
            st_d = {part: distribute_tree(b, {k: specs[f"{part}.{k}"] for k in b}, mesh)
                    for part, b in st_d.items()}
            toks = make_batch(cfg, 64, 4, device="cpu")["tokens"]
            dec = 0.0
            with torch.no_grad():
                for i in range(20):  # past the capacity: the ring wraps
                    tok = toks[:, i:i + 1]
                    want_l, st_p = decode_step(plain, tok, st_p)
                    with use_mesh(mesh):
                        got_l, st_d = decode_step(model, distribute_tree(
                            {"t": tok}, {"t": (None, None)}, mesh)["t"], st_d)
                    dec = max(dec, float((got_l.full_tensor() - want_l).abs().max()))
            ring = {k: st_d["layers"][k].full_tensor() for k in ("k", "v", "omega", "t")}
            ring_err = max(float((ring[k].float() - st_p["layers"][k].float()).abs().max())
                           for k in ("k", "v"))
            same_idx = all(torch.equal(ring[k], st_p["layers"][k]) for k in ("omega", "t"))
            if rank == 0:
                print(json.dumps({"arch": "capacity-split", "spec": list(specs["layers.k"]),
                                  "decode_err": dec, "ring_err": ring_err,
                                  "same_idx": same_idx}), flush=True)
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=rank_main, args=(r, sys.argv[1], sys.argv[2:]))
                 for r in range(4)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=300)
        for p in procs:  # a rank stuck in a collective ends here, not with the test run
            if p.is_alive():
                p.kill()
                p.join()
        sys.exit(0 if [p.exitcode for p in procs] == [0] * 4 else 1)
""")


@pytest.fixture(scope="module")
def distributed_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist")
    script = tmp / "ranks.py"
    script.write_text(DIST_SCRIPT)
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(__file__), "..", "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, str(script), str(tmp / "store"), *DIST_ARCHS],
                         env=env, capture_output=True, text=True, timeout=420)
    assert out.returncode == 0, out.stderr[-3000:]
    return {r["arch"]: r for r in map(json.loads, (l for l in out.stdout.splitlines()
                                                   if l.startswith("{")))}


@pytest.mark.parametrize("arch", DIST_ARCHS)
def test_distributed_model_computes_the_plain_model(distributed_runs, arch):
    r = distributed_runs[arch]
    assert r["loss"] == pytest.approx(r["want"], rel=1e-5)
    assert r["grad_err"] < 1e-4
    assert r["decode_err"] < 1e-4 and r["prefill_err"] < 1e-4


def test_ring_split_by_capacity_decodes_as_the_plain_model(distributed_runs):
    """Qwen3 smoke on a (1, 4) mesh, whose 2 KV heads do not divide the
    model axis: the rings split by capacity, each device writes and reads
    only its own slots (``sharding_utils.ring_on_shards``), and 20 decode
    steps, past the capacity of 16, give the plain model's logits and
    rings (the keys and values within 1e-5: the sharded projections round
    otherwise; ω and t equal)."""
    r = distributed_runs["capacity-split"]
    assert r["spec"] == [None, "data", "model", None, None]
    assert r["decode_err"] < 1e-4 and r["ring_err"] < 1e-5 and r["same_idx"]
