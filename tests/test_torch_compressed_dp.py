"""The int8 compressed data-parallel step against the JAX package's, on the CPU.

* ``compressed_psum`` over a gloo group of one rank equals the reference's
  inside a one-device ``shard_map``, bit for bit, on the same numpy
  inputs: the int8 values and the scale of the compressor, the mean and
  the new residual.
* The one-replica compressed step on Qwen3 smoke (reference weights
  carried across) against the reference's compressed step and against
  the port's own uncompressed step, within the reference's own bounds
  (``tests/test_substrate.py``: loss relative 1e-5, parameters within
  5e-3); the residual is not zero.
* Eight gloo ranks, started under ``spawn``, against the reference's
  eight-device step in a subprocess on the same batch: losses relative
  1e-4, the pre-clip grad_norm relative 1e-5, the parameter updates within
  lr / 10 and rank 0's residuals leaf by leaf.

Every test that opens a process group opens it in a subprocess or closes
it in a ``finally``; the store is a file under ``tmp_path``.  torch runs
at one intra-op thread here.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

import repro.configs as jconfigs
import repro.data as jdata
import repro.models.model as JM
import repro.optim as jopt
import repro.runtime as JR
import repro_torch.configs as tconfigs
import repro_torch.data as tdata
import repro_torch.optim as topt
import repro_torch.runtime as TR
from repro.optim.compression import compressed_psum as j_psum
from repro.runtime.compressed_dp import _shard_map
from repro_torch.bridge import compressed_state_from_jax, train_state_from_jax
from repro_torch.models import tree

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def gloo_one(tmp_path):
    """A gloo group of one rank in this process, closed afterwards."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def flat(t):
    return {".".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}


def stacked(tcfg, model):
    named = dict(model.named_parameters())
    return {k: tree.stacked(leaf, named).detach().float().numpy()
            for k, leaf in tree.layout(tcfg).items()}


@pytest.mark.parametrize("shape, seed", [((257,), 4), ((3, 5, 7), 1), ((2, 64, 48), 7)])
def test_compressed_psum_at_one_rank_is_the_reference_bit_for_bit(gloo_one, shape, seed):
    rng = np.random.default_rng(seed)
    g = (rng.standard_normal(shape) * 5).astype(np.float32)
    e = (rng.standard_normal(shape) * 0.01).astype(np.float32)
    jq, js, je = jopt.int8_error_feedback_compress(jnp.asarray(g), jnp.asarray(e))
    tq, ts, te = topt.int8_error_feedback_compress(torch.from_numpy(g), torch.from_numpy(e))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert np.float32(ts.item()).tobytes() == np.asarray(js, np.float32).tobytes()
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))

    mesh = jax.make_mesh((1,), ("data",))
    jmean, jerr = _shard_map(lambda a, b: j_psum(a, b, "data"), mesh=mesh,
                             in_specs=(P(), P()), out_specs=(P(), P()))(jnp.asarray(g),
                                                                         jnp.asarray(e))
    tmean, terr = topt.compressed_psum(torch.from_numpy(g), torch.from_numpy(e))
    assert tmean.dtype == torch.float32 and terr.dtype == torch.float32
    np.testing.assert_array_equal(tmean.numpy(), np.asarray(jmean))
    np.testing.assert_array_equal(terr.numpy(), np.asarray(jerr))


def test_one_replica_step_matches_reference_and_uncompressed(gloo_one):
    jcfg = jconfigs.get_config("qwen3-0.6b").smoke
    tcfg = tconfigs.get_config("qwen3-0.6b").smoke
    params = JM.init_model(KEY, jcfg)
    j_init, j_update = jopt.make_optimizer("adamw", 1e-3)
    jts = JR.TrainState(params, j_init(params))
    mesh = jax.make_mesh((1,), ("data",))
    init_cs, cstep = JR.make_compressed_dp_train_step(jcfg, j_update, mesh)
    jcs, jm = cstep(init_cs(jts), jdata.make_batch(jcfg, 64, 4))

    host = jax.tree_util.tree_map(np.asarray, jts)
    _, t_update = topt.make_optimizer("adamw", 1e-3)
    t_init, t_step = TR.make_compressed_dp_train_step(tcfg, t_update)
    batch = tdata.make_batch(tcfg, 64, 4, device="cpu")
    cs = t_init(train_state_from_jax(tcfg, host, "adamw", device="cpu"))
    assert set(cs.err) == set(tree.layout(tcfg))
    cs2, tm = t_step(cs, batch)
    assert cs2 is cs and int(cs.opt.step) == 1

    plain = train_state_from_jax(tcfg, host, "adamw", device="cpu")
    _, pm = TR.make_train_step(tcfg, t_update)(plain, batch)

    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["loss"]) == pytest.approx(float(pm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
    got, ref, unc = stacked(tcfg, cs.model), flat(jcs.params), stacked(tcfg, plain.model)
    assert max(float(np.abs(got[k] - ref[k]).max()) for k in ref) < 5e-3
    assert max(float(np.abs(got[k] - unc[k]).max()) for k in ref) < 5e-3
    errs = flat(jcs.err)
    for k, e in cs.err.items():
        assert tuple(e.shape) == errs[k].shape and e.dtype == torch.float32
    assert sum(float(e.abs().sum()) for e in cs.err.values()) > 0


def test_compressed_state_crosses_the_bridge():
    """A reference ``CompressedTrainState`` (residuals included) becomes the
    port's, keyed by the reference's leaves in their stacked shapes."""
    jcfg = jconfigs.get_config("zamba2-7b").smoke
    tcfg = tconfigs.get_config("zamba2-7b").smoke
    params = JM.init_model(KEY, jcfg)
    j_init, _ = jopt.make_optimizer("adamw", 1e-3)
    mesh = jax.make_mesh((1,), ("data",))
    init_cs, _ = JR.make_compressed_dp_train_step(jcfg, lambda *a: a, mesh)
    jcs = init_cs(JR.TrainState(params, j_init(params)))
    jcs = jcs._replace(err=jax.tree_util.tree_map(lambda e: e + 0.5, jcs.err))
    cs = compressed_state_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, jcs), "adamw",
                                   device="cpu")
    want = flat(jcs.err)
    assert set(cs.err) == set(want)
    for k, e in cs.err.items():
        np.testing.assert_array_equal(e.numpy(), want[k])
    assert stacked(tcfg, cs.model).keys() == flat(jcs.params).keys()


REFERENCE_8 = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json, jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_config
    from repro.models.model import init_model
    from repro.optim import make_optimizer
    from repro.runtime import TrainState, make_compressed_dp_train_step
    from repro.data import make_batch

    cfg = get_config("qwen3-0.6b").smoke
    params = init_model(jax.random.PRNGKey(0), cfg)
    opt_init, opt_update = make_optimizer("adamw", 1e-3)
    ts = TrainState(params, opt_init(params))
    mesh = jax.make_mesh((8,), ("data",))
    init_cs, cstep = make_compressed_dp_train_step(cfg, opt_update, mesh)
    cs2, metrics = cstep(init_cs(ts), make_batch(cfg, 64, 8))
    flat = lambda t: {".".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf, np.float32)
                      for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}
    np.savez(sys.argv[1], **{"params." + k: v for k, v in flat(cs2.params).items()},
             **{"err." + k: v for k, v in flat(cs2.err).items()})
    print(json.dumps({"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}))
""")

PORT_8 = textwrap.dedent("""
    import json, os, sys
    import multiprocessing as mp
    import numpy as np


    def rank_main(rank, world, store, init, out):
        import torch
        torch.set_num_threads(1)
        import torch.distributed as dist
        from repro_torch.bridge import train_state_from_jax
        from repro_torch.configs import get_config
        from repro_torch.data import make_batch
        from repro_torch.models import tree
        from repro_torch.optim import make_optimizer
        from repro_torch.runtime import make_compressed_dp_train_step

        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                                world_size=world)
        try:
            cfg = get_config("qwen3-0.6b").smoke
            z = np.load(init)
            params = {}
            for k in z.files:
                d = params
                *head, last = k.split(".")
                for h in head:
                    d = d.setdefault(h, {})
                d[last] = z[k]
            zeros = lambda t: {k: zeros(v) if isinstance(v, dict) else np.zeros_like(v)
                               for k, v in t.items()}
            host = {"params": params,
                    "opt": {"step": np.int32(0), "inner": {"m": zeros(params),
                                                           "v": zeros(params)}}}
            _, upd = make_optimizer("adamw", 1e-3)
            init_cs, step = make_compressed_dp_train_step(cfg, upd)
            cs = init_cs(train_state_from_jax(cfg, host, "adamw", device="cpu"))
            cs, m = step(cs, make_batch(cfg, 64, world, device="cpu"))
            if rank == 0:
                named = dict(cs.model.named_parameters())
                out_p = {"params." + k: tree.stacked(leaf, named).detach().float().numpy()
                         for k, leaf in tree.layout(cfg).items()}
                np.savez(out, **out_p, **{"err." + k: e.numpy() for k, e in cs.err.items()})
                print(json.dumps({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}),
                      flush=True)
        finally:
            dist.destroy_process_group()


    if __name__ == "__main__":
        store, init, out = sys.argv[1:4]
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=rank_main, args=(r, 8, store, init, out)) for r in range(8)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=300)
        for p in procs:  # a rank stuck in a collective ends here, not with the test run
            if p.is_alive():
                p.kill()
                p.join()
        codes = [p.exitcode for p in procs]
        sys.exit(0 if codes == [0] * 8 else 1)
""")


def test_eight_gloo_ranks_match_the_reference_eight_device_step(tmp_path):
    """The cross-rank int8 sum against the reference's: both write rank 0's
    parameters, residuals and grad_norm.  The loss is taken on the shared
    state before the update and AdamW's first update is about ``lr·sign(g)``
    whatever the reduced gradient's size, so the loss and the parameters
    alone cannot tell a wrong sum; the pre-clip ``grad_norm`` (relative
    1e-5) sees the reduced gradient's size and the parameter updates ``p1 -
    p0`` held within ``lr / 10`` see its signs (a rank's gradient dropped,
    the ``/ n`` missing, scales paired with the wrong rank's values each
    fail one of them).  The residuals are rank 0's own: they agree within
    1e-3 of the leaf's largest residual except where an element sat on an
    int8 rounding boundary that the two frameworks' float32 gradients put on
    different sides (one quantum apart; at most 1e-4 of the elements)."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    ref_out = tmp_path / "ref.npz"
    ref = subprocess.Popen([sys.executable, "-c", REFERENCE_8, str(ref_out)], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cfg = jconfigs.get_config("qwen3-0.6b").smoke
    init = tmp_path / "init.npz"
    p0 = flat(JM.init_model(KEY, cfg))
    np.savez(init, **p0)
    script = tmp_path / "ranks.py"
    script.write_text(PORT_8)
    port_out = tmp_path / "port.npz"
    port = subprocess.run([sys.executable, str(script), str(tmp_path / "store"), str(init),
                           str(port_out)], env=env, capture_output=True, text=True, timeout=420)
    r_stdout, r_stderr = ref.communicate(timeout=600)
    assert port.returncode == 0, port.stderr[-2000:]
    assert ref.returncode == 0, r_stderr[-2000:]
    t_m = json.loads([l for l in port.stdout.splitlines() if l.startswith("{")][0])
    j_m = json.loads([l for l in r_stdout.splitlines() if l.startswith("{")][0])
    assert t_m["loss"] == pytest.approx(j_m["loss"], rel=1e-4)
    assert t_m["grad_norm"] == pytest.approx(j_m["grad_norm"], rel=1e-5)
    got, want = np.load(port_out), np.load(ref_out)
    assert set(got.files) == set(want.files) == ({"params." + k for k in p0}
                                                 | {"err." + k for k in p0})
    lr = 1e-3
    for k in p0:
        d_upd = np.abs((got["params." + k] - p0[k]) - (want["params." + k] - p0[k]))
        assert float(d_upd.max()) < lr / 10, k
    n = flipped = 0
    for k in p0:
        e_t, e_j = got["err." + k], want["err." + k]
        assert e_t.shape == e_j.shape, k
        top = float(np.abs(e_j).max())
        d = np.abs(e_t - e_j)
        off = d > 1e-3 * top
        # a boundary flip moves the residual by one quantum, twice the largest residual's bound
        assert np.all(np.abs(d[off] - 2 * top) <= 0.05 * top), k
        n, flipped = n + d.size, flipped + int(off.sum())
    assert flipped <= 1e-4 * n, (flipped, n)
    assert sum(float(np.abs(got["err." + k]).sum()) for k in p0) > 0
