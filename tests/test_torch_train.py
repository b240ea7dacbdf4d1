"""The port's train step against the JAX package's, on the CPU.

The reference's ``init_model`` tree and fresh optimizer state are carried
across with ``repro_torch.bridge.train_state_from_jax``; both packages
train on the same ``make_batch`` inputs; ``jax.jit`` runs only on the
reference's side.

* one ``make_train_step`` per family (qwen3, gemma2, mixtral, mamba2,
  zamba2, musicgen, internvl2; float32 smoke configurations): loss and
  ``grad_norm`` within 1e-5 relative (the SSM families at a chunk of 2,
  where the reference's SSD gradient is finite: see ``SSM_CHUNK``),
  and every gradient of the loss, stacked back into the reference's
  layout, within 1e-4 of that leaf's largest magnitude; Zamba2 and Qwen3
  also with ``remat`` on (per-block and per-group recomputation);
* ``microbatches=2``, and ``microbatches=2`` with ``grad_dtype="bfloat16"``
  (Nemotron's Adafactor), against the reference with the same settings;
* ``cross_entropy_chunked`` in both modes and ``batch_specs``;
* the entry points: ``launch.train`` on the CPU prints the reference's
  JSON line, and ``run_training`` asked for the card without one raises.

torch runs at one intra-op thread here.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.data as jdata
import repro.models.model as JM
import repro.optim as jopt
import repro.runtime.train as JT
import repro_torch.configs as tconfigs
import repro_torch.data as tdata
import repro_torch.optim as topt
import repro_torch.runtime.train as TT
from repro_torch.bridge import params_from_jax, train_state_from_jax
from repro_torch.models import tree

CPU = "cpu"
RNG = jax.random.PRNGKey(0)
# The reference's SSD masks exp(cum_i - cum_j) after the exp, so where the
# masked entries overflow its gradients are NaN (at the smoke's chunk of 32
# from the first step, and at 4 on these inputs); at a chunk of 2 they stay
# finite, and the chunked
# algorithm computes the same function at any chunk.
SSM_CHUNK = 2
FAMILIES = ["qwen3-0.6b", "gemma2-9b", "mixtral-8x7b", "mamba2-370m", "zamba2-7b",
            "musicgen-medium", "internvl2-2b"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_np(t):
    return jax.tree_util.tree_map(np.asarray, t)


def smoke(arch, **kw):
    """Both packages' smoke configs; an SSM family's chunk is cut to
    ``SSM_CHUNK`` unless ``ssm_chunk`` says otherwise."""
    chunk = kw.pop("ssm_chunk", SSM_CHUNK)
    out = []
    for mod in (jconfigs, tconfigs):
        cfg = mod.get_config(arch).smoke.replace(**kw)
        if cfg.ssm is not None and chunk:
            cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=chunk))
        out.append(cfg)
    return tuple(out)


def jax_flat(t):
    return {".".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}


def stacked_np(tcfg, named):
    return {k: tree.stacked(leaf, named).detach().float().numpy()
            for k, leaf in tree.layout(tcfg).items()}


def batches(jcfg, tcfg, L=32, B=4):
    jb = jdata.make_batch(jcfg, L, B)
    tb = tdata.make_batch(tcfg, L, B, device=CPU)
    return jb, tb


def both_steps(arch, optimizer="adamw", L=32, B=4, **step_kw):
    """(reference metrics, port metrics, reference params after, port model)."""
    jcfg, tcfg = smoke(arch, **step_kw.pop("cfg", {}))
    params = JM.init_model(RNG, jcfg)
    j_init, j_update = jopt.make_optimizer(optimizer, jopt.cosine_schedule(1e-2, 1, 10))
    jstate = JT.TrainState(params, j_init(params))
    tstate = train_state_from_jax(tcfg, to_np(jstate), optimizer, device=CPU)
    _, t_update = topt.make_optimizer(optimizer, topt.cosine_schedule(1e-2, 1, 10))
    jb, tb = batches(jcfg, tcfg, L, B)
    jnew, jm = jax.jit(JT.make_train_step(jcfg, j_update, **step_kw))(jstate, jb)
    tnew, tm = TT.make_train_step(tcfg, t_update, **step_kw)(tstate, tb)
    assert tnew is tstate and int(tstate.opt.step) == 1
    return jm, tm, jnew.params, tstate.model


def check_metrics(jm, tm, rtol=1e-5):
    for k in ("loss", "grad_norm", "ce", "aux", "tokens"):
        assert np.isfinite(float(jm[k])), k
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=rtol, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("arch", FAMILIES)
def test_train_step_matches_reference(arch):
    jm, tm, _, _ = both_steps(arch)
    check_metrics(jm, tm)


@pytest.mark.parametrize("arch,remat", [(a, False) for a in FAMILIES]
                         + [("qwen3-0.6b", True), ("zamba2-7b", True)])
def test_loss_gradients_match_reference(arch, remat):
    """Every gradient of the loss, stacked into the reference's layout,
    within 1e-4 of its leaf's largest magnitude; with ``remat`` the
    recomputed blocks (and a hybrid's group bodies) give the same."""
    jcfg, tcfg = smoke(arch, remat=remat)
    params = JM.init_model(RNG, jcfg)
    model = params_from_jax(tcfg, to_np(params), device=CPU).requires_grad_(True)
    jb, tb = batches(jcfg, tcfg)
    (jl, _), jg = jax.jit(jax.value_and_grad(JT.make_loss_fn(jcfg), has_aux=True))(params, jb)
    loss, got = port_grads(model, tb)
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    want = jax_flat(jg)
    assert set(got) == set(want)
    for k in want:
        assert np.isfinite(want[k]).all(), k
        scale = max(float(np.abs(want[k]).max()), 1e-12)
        assert float(np.abs(got[k] - want[k]).max()) <= 1e-4 * scale, k


def port_grads(model, batch):
    """(loss, {reference leaf key: stacked gradient}) of the port's loss."""
    loss, _ = TT.make_loss_fn(model.cfg)(model, batch)
    named = dict(model.named_parameters())
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    return float(loss.detach()), stacked_np(model.cfg, grads)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_ssd_gradient_is_finite_at_the_smoke_chunk(arch):
    """At the smoke's own chunk (32) the reference's SSD gradient is NaN;
    the port's is finite and equals the one at a chunk of 2 (the chunked
    algorithm computes the same function at any chunk)."""
    jcfg, tcfg = smoke(arch, ssm_chunk=0)
    params = JM.init_model(RNG, jcfg)
    jb, tb = batches(jcfg, tcfg)
    _, jg = jax.jit(jax.value_and_grad(JT.make_loss_fn(jcfg), has_aux=True))(params, jb)
    assert not np.isfinite(jax_flat(jg)["blocks.ssm.A_log"]).all()
    model = params_from_jax(tcfg, to_np(params), device=CPU).requires_grad_(True)
    loss, got = port_grads(model, tb)
    _, tcfg4 = smoke(arch)
    model4 = params_from_jax(tcfg4, to_np(params), device=CPU).requires_grad_(True)
    loss4, want = port_grads(model4, tb)
    np.testing.assert_allclose(loss, loss4, rtol=1e-5)
    for k in want:
        assert np.isfinite(got[k]).all(), k
        scale = max(float(np.abs(want[k]).max()), 1e-12)
        assert float(np.abs(got[k] - want[k]).max()) <= 1e-4 * scale, k


@pytest.mark.parametrize("arch,optimizer,grad_dtype", [
    ("qwen3-0.6b", "adamw", "float32"),
    ("qwen3-0.6b", "adamw", "bfloat16"),
    ("nemotron-4-340b", "adafactor", "bfloat16"),
])
def test_microbatched_step_matches_reference(arch, optimizer, grad_dtype):
    jm, tm, _, _ = both_steps(arch, optimizer, microbatches=2, grad_dtype=grad_dtype)
    check_metrics(jm, tm)


def test_microbatches_keep_the_reference_semantics():
    """The averaged microbatch losses are not the full batch's token mean,
    and ``ce``/``tokens`` are the last microbatch's."""
    jcfg, tcfg = smoke("internvl2-2b")
    state, upd = TT.init_train_state(tcfg, device=CPU)
    _, tb = batches(jcfg, tcfg, L=40, B=4)
    loss_fn = TT.make_loss_fn(tcfg)
    with torch.no_grad():
        last, last_m = loss_fn(state.model, {k: v[2:] for k, v in tb.items()})
    _, m = TT.make_train_step(tcfg, upd, microbatches=2)(state, tb)
    assert float(m["tokens"]) == float(last_m["tokens"])
    np.testing.assert_allclose(float(m["ce"]), float(last_m["ce"]), rtol=1e-6)


@pytest.mark.parametrize("mode", ["onehot", "gather"])
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "musicgen-medium", "gemma2-9b"])
def test_cross_entropy_chunked_matches_reference(arch, mode):
    jcfg, tcfg = smoke(arch)
    params = JM.init_model(RNG, jcfg)
    model = params_from_jax(tcfg, to_np(params), device=CPU)
    rng = np.random.default_rng(5)
    B, L = 2, 48
    hidden = (rng.standard_normal((B, L, tcfg.d_model)) * 0.3).astype(np.float32)
    shape = (B, tcfg.n_codebooks, L) if tcfg.n_codebooks else (B, L)
    labels = rng.integers(0, tcfg.vocab, size=shape).astype(np.int32)
    labels[..., -1] = -100
    labels[0, ..., :5] = -100
    s, m = JT.cross_entropy_chunked(params["embed"], jcfg, jnp.asarray(hidden),
                                    jnp.asarray(labels), chunk=20, mode=mode)
    ts, tm = TT.cross_entropy_chunked(model.embed, tcfg, torch.from_numpy(hidden),
                                      torch.from_numpy(labels), chunk=20, mode=mode)
    assert float(tm) == float(m) == float((labels != -100).sum())
    np.testing.assert_allclose(float(ts), float(s), rtol=1e-6)
    with pytest.raises(ValueError, match="ce mode"):
        TT.cross_entropy_chunked(model.embed, tcfg, torch.from_numpy(hidden),
                                 torch.from_numpy(labels), mode="sparse")


def test_gather_mode_train_step_matches_reference():
    jm, tm, _, _ = both_steps("qwen3-0.6b", ce_mode="gather", vocab_chunk=8)
    check_metrics(jm, tm)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "internvl2-2b", "musicgen-medium"])
def test_batch_specs_match_reference(arch):
    jcfg, tcfg = smoke(arch)
    want = jdata.batch_specs(jcfg, 64, 8)
    got = tdata.batch_specs(tcfg, 64, 8)
    assert set(got) == set(want)
    for k, spec in want.items():
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == spec.shape
        assert str(got[k].dtype).replace("torch.", "") == str(spec.dtype)


def test_train_launcher_on_cpu(capsys):
    from repro_torch.launch.train import main

    assert main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "3", "--seq-len", "32",
                 "--global-batch", "2", "--log-every", "1", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert sum(line.startswith("step") for line in lines) == 3
    rec = json.loads(lines[-1])
    assert rec["arch"] == "qwen3-smoke" and rec["steps"] == 3 and rec["restarts"] == 0
    assert np.isfinite(rec["final_loss"])


def test_training_entry_points_need_the_card_unless_asked(monkeypatch):
    from repro_torch.runtime import TrainLoopConfig, run_training

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tcfg = smoke("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_training(tcfg, TrainLoopConfig(steps=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_train_state(tcfg)
