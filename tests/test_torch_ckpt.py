"""The port's checkpoints, fault tolerance and training loop, on the CPU.

* cross-restore: the reference writes its initial ``TrainState`` at step
  0; the port's ``run_training`` restores it and trains 6 steps through an
  injected failure, with the reference's losses (its own ``run_training``,
  same settings) within 1e-4 relative, at qwen3-smoke and at mamba2-smoke
  with one layer (its SSD at a chunk of 2, where the reference's gradient
  is finite); a port checkpoint restores into the reference's
  ``restore_pytree`` leaf for leaf;
* the port's own versions of ``tests/test_substrate.py``'s checks:
  round trip and ``latest_step``, atomic async saves and pruning, the
  shape-mismatch error, the heartbeat and straggler checks, the elastic
  plans, the loss falling across a restart, a resumed run equal to a
  straight one; and an exact bfloat16 round trip, a snapshot that does
  not alias the live weights, and a writer error raised on ``wait``.

torch runs at one intra-op thread here.
"""
import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import repro.ckpt as jckpt
import repro.configs as jconfigs
import repro.runtime as jruntime
import repro_torch.configs as tconfigs
from repro_torch.ckpt import CheckpointManager, latest_step, restore_pytree, save_pytree
from repro_torch.runtime import (
    ElasticController,
    HeartbeatMonitor,
    StragglerDetector,
    TrainLoopConfig,
    run_training,
)
from repro_torch.runtime.train import init_train_state, load_state_tree, state_tree

CPU = "cpu"


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke(arch, **kw):
    out = []
    for mod in (jconfigs, tconfigs):
        cfg = mod.get_config(arch).smoke.replace(**kw)
        if cfg.ssm is not None:
            cfg = cfg.replace(ssm=dataclasses.replace(cfg.ssm, chunk=2))
        out.append(cfg)
    return tuple(out)


CROSS = {
    "qwen3-0.6b": dict(),
    "mamba2-370m": dict(n_layers=1),
}


@pytest.mark.parametrize("arch", list(CROSS))
def test_port_resumes_the_reference_checkpoint(arch, tmp_path):
    jcfg, tcfg = smoke(arch, **CROSS[arch])
    loop = dict(steps=6, ckpt_every=3, seq_len=32, global_batch=2, inject_failure_at=4,
                peak_lr=1e-3)
    state, _ = jruntime.init_train_state(jax.random.PRNGKey(7), jcfg, "adamw", loop["peak_lr"],
                                         10, loop["steps"])
    jckpt.save_pytree(str(tmp_path / "ref"), 0, state)
    shutil.copytree(tmp_path / "ref", tmp_path / "port")
    want = jruntime.run_training(jcfg, jruntime.TrainLoopConfig(ckpt_dir=str(tmp_path / "ref"),
                                                                **loop))
    got = run_training(tcfg, TrainLoopConfig(ckpt_dir=str(tmp_path / "port"), **loop),
                       device=CPU)
    assert got.restarts == want.restarts == 1 and got.steps_done == want.steps_done == 6
    assert len(got.losses) == len(want.losses) == 7
    assert np.isfinite(want.losses).all()
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-4)
    # restored at start (step 0) and on the failure (step 3); written at
    # steps 3 and 6, the final step's periodic save standing as the last one
    assert len(got.restore_s) == 2 and len(got.ckpt_write_s) == 2
    assert latest_step(str(tmp_path / "port")) == 6


def test_reference_restores_a_port_checkpoint(tmp_path):
    jcfg, tcfg = smoke("zamba2-7b")
    state, _ = init_train_state(tcfg, "adafactor", seed=3, device=CPU)
    save_pytree(str(tmp_path), 5, state_tree(state))
    jstate, _ = jruntime.init_train_state(jax.random.PRNGKey(0), jcfg, "adafactor")
    got = jckpt.restore_pytree(str(tmp_path), 5, jstate)
    flat = {"/".join(str(getattr(p, "name", getattr(p, "key", p))) for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(got)[0]}
    named = dict(state.model.named_parameters())
    assert flat["opt/step"] == 0 and flat["opt/step"].dtype == np.int32
    assert flat["params/shared/fuse"].shape == tuple(named["shared.fuse"].shape)
    np.testing.assert_array_equal(flat["params/shared/fuse"], named["shared.fuse"].detach().numpy())
    np.testing.assert_array_equal(flat["params/blocks/ssm/A_log"][1, 0],
                                  named[f"blocks.{tcfg.shared_attn_every}.ssm.A_log"]
                                  .detach().numpy())
    assert flat["opt/inner/blocks/norm1/scale/vr"].shape == (*_stack(tcfg),)


def _stack(tcfg):
    every = tcfg.shared_attn_every
    return (tcfg.n_layers // every, every)


def test_roundtrip_latest_and_bfloat16_exact(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.tensor(2.5)},
            "h": torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)).bfloat16()}
    save_pytree(str(tmp_path), 3, tree)
    save_pytree(str(tmp_path), 7, tree)
    assert latest_step(str(tmp_path)) == 7
    out = restore_pytree(str(tmp_path), 3, tree)
    assert torch.equal(out["a"], tree["a"]) and float(out["b"]["c"]) == 2.5
    assert out["h"].dtype == torch.bfloat16 and torch.equal(out["h"], tree["h"])
    assert latest_step(str(tmp_path / "none")) is None


def test_manager_async_prune_and_shape_mismatch(tmp_path):
    tree = {"w": torch.ones(4, 4)}
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    mgr.wait()
    steps = sorted(int(n[5:]) for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert steps == [3, 4] and not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    step, got = mgr.restore_latest(tree)
    assert step == 4 and torch.equal(got["w"], tree["w"])
    with pytest.raises(ValueError, match="shape"):
        restore_pytree(str(tmp_path), 4, {"w": torch.ones(3, 3)})
    with pytest.raises(KeyError, match="missing"):
        restore_pytree(str(tmp_path), 4, {"v": torch.ones(4, 4)})


def test_snapshot_does_not_alias_live_weights(tmp_path):
    """The manager copies before it returns: a weight changed in place right
    after ``save`` (as the next optimizer step does) leaves the checkpoint
    as it was."""
    w = torch.zeros(256, 256)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"w": w})
    w.add_(1.0)
    mgr.wait()
    assert not restore_pytree(str(tmp_path), 1, {"w": w})["w"].any()


def test_writer_error_is_raised_on_wait(tmp_path):
    root = tmp_path / "ck"
    mgr = CheckpointManager(str(root))
    shutil.rmtree(root)
    root.write_text("a file where the checkpoint directory was")
    mgr.save(1, {"w": torch.ones(2)})  # the background writer fails
    with pytest.raises(OSError):
        mgr.wait()
    mgr.wait()  # raised once


def test_state_tree_round_trip_in_place(tmp_path):
    _, tcfg = smoke("qwen3-0.6b")
    a, _ = init_train_state(tcfg, seed=1, device=CPU)
    b, _ = init_train_state(tcfg, seed=2, device=CPU)
    a.opt.step.fill_(9)
    a.opt.inner["m"]["blocks.attn.wq"].fill_(0.5)
    save_pytree(str(tmp_path), 9, state_tree(a))
    model_b = b.model
    load_state_tree(b, restore_pytree(str(tmp_path), 9, state_tree(b, template=True)))
    assert b.model is model_b and int(b.opt.step) == 9
    assert torch.all(b.opt.inner["m"]["blocks.attn.wq"] == 0.5)
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), n


def test_heartbeat_and_straggler():
    hb = HeartbeatMonitor(["h0", "h1"], timeout_s=10)
    hb.beat("h0", now=100.0)
    hb.last_seen["h1"] = 80.0
    assert hb.dead(now=100.0) == ["h1"] and hb.alive(now=100.0) == ["h0"]
    sd = StragglerDetector(threshold=2.0, patience=2)
    for t in range(10):
        sd.record("h0", 1.0)
        sd.record("h1", 1.0 if t < 5 else 5.0)
        flags = sd.check()
    assert flags == ["h1"]


def test_elastic_controller_plans():
    ec = ElasticController(chips_per_host=4, model_axis=16)
    assert ec.plan([f"h{i}" for i in range(64)]).shape == (16, 16)
    plan = ec.plan([f"h{i}" for i in range(50)])
    assert plan.shape == (8, 16) and plan.axes == ("data", "model") and len(plan.hosts) == 32
    assert ec.plan(["h0"]) is None


def test_training_decreases_loss_and_survives_failure(tmp_path):
    _, tcfg = smoke("qwen3-0.6b")
    rep = run_training(tcfg, TrainLoopConfig(steps=10, ckpt_every=4, ckpt_dir=str(tmp_path),
                                             seq_len=64, global_batch=4, inject_failure_at=6,
                                             peak_lr=1e-3), device=CPU)
    assert rep.restarts == 1 and rep.steps_done == 10
    assert rep.losses[-1] < rep.losses[0]
    assert latest_step(str(tmp_path)) == 10


def test_resume_is_bit_deterministic(tmp_path):
    _, tcfg = smoke("mamba2-370m", n_layers=1)
    loop = dict(steps=6, ckpt_every=3, seq_len=32, global_batch=2)
    straight = run_training(tcfg, TrainLoopConfig(ckpt_dir=str(tmp_path / "a"), **loop),
                            device=CPU)
    broken = run_training(tcfg, TrainLoopConfig(ckpt_dir=str(tmp_path / "b"),
                                                inject_failure_at=4, **loop), device=CPU)
    assert np.isfinite(straight.losses).all()
    np.testing.assert_allclose(straight.losses[-1], broken.losses[-1], rtol=1e-6)


def test_failure_without_checkpoints_is_raised():
    _, tcfg = smoke("qwen3-0.6b")
    with pytest.raises(RuntimeError, match="simulated node failure"):
        run_training(tcfg, TrainLoopConfig(steps=3, seq_len=16, global_batch=2,
                                           inject_failure_at=1), device=CPU)
