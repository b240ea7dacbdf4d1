"""The port's optimizers against the JAX package's, on the CPU.

* AdamW and Adafactor on the same weights (the reference's ``init_model``
  tree carried across by the bridge) and the same gradients (seeded numpy,
  in the reference's stacked layout), 3 steps, at every leaf of the
  qwen3 and zamba2 smoke trees: weights and stacked optimizer state within
  1e-6.  This holds the stacked-leaf rules: weight decay on the stacked
  norms, ``q_norm``/``k_norm`` and SSM vectors (``ndim >= 2`` once
  stacked), Adafactor's factored ``vr``/``vc`` of a stacked norm, and its
  update clip over the RMS of a whole stacked leaf;
* a bfloat16 tree, where the port's float32 norms are rounded through
  bfloat16 on update, as the reference's bfloat16 leaves are;
* ``clip_by_global_norm`` and ``cosine_schedule`` against the reference's
  values; ``tree.layout`` against the reference's shapes and dtypes;
* the int8 error-feedback property under the port's own
  ``scenarios.proptest``, and the compressor bit-equal to the reference's.

torch runs at one intra-op thread here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.model as JM
import repro.optim as jopt
import repro_torch.configs as tconfigs
import repro_torch.optim as topt
from repro_torch.bridge import params_from_jax
from repro_torch.models import tree
from repro_torch.scenarios.proptest import given, settings, st

CPU = "cpu"
RNG = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def smoke(arch, **kw):
    return (jconfigs.get_config(arch).smoke.replace(**kw),
            tconfigs.get_config(arch).smoke.replace(**kw))


def flat(t, prefix=""):
    """A nested dict as {dotted key: numpy array}."""
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v.float() if isinstance(v, torch.Tensor) and
                                             v.dtype == torch.bfloat16 else v, np.float32)
    return out


def jax_flat(t):
    return {".".join(str(getattr(p, "key", p)) for p in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]}


def unstack(tcfg, grads_flat):
    """Reference-layout gradients as the port's {parameter name: tensor}."""
    out = {}
    for key, leaf in tree.layout(tcfg).items():
        rows = grads_flat[key].reshape((len(leaf.names),) + leaf.shape[len(leaf.stack):])
        for i, n in enumerate(leaf.names):
            out[n] = torch.from_numpy(np.ascontiguousarray(rows[i]))
    return out


def port_leaves(model):
    named = dict(model.named_parameters())
    return {k: tree.stacked(leaf, named).detach().to(leaf.dtype).float().numpy()
            for k, leaf in tree.layout(model.cfg).items()}


OPTS = {
    "adamw": dict(),
    "adafactor": dict(),
    "adafactor_wd": dict(weight_decay=0.1),
}


def run_both(arch, opt, dtype="float32", steps=3):
    jcfg, tcfg = smoke(arch, dtype=dtype)
    params = JM.init_model(RNG, jcfg)
    model = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, params), device=CPU)
    name = opt.split("_")[0]
    lr = jopt.cosine_schedule(1e-2, 1, 10)
    j_init, j_update = jopt.make_optimizer(name, lr, **OPTS[opt])
    t_init, t_update = topt.make_optimizer(name, topt.cosine_schedule(1e-2, 1, 10), **OPTS[opt])
    jstate, tstate = j_init(params), t_init(model)
    rng = np.random.default_rng(1)
    update = jax.jit(j_update)
    for _ in range(steps):
        gtree = jax.tree_util.tree_map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32) * 0.1, params)
        params, jstate = update(jax.tree_util.tree_map(jnp.asarray, gtree), jstate, params)
        tstate = t_update(unstack(tcfg, jax_flat(gtree)), tstate, model)
    assert int(tstate.step) == int(jstate.step) == steps
    return jax_flat(params), port_leaves(model), jax_flat(jstate.inner), flat(tstate.inner)


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-7b"])
def test_optimizer_matches_reference_at_every_stacked_leaf(arch, opt):
    want_p, got_p, want_s, got_s = run_both(arch, opt)
    assert set(got_p) == set(want_p)
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], atol=1e-6, rtol=1e-6, err_msg=k)
    assert set(got_s) == set(want_s)
    for k in want_s:
        assert got_s[k].shape == want_s[k].shape, k
        np.testing.assert_allclose(got_s[k], want_s[k], atol=1e-6, rtol=1e-6, err_msg=k)
    if opt.startswith("adafactor"):
        # a stacked norm [L, d] is factored, its q_norm [L, hd] too
        assert {"blocks.norm1.scale.vr", "blocks.norm1.scale.vc"} <= set(got_s)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizer_rounds_float32_norms_through_bfloat16(opt):
    """bfloat16 trees: the reference's stacked norm scales are bfloat16, the
    port's float32; after each update the port's norms hold bfloat16 values
    that agree with the reference's to bfloat16 rounding (each side rounds
    its float32 update; a one-ulp flip at step 1 moves later updates by a
    few ulps of the smallest weights, hence the absolute 5e-5)."""
    want_p, got_p, _, _ = run_both("qwen3-0.6b", opt, dtype="bfloat16")
    model_norms = [k for k in want_p if "norm" in k]
    assert "blocks.attn.q_norm" in model_norms and "blocks.norm1.scale" in model_norms
    for k in want_p:
        np.testing.assert_allclose(got_p[k], want_p[k], atol=5e-5, rtol=2 ** -7, err_msg=k)


def test_norm_updates_stay_bfloat16_values():
    jcfg, tcfg = smoke("qwen3-0.6b", dtype="bfloat16")
    params = JM.init_model(RNG, jcfg)
    model = params_from_jax(tcfg, jax.tree_util.tree_map(np.asarray, params), device=CPU)
    init, update = topt.adamw(1e-2)
    state = init(model)
    rng = np.random.default_rng(2)
    grads = {n: torch.from_numpy(rng.standard_normal(tuple(p.shape)).astype(np.float32))
             for n, p in model.named_parameters()}
    update(grads, state, model)
    norm = model.blocks[0].norm1.scale
    assert norm.dtype == torch.float32 and not torch.all(norm == 1)
    assert torch.equal(norm, norm.to(torch.bfloat16).float())
    final = model.final_norm.scale  # [d], float32 in both trees: not rounded
    assert not torch.equal(final, final.to(torch.bfloat16).float())


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-7b", "mamba2-370m", "musicgen-medium"])
def test_layout_is_the_reference_tree(arch):
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = smoke(arch, dtype=dtype)
        jtree = jax.eval_shape(lambda: JM.init_model(RNG, jcfg))
        want = {".".join(p.key for p in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
        got = tree.layout(tcfg)
        assert set(got) == set(want)
        for k, leaf in got.items():
            assert leaf.shape == want[k].shape, k
            assert str(leaf.dtype).replace("torch.", "") == str(want[k].dtype), k
            assert int(np.prod(leaf.stack)) == len(leaf.names), k


def test_clip_and_schedule_match_reference():
    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((10, 4)).astype(np.float32) * 3,
         "b": rng.standard_normal(7).astype(np.float32)}
    for max_norm in (1.0, 100.0):
        want, wnorm = jopt.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        got, gnorm = topt.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()},
                                              max_norm)
        np.testing.assert_allclose(float(gnorm), float(wnorm), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-7)
    bf = {"a": torch.from_numpy(g["a"]).to(torch.bfloat16)}
    clipped, _ = topt.clip_by_global_norm(bf, 1.0)
    assert clipped["a"].dtype == torch.bfloat16
    jlr, tlr = jopt.cosine_schedule(1e-3, 10, 100), topt.cosine_schedule(1e-3, 10, 100)
    for s in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        np.testing.assert_allclose(float(tlr(torch.tensor(s, dtype=torch.int32))),
                                   float(jlr(jnp.int32(s))), rtol=1e-6, atol=1e-12)
    assert float(tlr(torch.tensor(0))) == 0.0


@settings(max_examples=50, deadline=None)
@given(st.lists(st.floats(-100, 100), min_size=4, max_size=32))
def test_int8_error_feedback_converges(vals):
    """With error feedback the accumulated dequantized signal tracks the
    accumulated true signal: the residual stays within one quantization
    step, never 8 accumulated."""
    g = torch.tensor(vals, dtype=torch.float32)
    err = torch.zeros_like(g)
    total_true = torch.zeros_like(g)
    total_sent = torch.zeros_like(g)
    for _ in range(8):
        q, scale, err = topt.int8_error_feedback_compress(g, err)
        assert q.dtype == torch.int8
        total_sent = total_sent + topt.int8_decompress(q, scale)
        total_true = total_true + g
    step = float(g.abs().max()) / 127.0 + 1e-9
    assert float((total_true - total_sent).abs().max()) <= 2 * step + 1e-5


def test_int8_compress_matches_reference_and_error_state():
    rng = np.random.default_rng(4)
    g = rng.standard_normal(257).astype(np.float32) * 5
    e = rng.standard_normal(257).astype(np.float32) * 0.01
    jq, js, je = jopt.int8_error_feedback_compress(jnp.asarray(g), jnp.asarray(e))
    tq, ts, te = topt.int8_error_feedback_compress(torch.from_numpy(g), torch.from_numpy(e))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(ts), float(js), rtol=1e-7)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-6)
    jcfg, tcfg = smoke("qwen3-0.6b")
    from repro_torch.models.model import init_model

    model = init_model(tcfg, device=CPU)
    errs = topt.init_error_state(model)
    # one residual per leaf of the reference's tree, in its stacked shape
    from repro.optim.compression import init_error_state

    jerrs = init_error_state(JM.init_model(jax.random.PRNGKey(0), jcfg))
    jflat = {".".join(str(getattr(p, "key", p)) for p in path): leaf
             for path, leaf in jax.tree_util.tree_flatten_with_path(jerrs)[0]}
    assert set(errs) == set(jflat)
    for k, e in errs.items():
        assert tuple(e.shape) == jflat[k].shape and e.dtype == torch.float32 and not e.any()
