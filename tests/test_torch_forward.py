"""The port's full model layer against the JAX package, on the CPU.

Every family the JAX package serves: the reference's ``init_model`` tree
is carried across with ``repro_torch.bridge.params_from_jax`` and both
packages run the same ``make_batch`` inputs (tokens, ``img_embeds``,
``cond_embeds``).

* ``forward`` logits and aux loss, and ``prefill_step``, within 1e-4 for
  all ten smoke configurations (float32: the frameworks sum in different
  orders, compounded over layers);
* the chunked online-softmax attention against the direct path (2e-3, as
  the JAX package's own test) and against the JAX chunked path (1e-4), with
  both packages' block constants lowered to 64/128;
* decode through a wrapping ring against JAX ``decode_step`` for the six
  families this slice adds: logits within 1e-4 at every step, every state
  leaf within 1e-5, ring counters exact;
* bfloat16 weights and cache for Zamba2 and Mixtral within 0.02, as
  ``tests/test_torch_models.py::test_decode_step_matches_in_bfloat16``;
* ``generate``/``serve`` on the CPU for MusicGen and Zamba2, and the
  bridge refusing a hybrid tree with a leaf missing, extra or mis-stacked.

The JAX side runs as ``tests/test_models.py`` runs it, with its plain ring
path on the CPU.  torch runs at one intra-op thread here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.data as jdata
import repro.models.model as JM
import repro_torch.configs as tconfigs
import repro_torch.data as tdata
import repro_torch.models.model as TM
from repro_torch.bridge import decode_state_to_numpy, params_from_jax
from repro_torch.kernels import decode_attention as kattn
from repro_torch.kernels import mrb_ring as kring
from repro_torch.launch.serve import generate, serve

CPU = "cpu"
RNG = jax.random.PRNGKey(0)
ALL = jconfigs.list_archs()
NEW = ["mixtral-8x7b", "qwen3-moe-235b-a22b", "mamba2-370m", "zamba2-7b", "musicgen-medium",
       "internvl2-2b"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def smoke(arch, **kw):
    return (jconfigs.get_config(arch).smoke.replace(**kw),
            tconfigs.get_config(arch).smoke.replace(**kw))


_BRIDGED = {}


def bridged(arch, **kw):
    """(JAX cfg, JAX params, port cfg, port model on the bridged weights)."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _BRIDGED:
        jcfg, tcfg = smoke(arch, **kw)
        params = JM.init_model(RNG, jcfg)
        _BRIDGED[key] = (jcfg, params, tcfg, params_from_jax(tcfg, to_np(params), device=CPU))
    return _BRIDGED[key]


def inputs(jcfg, tcfg, L, B=2):
    """make_batch of both packages: (JAX tokens, JAX kwargs, port tokens, port kwargs)."""
    jb = jdata.make_batch(jcfg, L, B)
    tb = tdata.make_batch(tcfg, L, B, device=CPU)
    names = [k for k in ("img_embeds", "cond_embeds") if k in jb]
    return jb["tokens"], {k: jb[k] for k in names}, tb["tokens"], {k: tb[k] for k in names}


@pytest.mark.parametrize("arch", ALL)
def test_forward_and_prefill_step_match(arch):
    jcfg, params, tcfg, model = bridged(arch)
    jt, jkw, tt, tkw = inputs(jcfg, tcfg, 64)
    want, want_aux = JM.forward(params, jcfg, jt, **jkw)
    got, aux = TM.forward(model, tt, **tkw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-4, rtol=1e-4)
    assert (float(aux) > 0) == bool(tcfg.moe)
    want_last = jax.jit(lambda p, t, kw: JM.prefill_step(p, jcfg, t, **kw))(params, jt, jkw)
    last = TM.prefill_step(model, tt, **tkw)
    assert tuple(last.shape) == want_last.shape and last.shape[-2] == 1
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("arch,unroll", [("gemma2-9b", True), ("gemma2-9b", False),
                                         ("zamba2-7b", True)])
def test_chunked_attention_matches_direct_and_jax(arch, unroll, monkeypatch):
    """Gemma-2 (softcap, local and global windows) and Zamba2's shared
    attention at L=256 through 64-row q blocks and 128-row k blocks: the
    port's chunked path equals its direct path within 2e-3 and the JAX
    chunked path within 1e-4, in the causal-prefix and uniform variants."""
    kw = {"sliding_window": 96} if arch == "gemma2-9b" else {}
    jcfg, params, tcfg, model = bridged(arch, **kw)
    jt, jkw, tt, tkw = inputs(jcfg, tcfg, 256)
    monkeypatch.setattr(TM, "CHUNKED_ATTN_THRESHOLD", 10 ** 9)
    direct, _ = TM.forward(model, tt, **tkw)
    for mod in (TM, JM):
        monkeypatch.setattr(mod, "CHUNKED_ATTN_THRESHOLD", 1)
        monkeypatch.setattr(mod, "ATTN_Q_BLOCK", 64)
        monkeypatch.setattr(mod, "ATTN_K_BLOCK", 128)
        monkeypatch.setattr(mod, "ATTN_UNROLL_Q", unroll)
    chunked, _ = TM.forward(model, tt, **tkw)
    want, _ = JM.forward(params, jcfg, jt, **jkw)
    np.testing.assert_allclose(chunked.numpy(), direct.numpy(), atol=2e-3, rtol=2e-3)
    np.testing.assert_allclose(chunked.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    last = TM.prefill_step(model, tt, **tkw)
    np.testing.assert_allclose(last.numpy(), chunked[..., -1:, :].numpy(), atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError, match="multiple"):
        TM.attention_fwd_chunked(model.blocks[0].attn if arch == "gemma2-9b" else model.shared.attn,
                                 tcfg, torch.zeros((1, 192, tcfg.d_model)), torch.arange(192), 193)


def _decode_pair(jcfg, params, tcfg, model, B, ctx, prompt_len, new, tol):
    """Teacher-forced prompt then greedy steps through both packages;
    asserts the logits at every step (``tol``), returns both final states."""
    jt, jkw, tt, tkw = inputs(jcfg, tcfg, prompt_len + (jcfg.n_img_tokens or 0), B)
    jcond = {"cond_embeds": jkw["cond_embeds"]} if "cond_embeds" in jkw else {}
    tcond = tkw.get("cond_embeds")
    step = jax.jit(lambda p, t, s, kw: JM.decode_step(p, jcfg, t, s, **kw))
    jstate = JM.init_decode_state(jcfg, B, ctx)
    state = TM.init_decode_state(tcfg, B, ctx, device=CPU)
    toks = np.asarray(jt)
    nxt = None
    for i in range(prompt_len + new):
        tok = toks[..., i:i + 1] if i < prompt_len else nxt
        want, jstate = step(params, jnp.asarray(tok), jstate, jcond)
        got, state = TM.decode_step(model, torch.from_numpy(np.ascontiguousarray(tok)), state,
                                    cond_embeds=tcond)
        want = np.asarray(want, np.float32)
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0 if tol > 1e-3 else tol)
        nxt = np.argmax(want, -1).astype(np.int32)
    return to_np(jstate), decode_state_to_numpy(state)


@pytest.mark.parametrize("arch", NEW)
def test_decode_through_a_wrapping_ring_matches_jax(arch):
    """B=2, context 16, a 12-token prompt then 8 greedy steps (every ring
    wraps; Zamba2's shared rings hold min(16, window 64)): logits within
    1e-4 at every step; after the run every state leaf (rings, SSM conv and
    ssm states) within 1e-5 and the ring counters exact."""
    jcfg, params, tcfg, model = bridged(arch)
    ref, mine = _decode_pair(jcfg, params, tcfg, model, B=2, ctx=16, prompt_len=12, new=8,
                             tol=1e-4)
    assert set(mine) == set(ref) == ({"layers", "shared"} if tcfg.shared_attn_every
                                     else {"layers"})
    for top in ref:
        assert set(mine[top]) == set(ref[top])
        for k, want in ref[top].items():
            if k in ("omega", "t"):
                np.testing.assert_array_equal(mine[top][k], want)
                assert (want == 20).all() if k == "t" else (want == 20 % 16).all()
            else:
                assert mine[top][k].shape == want.shape
                np.testing.assert_allclose(mine[top][k], want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["zamba2-7b", "mixtral-8x7b"])
def test_decode_matches_in_bfloat16(arch):
    """bfloat16 weights and cache bridged from the reference's bfloat16
    tree (the stacked SSM vectors and the router arrive in bfloat16 and
    stay so; block norms are up-cast exactly): 24 teacher-forced then 8
    greedy steps at context 64, the tokens of the reference's jitted run
    fed to every run.

    The reference itself has two bfloat16 answers: its jitted step (XLA
    keeps excess float32 precision across bfloat16 round trips) and the
    same step op by op under ``jax.disable_jit`` (every op rounds to its
    written dtype).  They differ by up to 0.031 (Zamba2) and 0.30 (Mixtral:
    one routing choice flips) at these seeds, so no implementation can sit
    within 0.02 of both.  Held here: (1) the port's logits are within 0.02
    of the nearer of the two, or within the two's own distance where that
    is larger; (2) against the float32 step on the same bfloat16-rounded
    weights, the port's largest error is no larger than the reference's
    larger one (its bfloat16 is no less accurate); ring counters exact."""
    jcfg, tcfg = smoke(arch, dtype="bfloat16")
    params = JM.init_model(RNG, jcfg)
    model = params_from_jax(tcfg, to_np(params), device=CPU)
    blk = model.blocks[0]
    if blk.ssm is not None:
        assert blk.ssm.A_log.dtype == torch.bfloat16 and model.shared.norm1.scale.dtype == torch.float32
    else:
        assert blk.moe.router.dtype == torch.bfloat16 and blk.norm1.scale.dtype == torch.float32
    c32 = jcfg.replace(dtype="float32")
    p32 = jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), params)
    B, ctx = 2, 64
    toks = np.asarray(jdata.make_batch(jcfg, 24, B)["tokens"])
    step = jax.jit(lambda p, t, s: JM.decode_step(p, jcfg, t, s))
    step32 = jax.jit(lambda p, t, s: JM.decode_step(p, c32, t, s))
    jit_s, eager_s = JM.init_decode_state(jcfg, B, ctx), JM.init_decode_state(jcfg, B, ctx)
    s32 = JM.init_decode_state(c32, B, ctx)
    state = TM.init_decode_state(tcfg, B, ctx, device=CPU)
    assert (state["shared"] if blk.ssm is not None else state["layers"])["k"].dtype == torch.bfloat16
    err = dict(port_jit=0.0, port_eager=0.0, spread=0.0, port=0.0, jit=0.0, eager=0.0)
    nxt = None
    for i in range(24 + 8):
        tok = toks[:, i:i + 1] if i < 24 else nxt
        want_jit, jit_s = step(params, jnp.asarray(tok), jit_s)
        with jax.disable_jit():
            want_eager, eager_s = JM.decode_step(params, jcfg, jnp.asarray(tok), eager_s)
        truth, s32 = step32(p32, jnp.asarray(tok), s32)
        got, state = TM.decode_step(model, torch.from_numpy(np.ascontiguousarray(tok)), state)
        assert got.dtype == torch.float32 and tuple(got.shape) == (B, 1, tcfg.vocab)
        got, want_jit, want_eager, truth = (np.asarray(v, np.float32) for v in
                                            (got, want_jit, want_eager, truth))
        for k, (a, b) in dict(port_jit=(got, want_jit), port_eager=(got, want_eager),
                              spread=(want_jit, want_eager), port=(got, truth),
                              jit=(want_jit, truth), eager=(want_eager, truth)).items():
            err[k] = max(err[k], float(np.abs(a - b).max()))
        nxt = np.argmax(want_jit, -1).astype(np.int32)
    print(arch, "max abs logit differences:", err)  # shown with pytest -s
    assert min(err["port_jit"], err["port_eager"]) <= max(0.02, err["spread"]), err
    assert err["port"] <= max(err["jit"], err["eager"]), err
    mine = decode_state_to_numpy(state)
    for top, leaves in to_np(jit_s).items():
        for k in ("omega", "t"):
            if k in leaves:
                np.testing.assert_array_equal(mine[top][k], leaves[k])


@pytest.mark.parametrize("arch", ["musicgen-medium", "zamba2-7b"])
def test_generate_and_serve_on_cpu(arch, capsys):
    """serve() on the CPU: codebook tokens [B, K, new] for MusicGen (with
    make_batch's conditioning passed to every step), [B, new] for Zamba2;
    tokens in range, logits finite, counters at prompt + new, the plain
    ring versions used (no kernel launch counted); generate() on the same
    model equals prefill() + greedy decode_step."""
    kring.launches = kattn.launches = 0
    res = serve(arch, smoke=True, batch=2, prompt_len=6, new_tokens=4, device=CPU)
    model, cfg = res["model"], res["model"].cfg
    gen = res["generated"]
    want_shape = (2, cfg.n_codebooks, 4) if cfg.n_codebooks else (2, 4)
    assert tuple(gen.shape) == want_shape and gen.dtype == torch.int32
    assert 0 <= int(gen.min()) and int(gen.max()) < cfg.vocab
    assert torch.isfinite(res["last_logits"]).all()
    rings = res["state"]["shared"] if cfg.shared_attn_every else res["state"]["layers"]
    assert rings["t"].tolist() == [10] * rings["t"].shape[0]
    assert (kring.launches, kattn.launches) == (0, 0)
    batch = tdata.make_batch(cfg, 6, 2, device=CPU)
    cond = batch.get("cond_embeds")
    again = generate(model, batch["tokens"], 4, 10, cond_embeds=cond, keep_logits=True)
    assert torch.equal(again["generated"], gen) and len(again["logits"]) == 10
    logits, _ = TM.prefill(model, batch["tokens"], 10, cond_embeds=cond)
    assert torch.equal(logits, again["logits"][5])
    from repro_torch.launch.serve import main

    assert main(["--arch", arch, "--smoke", "--device", "cpu", "--new-tokens", "2",
                 "--prompt-len", "4"]) == 0
    assert '"arch"' in capsys.readouterr().out


def test_bridge_rejects_a_broken_hybrid_tree():
    """A Zamba2 tree with a leaf missing (the tail's), an extra leaf in the
    shared block, or blocks stacked as one group too few: all refused."""
    jcfg, params, tcfg, _ = bridged("zamba2-7b")
    tree = to_np(params)
    del tree["tail"]["ssm"]["A_log"]
    with pytest.raises(KeyError, match="tail.ssm.A_log"):
        params_from_jax(tcfg, tree, device=CPU)
    tree = to_np(params)
    tree["shared"]["attn"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="extra"):
        params_from_jax(tcfg, tree, device=CPU)
    tree = to_np(params)
    tree["blocks"] = jax.tree_util.tree_map(lambda x: x[:-1], tree["blocks"])
    with pytest.raises(ValueError, match="stacked"):
        params_from_jax(tcfg, tree, device=CPU)
    tree = to_np(params)
    tree["shared"]["fuse"] = tree["shared"]["fuse"][:-1]
    with pytest.raises(ValueError, match="shared.fuse"):
        params_from_jax(tcfg, tree, device=CPU)
