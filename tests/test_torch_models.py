"""The port's serving substrate against the JAX package, on the CPU.

Configurations, data, layers and the decode path of ``repro_torch`` are
held against ``repro`` on the same inputs: numpy-seeded tensors, or the
JAX ``init_model`` tree carried across with ``repro_torch.bridge``.
Configs, parameter counts, tokens, ring counters are exact; layer outputs
within 1e-5 and decode logits within 1e-4 (float32 smoke configs: the two
frameworks sum in different orders, and the decode compounds that over
layers and steps).  The port updates its cache in place, so the JAX state
is always the one returned by the JAX step.
"""
import ast
import dataclasses
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.data as jdata
import repro.models.layers as JL
import repro.models.model as JM
import repro_torch.configs as tconfigs
import repro_torch.data as tdata
import repro_torch.models.layers as TL
import repro_torch.models.model as TM
from repro_torch.bridge import decode_state_from_jax, decode_state_to_numpy, params_from_jax
from repro_torch.kernels import decode_attention as kattn
from repro_torch.kernels import mrb_ring as kring
from repro_torch.launch.serve import generate, serve
from repro_torch.runtime import make_serve_step

CPU = "cpu"
RNG = jax.random.PRNGKey(0)
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def smoke(arch, **kw):
    jcfg = jconfigs.get_config(arch).smoke.replace(**kw)
    tcfg = tconfigs.get_config(arch).smoke.replace(**kw)
    return jcfg, tcfg


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_configs_and_param_counts_match(arch):
    js, ts = jconfigs.get_config(arch), tconfigs.get_config(arch)
    assert type(ts).__name__ == "ArchSpec"
    for field in ("name", "long_context_ok", "skip_notes", "optimizer",
                  "train_microbatches", "grad_dtype"):
        assert getattr(ts, field) == getattr(js, field), field
    for jc, tc in ((js.model, ts.model), (js.smoke, ts.smoke)):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.layer_kinds() == jc.layer_kinds()
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        assert (tc.resolved_head_dim, tc.d_inner, tc.ssm_heads) == (
            jc.resolved_head_dim, jc.d_inner, jc.ssm_heads)


def test_registry_and_shapes_match():
    assert tconfigs.list_archs() == jconfigs.list_archs()
    assert [dataclasses.asdict(s) for s in tconfigs.SHAPES] == [
        dataclasses.asdict(s) for s in jconfigs.SHAPES]
    with pytest.raises(KeyError):
        tconfigs.get_config("no-such-arch")


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-9b", "internvl2-2b", "musicgen-medium"])
@pytest.mark.parametrize("seed", [0, 17])
def test_make_batch_bit_identical(arch, seed):
    cfg = jconfigs.get_config(arch).smoke
    want = jdata.make_batch(cfg, 32, 3, seed=np.uint64(seed))
    got = tdata.make_batch(tconfigs.get_config(arch).smoke, 32, 3, seed=np.uint64(seed),
                           device=CPU)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype


def test_synthetic_stream_resumes_identically():
    from repro.data.pipeline import SyntheticStream as JStream

    cfg = jconfigs.get_config("qwen3-0.6b").smoke
    js = JStream(cfg, 16, 8, seed=5, host_index=1, host_count=2)
    ts = tdata.SyntheticStream(tconfigs.get_config("qwen3-0.6b").smoke, 16, 8, seed=5,
                               host_index=1, host_count=2, device=CPU)
    for step in (0, 3):
        np.testing.assert_array_equal(ts.batch(step)["tokens"].numpy(),
                                      np.asarray(js.batch(step)["tokens"]))


# -------------------------------------------------------------- layers
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_fwd_matches(norm):
    jcfg, tcfg = smoke("qwen3-0.6b", norm=norm)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, jcfg.d_model), dtype=np.float32) * 2 + 0.5
    p = TL.init_norm(tcfg, tcfg.d_model, device=CPU)
    jp = JL.init_norm(jcfg, jcfg.d_model)
    scale = rng.standard_normal(jcfg.d_model, dtype=np.float32)
    p.scale.copy_(torch.from_numpy(scale))
    jp["scale"] = jnp.asarray(scale)
    if norm == "layernorm":
        bias = rng.standard_normal(jcfg.d_model, dtype=np.float32)
        p.bias.copy_(torch.from_numpy(bias))
        jp["bias"] = jnp.asarray(bias)
    np.testing.assert_allclose(TL.norm_fwd(p, torch.from_numpy(x)).numpy(),
                               np.asarray(JL.norm_fwd(jp, jnp.asarray(x))), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_apply_rope_matches(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 4, 32), dtype=np.float32)
    pos = np.array([0, 1, 7, 100, 4095], np.int32)
    got = TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    # decode form: one scalar position broadcast over [B, 1, H, hd]
    got1 = TL.apply_rope(torch.from_numpy(x[:, :1]), torch.tensor([9], dtype=torch.int32), theta)
    want1 = JL.apply_rope(jnp.asarray(x[:, :1]), jnp.asarray([9], jnp.int32), theta)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=1e-5, rtol=1e-5)


def test_softcap_matches():
    x = np.linspace(-200, 200, 101, dtype=np.float32)
    for cap in (0.0, 30.0, 50.0):
        np.testing.assert_allclose(TL.softcap(torch.from_numpy(x), cap).numpy(),
                                   np.asarray(JL.softcap(jnp.asarray(x), cap)), atol=1e-5, rtol=1e-6)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_fwd_matches(kind):
    jcfg, tcfg = smoke("qwen3-0.6b", mlp=kind)
    jp = JL.init_mlp(RNG, jcfg)
    p = TL.MLP(tcfg, device=CPU)
    for k, v in jp.items():
        getattr(p, k).copy_(torch.from_numpy(np.array(v)))
    x = np.random.default_rng(3).standard_normal((2, 1, jcfg.d_model), dtype=np.float32)
    np.testing.assert_allclose(TL.mlp_fwd(p, tcfg, torch.from_numpy(x)).numpy(),
                               np.asarray(JL.mlp_fwd(jp, jcfg, jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)


def _attention_pair(jcfg, tcfg, seed):
    jp = JL.init_attention(jax.random.PRNGKey(seed), jcfg)
    p = TL.Attention(tcfg, device=CPU)
    for k, v in jp.items():
        getattr(p, k).copy_(torch.from_numpy(np.array(v)))
    if tcfg.qk_norm:  # non-trivial qk-norm scales
        rng = np.random.default_rng(seed)
        for k in ("q_norm", "k_norm"):
            s = rng.uniform(0.5, 1.5, tcfg.resolved_head_dim).astype(np.float32)
            jp[k] = jnp.asarray(s)
            getattr(p, k).copy_(torch.from_numpy(s))
    return jp, p


@pytest.mark.parametrize("arch,window", [("qwen3-0.6b", None), ("gemma2-9b", 0), ("gemma2-9b", 5)])
def test_attention_decode_matches(arch, window):
    """Ten steps of one layer's decode (ring capacity 8, so it wraps):
    outputs within 1e-5, the ring and its counters equal."""
    jcfg, tcfg = smoke(arch)
    jp, p = _attention_pair(jcfg, tcfg, seed=4)
    B, C = 2, 8
    jcache = JL.init_cache(jcfg, B, C, dtype=jnp.float32)
    cache = TL.init_cache(tcfg, B, C, dtype=torch.float32, device=CPU)
    rng = np.random.default_rng(5)
    jwin = None if window is None else jnp.int32(window)
    for _ in range(10):
        x = rng.standard_normal((B, 1, jcfg.d_model), dtype=np.float32) * 0.5
        want, jcache = JL.attention_decode(jp, jcfg, jnp.asarray(x), jcache, jwin)
        got, cache = TL.attention_decode(p, tcfg, torch.from_numpy(x), cache, window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
    for k in ("k", "v"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]), atol=1e-5, rtol=1e-5)
    assert int(cache["omega"]) == int(jcache["omega"]) and int(cache["t"]) == int(jcache["t"])


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,window", [("qwen3-0.6b", None), ("gemma2-9b", 3)])
def test_attention_decode_cache_matches_through_wrap(arch, window, cache_dtype):
    """After every one of 13 steps at ring capacity 5 (so ω wraps twice),
    the port's cache equals the cache ``repro.models.layers.attention_decode``
    returns: ω and t exactly, K and V within 1e-5 in float32 and within one
    bfloat16 rounding (2e-2) in bfloat16, where each side rounds its float32
    K/V once."""
    jcfg, tcfg = smoke(arch)
    jp, p = _attention_pair(jcfg, tcfg, seed=12)
    B, C = 2, 5
    jcache = JL.init_cache(jcfg, B, C, dtype=getattr(jnp, cache_dtype))
    cache = TL.init_cache(tcfg, B, C, dtype=cache_dtype, device=CPU)
    tol = 1e-5 if cache_dtype == "float32" else 2e-2
    rng = np.random.default_rng(13)
    jwin = None if window is None else jnp.int32(window)
    for _ in range(13):
        x = rng.standard_normal((B, 1, jcfg.d_model), dtype=np.float32) * 0.5
        _, jcache = JL.attention_decode(jp, jcfg, jnp.asarray(x), jcache, jwin)
        _, cache = TL.attention_decode(p, tcfg, torch.from_numpy(x), cache, window)
        for k in ("k", "v"):
            assert cache[k].dtype == TL.torch_dtype(cache_dtype)
            np.testing.assert_allclose(cache[k].float().numpy(),
                                       np.asarray(jcache[k]).astype(np.float32),
                                       atol=tol, rtol=tol)
        assert int(cache["omega"]) == int(jcache["omega"]) and int(cache["t"]) == int(jcache["t"])
        assert cache["omega"].dtype == cache["t"].dtype == torch.int32


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-9b"])
def test_attention_fwd_matches(arch):
    jcfg, tcfg = smoke(arch)
    jp, p = _attention_pair(jcfg, tcfg, seed=6)
    L = 12
    x = np.random.default_rng(7).standard_normal((2, L, jcfg.d_model), dtype=np.float32) * 0.5
    jmask = JL.make_attention_mask(L, window=5)
    mask = TL.make_attention_mask(L, window=5)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    want = JL.attention_fwd(jp, jcfg, jnp.asarray(x), jnp.arange(L), jmask)
    got = TL.attention_fwd(p, tcfg, torch.from_numpy(x), torch.arange(L), mask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["gemma2-9b", "stablelm-1.6b"])
def test_embed_and_logits_match(arch):
    jcfg, tcfg = smoke(arch)
    jp = JL.init_embed(RNG, jcfg)
    p = TL.Embed(tcfg, device=CPU)
    for k, v in jp.items():
        getattr(p, k).copy_(torch.from_numpy(np.array(v)))
    toks = np.random.default_rng(8).integers(0, jcfg.vocab, (2, 3)).astype(np.int32)
    x = TL.embed_fwd(p, tcfg, torch.from_numpy(toks))
    np.testing.assert_allclose(x.numpy(), np.asarray(JL.embed_fwd(jp, jcfg, jnp.asarray(toks))),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(TL.logits_fwd(p, tcfg, x).numpy(),
                               np.asarray(JL.logits_fwd(jp, jcfg, jnp.asarray(x.numpy()))),
                               atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------- model
@pytest.fixture(scope="module")
def bridged():
    """arch → (JAX cfg, JAX params, port cfg, port model on the bridged weights)."""
    out = {}
    for arch in ("qwen3-0.6b", "gemma2-9b"):
        jcfg, tcfg = smoke(arch)
        params = JM.init_model(RNG, jcfg)
        out[arch] = (jcfg, params, tcfg, params_from_jax(tcfg, to_np(params), device=CPU))
    return out


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-9b", "nemotron-4-340b", "stablelm-1.6b"])
def test_init_model_has_the_jax_tree(arch):
    jcfg, tcfg = smoke(arch)
    jtree = jax.eval_shape(lambda: JM.init_model(RNG, jcfg))
    model = TM.init_model(tcfg, seed=3, device=CPU)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        flat[".".join(p.key for p in path)] = leaf
    mine = {}
    for name, t in model.named_parameters():
        if name.startswith("blocks."):
            layer, rest = name.split(".", 2)[1:]
            key = f"blocks.{rest}"
            mine.setdefault(key, []).append((int(layer), t))
        else:
            assert tuple(t.shape) == flat[name].shape and str(t.dtype)[6:] == str(flat[name].dtype)
            mine[name] = t
    assert set(mine) == set(flat)
    for key, layers in mine.items():
        if key.startswith("blocks."):
            assert [l for l, _ in layers] == list(range(tcfg.n_layers))
            assert (len(layers),) + tuple(layers[0][1].shape) == flat[key].shape
            assert str(layers[0][1].dtype)[6:] == str(flat[key].dtype)
    assert sum(t.numel() for t in model.parameters()) == tcfg.param_count()
    assert all(not t.requires_grad for t in model.parameters())
    # JAX scales: unit norms, N(0, 1/D) attention, N(0, 0.02²) embedding
    blk = model.blocks[0]
    assert torch.all(blk.norm1.scale == 1)
    assert abs(float(blk.attn.wq.std()) * tcfg.d_model ** 0.5 - 1) < 0.1
    assert abs(float(model.embed.tok.std()) / 0.02 - 1) < 0.1


def _stacked(cfg, key):
    every = cfg.shared_attn_every
    if key.startswith("blocks."):
        return (cfg.n_layers // every, every) if every else (cfg.n_layers,)
    if key.startswith("tail."):
        return (cfg.n_layers % every,)
    return ()


@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_every_family_builds_and_bridges(arch):
    """Every configuration builds, in float32 and bfloat16: the port's
    ``init_model`` has the JAX tree (each parameter at its JAX key through
    the bridge's layer mapping: ``blocks[l]``, or a hybrid's
    ``blocks[l // every][l % every]`` and ``tail[j]``; every stacked slot
    covered once; shapes; dtypes, block norms float32 where the bfloat16
    tree holds them in bfloat16) and exactly ``param_count()`` parameters;
    new leaves at the JAX scales; and a float32 JAX tree with distinct
    values in every leaf bridges onto the right layers."""
    import repro_torch.bridge as bridge

    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg = smoke(arch, dtype=dtype)
        jtree = jax.eval_shape(lambda: JM.init_model(RNG, jcfg))
        flat = {".".join(p.key for p in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
        model = TM.init_model(tcfg, seed=3, device=CPU)
        assert sum(t.numel() for t in model.parameters()) == tcfg.param_count()
        assert all(not t.requires_grad for t in model.parameters())
        slots = {}
        for name, t in model.named_parameters():
            key, index = bridge._jax_key(tcfg, name)
            leaf = flat[key]
            stack = _stacked(tcfg, key)
            assert leaf.shape == stack + tuple(t.shape), name
            assert len(index) == len(stack) and all(0 <= i < n for i, n in zip(index, stack))
            if bridge._is_norm_param(name) and dtype == "bfloat16":
                assert t.dtype == torch.float32 and leaf.dtype == jnp.bfloat16, name
            else:
                assert str(t.dtype)[6:] == str(leaf.dtype), name
            slots.setdefault(key, set()).add(index)
        assert set(slots) == set(flat)
        for key, seen in slots.items():
            assert len(seen) == int(np.prod(_stacked(tcfg, key))), key

    # JAX scales of the leaves this slice adds (float32 model of the last loop)
    jcfg, tcfg = smoke(arch)
    model = TM.init_model(tcfg, seed=3, device=CPU)
    D, blk = tcfg.d_model, model.blocks[-1]
    if blk.ssm is not None:
        p = blk.ssm
        nh = tcfg.ssm_heads
        np.testing.assert_allclose(p.A_log.numpy(), np.log(np.linspace(1, 16, nh)), rtol=1e-6)
        assert torch.all(p.D_skip == 1) and torch.all(p.norm == 1) and torch.all(p.conv_b == 0)
        np.testing.assert_allclose(p.dt_bias.numpy(), np.log(np.e - 1), rtol=1e-6)
        assert abs(float(p.conv_w.std()) / 0.2 - 1) < 0.1
        assert abs(float(p.in_proj.std()) * D ** 0.5 - 1) < 0.1
        assert abs(float(p.out_proj.std()) * tcfg.d_inner ** 0.5 - 1) < 0.1
    if blk.moe is not None:
        assert abs(float(blk.moe.router.std()) * D ** 0.5 - 1) < 0.1
        assert abs(float(blk.moe.wo.std()) * tcfg.moe.d_ff ** 0.5 - 1) < 0.1
    if model.shared is not None:
        assert abs(float(model.shared.fuse.std()) * (2 * D) ** 0.5 - 1) < 0.1
        assert abs(float(model.shared.out.std()) * D ** 0.5 - 1) < 0.1
    if tcfg.n_cond_tokens:
        assert blk.xattn.q_norm is None and torch.all(blk.norm_x.scale == 1)
    assert sum(b.moe is not None for b in model.blocks) == (tcfg.n_layers if tcfg.moe else 0)

    # a tree with distinct values lands on the right layers
    jtree = jax.eval_shape(lambda: JM.init_model(RNG, jcfg))
    rng = np.random.default_rng(0)
    tree = jax.tree_util.tree_map(
        lambda l: rng.standard_normal(l.shape).astype(np.float32), jtree)
    bridged = params_from_jax(tcfg, tree, device=CPU)
    flat = {".".join(p.key for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    for name, t in bridged.named_parameters():
        key, index = bridge._jax_key(tcfg, name)
        np.testing.assert_array_equal(t.numpy(), flat[key][index])


def test_bridge_rejects_a_mismatched_tree(bridged):
    jcfg, params, tcfg, _ = bridged["qwen3-0.6b"]
    tree = to_np(params)
    tree["blocks"]["attn"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        params_from_jax(tcfg, tree, device=CPU)
    tree = to_np(params)
    tree["final_norm"]["scale"] = np.zeros(5, np.float32)
    with pytest.raises(ValueError):
        params_from_jax(tcfg, tree, device=CPU)


BF16_ARCHS = ["qwen3-0.6b", "gemma2-9b", "nemotron-4-340b", "stablelm-1.6b"]  # all the port models


@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bridge_loads_bfloat16_trees(arch):
    """The reference's bfloat16 smoke tree (every float32 leaf with ndim >= 2
    cast, so stacked block norm scales arrive in bfloat16) loads: matrices
    bit for bit in bfloat16, the block norms and q/k norms up-cast exactly
    to the port's float32."""
    jcfg, tcfg = smoke(arch, dtype="bfloat16")
    tree = to_np(JM.init_model(RNG, jcfg))
    model = params_from_jax(tcfg, tree, device=CPU)
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        flat[".".join(q.key for q in path)] = leaf
    upcast = 0
    for name, t in model.named_parameters():
        if name.startswith("blocks."):
            layer, rest = name.split(".", 2)[1:]
            src = flat[f"blocks.{rest}"][int(layer)]
        else:
            src = flat[name]
        if src.dtype.name == "bfloat16" and t.dtype == torch.float32:
            upcast += 1
        else:
            assert str(t.dtype)[6:] == src.dtype.name, name
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(src, np.float32))
    assert upcast >= 2 * tcfg.n_layers
    assert model.blocks[0].attn.wq.dtype == torch.bfloat16
    assert model.blocks[0].norm1.scale.dtype == torch.float32


def test_bridge_still_rejects_bfloat16_mismatches():
    """The up-cast covers only the norms: a wrong-shaped norm scale and a
    matrix of the wrong dtype still raise."""
    jcfg, tcfg = smoke("qwen3-0.6b", dtype="bfloat16")
    params = to_np(JM.init_model(RNG, jcfg))
    tree = jax.tree_util.tree_map(lambda x: x, params)
    tree["blocks"]["norm1"]["scale"] = tree["blocks"]["norm1"]["scale"][:, :-1]
    with pytest.raises(ValueError, match="norm1.scale"):
        params_from_jax(tcfg, tree, device=CPU)
    tree = jax.tree_util.tree_map(lambda x: x, params)
    tree["blocks"]["attn"]["wq"] = tree["blocks"]["attn"]["wq"].astype(np.float32)
    with pytest.raises(ValueError, match="attn.wq"):
        params_from_jax(tcfg, tree, device=CPU)
    tree = jax.tree_util.tree_map(lambda x: x, params)
    tree["final_norm"]["scale"] = tree["final_norm"]["scale"].astype(tree["blocks"]["attn"]["wq"].dtype)
    with pytest.raises(ValueError, match="final_norm.scale"):
        params_from_jax(tcfg, tree, device=CPU)


def _jax_step(jcfg):
    return jax.jit(lambda p, t, s: JM.decode_step(p, jcfg, t, s))


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-9b"])
def test_decode_step_matches(arch, bridged):
    """24 teacher-forced then 8 greedy steps at context 64: logits within
    1e-4 at every step, the same greedy tokens, final rings within 1e-5 and
    the ring counters equal."""
    jcfg, params, tcfg, model = bridged[arch]
    B, ctx = 2, 64
    toks = np.array(jdata.make_batch(jcfg, 24, B)["tokens"])
    jstate = JM.init_decode_state(jcfg, B, ctx)
    state = TM.init_decode_state(tcfg, B, ctx, device=CPU)
    assert state["layers"]["k"].dtype == torch.float32
    step = _jax_step(jcfg)
    nxt = None
    for i in range(24 + 8):
        if i < 24:
            tj, tt = jnp.asarray(toks[:, i:i + 1]), torch.from_numpy(toks[:, i:i + 1])
        else:
            tj, tt = jnp.asarray(nxt), torch.from_numpy(nxt)
        want, jstate = step(params, tj, jstate)
        got, state = TM.decode_step(model, tt, state)
        assert got.dtype == torch.float32 and tuple(got.shape) == (B, 1, tcfg.vocab)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
        nxt = np.asarray(jnp.argmax(want, -1)).astype(np.int32)
        np.testing.assert_array_equal(torch.argmax(got, -1).numpy(), nxt)
    mine = decode_state_to_numpy(state)["layers"]
    ref = to_np(jstate)["layers"]
    for k in ("k", "v"):
        np.testing.assert_allclose(mine[k], ref[k], atol=1e-5, rtol=1e-5)
    for k in ("omega", "t"):
        np.testing.assert_array_equal(mine[k], ref[k])


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma2-9b"])
def test_decode_step_matches_in_bfloat16(arch):
    """bfloat16 weights and cache, bridged from the reference's bfloat16
    tree: 24 teacher-forced then 8 greedy steps (JAX's tokens fed to both)
    at context 64.  Logits within 0.02 absolute at every step (the two
    round to bfloat16 at different places: JAX casts the softmax weights to
    the cache dtype before P·V, the port keeps them in float32); greedy
    tokens equal wherever JAX's top-2 logit gap exceeds 0.02; ω and t
    exact."""
    jcfg, tcfg = smoke(arch, dtype="bfloat16")
    params = JM.init_model(RNG, jcfg)
    model = params_from_jax(tcfg, to_np(params), device=CPU)
    B, ctx = 2, 64
    toks = np.array(jdata.make_batch(jcfg, 24, B)["tokens"])
    jstate = JM.init_decode_state(jcfg, B, ctx)
    state = TM.init_decode_state(tcfg, B, ctx, device=CPU)
    assert state["layers"]["k"].dtype == torch.bfloat16
    step = _jax_step(jcfg)
    nxt = None
    for i in range(24 + 8):
        tj = toks[:, i:i + 1] if i < 24 else nxt
        want, jstate = step(params, jnp.asarray(tj), jstate)
        got, state = TM.decode_step(model, torch.from_numpy(np.ascontiguousarray(tj)), state)
        want = np.asarray(want, np.float32)
        assert got.dtype == torch.float32 and tuple(got.shape) == (B, 1, tcfg.vocab)
        np.testing.assert_allclose(got.numpy(), want, atol=0.02, rtol=0)
        top2 = np.sort(want, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > 0.02
        nxt = np.argmax(want, -1).astype(np.int32)
        mine = torch.argmax(got, -1).numpy()
        np.testing.assert_array_equal(mine[clear], nxt[clear])
    mine = decode_state_to_numpy(state)["layers"]
    ref = to_np(jstate)["layers"]
    for k in ("omega", "t"):
        np.testing.assert_array_equal(mine[k], ref[k])


def test_decode_continues_from_a_bridged_state(bridged):
    """A JAX cache carried across mid-run (copied, so the port's in-place
    updates leave the JAX arrays alone) decodes on as JAX does."""
    jcfg, params, tcfg, model = bridged["gemma2-9b"]
    B = 2
    toks = np.array(jdata.make_batch(jcfg, 12, B)["tokens"])
    step = _jax_step(jcfg)
    jstate = JM.init_decode_state(jcfg, B, 16)
    for i in range(10):
        _, jstate = step(params, jnp.asarray(toks[:, i:i + 1]), jstate)
    snapshot = to_np(jstate)
    state = decode_state_from_jax(snapshot, device=CPU)
    for i in range(10, 12):
        want, jstate = step(params, jnp.asarray(toks[:, i:i + 1]), jstate)
        got, state = TM.decode_step(model, torch.from_numpy(toks[:, i:i + 1]), state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)
    assert int(snapshot["layers"]["t"][0]) == 10  # the carried copy did not move
    np.testing.assert_array_equal(decode_state_to_numpy(state)["layers"]["t"],
                                  np.asarray(jstate["layers"]["t"]))


def test_ring_wrap_serving_matches_jax():
    """The serve_mrb_kv example's configuration: gemma2-smoke with a
    32-token window, context 64, prompt 24 + 48 greedy tokens (72 steps,
    so the ring wraps): identical greedy tokens, logits within 1e-4."""
    jcfg, tcfg = smoke("gemma2-9b", sliding_window=32)
    params = JM.init_model(RNG, jcfg)
    model = params_from_jax(tcfg, to_np(params), device=CPU)
    B, prompt_len, new, ctx = 4, 24, 48, 64
    prompt = jdata.make_batch(jcfg, prompt_len, B)["tokens"]
    from repro.runtime.train import make_serve_step as jax_serve_step

    jstep = jax.jit(jax_serve_step(jcfg))
    jstate = JM.init_decode_state(jcfg, B, ctx)
    nxt = None
    jlogits, jgen = [], []
    for i in range(prompt_len):
        nxt, lg, jstate = jstep(params, prompt[:, i:i + 1], jstate, None)
        jlogits.append(np.asarray(lg))
    for _ in range(new):
        nxt, lg, jstate = jstep(params, nxt, jstate, None)
        jgen.append(np.asarray(nxt))
        jlogits.append(np.asarray(lg))
    res = generate(model, torch.from_numpy(np.array(prompt)), new, ctx, keep_logits=True)
    np.testing.assert_array_equal(res["generated"].numpy(), np.concatenate(jgen, -1))
    assert len(res["logits"]) == prompt_len + new
    for got, want in zip(res["logits"], jlogits):
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
    assert int(res["state"]["layers"]["t"][0]) == prompt_len + new
    assert int(res["state"]["layers"]["omega"][0]) == (prompt_len + new) % ctx


def test_prefill_equals_decode_loop(bridged):
    jcfg, _, tcfg, model = bridged["gemma2-9b"]
    toks = torch.from_numpy(np.array(jdata.make_batch(jcfg, 10, 2)["tokens"]))
    last, state = TM.prefill(model, toks, context=16)
    mine = TM.init_decode_state(tcfg, 2, 16, device=CPU)
    for i in range(10):
        lg, mine = TM.decode_step(model, toks[:, i:i + 1], mine)
    np.testing.assert_array_equal(last.numpy(), lg.numpy())
    for k in ("k", "v", "omega", "t"):
        np.testing.assert_array_equal(state["layers"][k].numpy(), mine["layers"][k].numpy())


def test_serve_step_and_launcher_on_cpu(capsys):
    """The launcher's loop on the CPU: greedy tokens in range, counters at
    prompt + new, the plain versions used (no kernel launch counted)."""
    kring.launches = kattn.launches = 0
    res = serve("qwen3-0.6b", smoke=True, batch=2, prompt_len=5, new_tokens=4, device=CPU)
    gen = res["generated"]
    assert tuple(gen.shape) == (2, 4) and gen.dtype == torch.int32
    assert int(gen.min()) >= 0 and int(gen.max()) < res["model"].cfg.vocab
    assert torch.isfinite(res["last_logits"]).all()
    assert res["state"]["layers"]["t"].tolist() == [9] * res["model"].cfg.n_layers
    assert res["summary"]["ring_capacity"] == 9 and res["summary"]["device"] == "cpu"
    assert (kring.launches, kattn.launches) == (0, 0)
    step = make_serve_step(tconfigs.get_config("gemma2-9b").smoke)
    with pytest.raises(ValueError):
        step(res["model"], gen[:, :1], res["state"])
    from repro_torch.launch.serve import main

    assert main(["--arch", "gemma2-9b", "--smoke", "--device", "cpu", "--new-tokens", "3",
                 "--prompt-len", "4"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    import json

    summary = json.loads(out[-1])
    assert {"arch", "prefill_s", "decode_tok_per_s", "ring_capacity", "device",
            "decode_ms_per_step"} <= set(summary)


def test_default_device_is_the_card():
    """Entry points run on the card unless asked for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the test checks the refusal without one")
    cfg = tconfigs.get_config("qwen3-0.6b").smoke
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.init_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdata.make_batch(cfg, 4, 1)


def test_port_imports_no_jax_and_nothing_of_repro():
    files = glob.glob(os.path.join(SRC, "repro_torch", "**", "*.py"), recursive=True)
    assert len(files) > 20
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                root = n.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), f"{path} imports {n}"
