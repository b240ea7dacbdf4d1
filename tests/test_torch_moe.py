"""The port's MoE layer against the JAX package, on the CPU.

The reference's ``init_moe`` leaves are copied into the port's
:class:`~repro_torch.models.moe.MoE` and the same numpy-seeded inputs go
through both ``moe_fwd``: outputs and aux loss within 1e-5 (float32).  With
a capacity factor of 0.5 tokens drop; the port's kept mask and capacity
positions then equal, bit for bit, the reference's routing (its
``jax.lax.top_k`` and ``route_one``'s cumsum, recomputed here in JAX on
the reference's router probabilities).  torch runs at one intra-op thread
here.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.moe as JMo
import repro_torch.configs as tconfigs
import repro_torch.models.moe as TMo


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, capacity_factor=None, seed=0):
    jcfg = jconfigs.get_config(arch).smoke
    tcfg = tconfigs.get_config(arch).smoke
    if capacity_factor is not None:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=capacity_factor))
        tcfg = tcfg.replace(moe=dataclasses.replace(tcfg.moe, capacity_factor=capacity_factor))
    jp = JMo.init_moe(jax.random.PRNGKey(seed), jcfg)
    p = TMo.MoE(tcfg, device="cpu")
    for k, v in jp.items():
        getattr(p, k).copy_(torch.from_numpy(np.array(v)))
    return jcfg, tcfg, jp, p


def _x(cfg, B, L, seed=1):
    return np.random.default_rng(seed).standard_normal((B, L, cfg.d_model), dtype=np.float32) * 0.5


def _jax_routing(jp, jcfg, x):
    """The reference's top-k and capacity positions (moe_fwd's route_one)."""
    m = jcfg.moe
    B, L, _ = x.shape
    e, k = m.num_experts, m.top_k
    capacity = max(1, int(math.ceil(m.capacity_factor * L * k / e)))
    probs = jax.nn.softmax(x.astype(jnp.float32) @ jp["router"], axis=-1)
    _, gate_idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(gate_idx, e, dtype=jnp.int32).reshape(B, L * k, e)
    pos = ((jnp.cumsum(onehot, axis=1) - 1) * onehot).sum(-1).reshape(B, L, k)
    keep = pos < capacity
    return np.asarray(gate_idx), np.asarray(jnp.where(keep, pos, capacity)), np.asarray(keep)


@pytest.mark.parametrize("L", [1, 128])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-235b-a22b"])
def test_moe_fwd_matches_jax(arch, L):
    jcfg, tcfg, jp, p = _pair(arch)
    x = _x(jcfg, 3, L)
    want_y, want_aux = JMo.moe_fwd(jp, jcfg, jnp.asarray(x))
    got_y, got_aux = TMo.moe_fwd(p, tcfg, torch.from_numpy(x))
    assert got_y.shape == x.shape and got_y.dtype == torch.float32 and got_aux.dtype == torch.float32
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(got_aux), float(want_aux), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "qwen3-moe-235b-a22b"])
def test_capacity_drops_fall_on_the_same_tokens(arch):
    jcfg, tcfg, jp, p = _pair(arch, capacity_factor=0.5, seed=3)
    x = _x(jcfg, 4, 64, seed=4)
    idx, pos_c, keep = _jax_routing(jp, jcfg, jnp.asarray(x))
    r = TMo.moe_route(p, tcfg, torch.from_numpy(x))
    assert 0 < int((~keep).sum()) < keep.size  # some tokens drop, not all
    np.testing.assert_array_equal(r.gate_idx.numpy(), idx)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(r.pos_c.numpy(), pos_c)
    want_y, want_aux = JMo.moe_fwd(jp, jcfg, jnp.asarray(x))
    got_y, got_aux = TMo.moe_fwd(p, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(float(got_aux), float(want_aux), atol=1e-5, rtol=1e-5)


def test_top_k_ties_keep_the_lower_expert_first():
    """Equal router probabilities: the port picks experts in the order
    jax.lax.top_k gives (lower index first)."""
    jcfg, tcfg, jp, p = _pair("qwen3-moe-235b-a22b")
    zero = np.zeros((2, 3, jcfg.d_model), np.float32)  # every logit 0: an 8-way tie
    idx, pos_c, keep = _jax_routing(jp, jcfg, jnp.asarray(zero))
    r = TMo.moe_route(p, tcfg, torch.from_numpy(zero))
    np.testing.assert_array_equal(r.gate_idx.numpy(), idx)
    np.testing.assert_array_equal(r.pos_c.numpy(), pos_c)
    assert r.gate_idx[0, 0].tolist() == list(range(tcfg.moe.top_k))
