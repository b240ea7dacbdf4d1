"""The port's Mamba2 SSD block against the JAX package, on the CPU.

The reference's ``init_ssm`` leaves (float32) are copied into the port's
:class:`~repro_torch.models.ssm.SSM`, and the same numpy-seeded inputs go
through both.  The chunked scan and the one-token recurrence match within
1e-5 (float32: the two frameworks sum in different orders); the port's
scan equals its own recurrence within 3e-3, as the JAX package's
``test_ssd_scan_matches_recurrence`` holds its own.  torch runs at one
intra-op thread here (``one_thread``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models.ssm as JS
import repro_torch.configs as tconfigs
import repro_torch.models.ssm as TS

ARCHS = ["mamba2-370m", "zamba2-7b"]
B, L = 2, 64  # two chunks of the smoke configs' 32


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(arch, seed=0):
    jcfg = jconfigs.get_config(arch).smoke
    tcfg = tconfigs.get_config(arch).smoke
    jp = JS.init_ssm(jax.random.PRNGKey(seed), jcfg)
    # non-trivial vectors: the reference initialises them to constants
    rng = np.random.default_rng(seed)
    for k in ("conv_b", "D_skip", "dt_bias", "norm"):
        jp[k] = jnp.asarray(np.asarray(jp[k]) + rng.normal(0, 0.1, jp[k].shape).astype(np.float32))
    p = TS.SSM(tcfg, device="cpu")
    for k, v in jp.items():
        getattr(p, k).copy_(torch.from_numpy(np.array(v)))
    return jcfg, tcfg, jp, p


def _inputs(cfg, seed=1):
    return np.random.default_rng(seed).standard_normal((B, L, cfg.d_model), dtype=np.float32) * 0.3


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_fwd_matches_jax(arch):
    jcfg, tcfg, jp, p = _pair(arch)
    u = _inputs(jcfg)
    want = JS.ssm_fwd(jp, jcfg, jnp.asarray(u))
    got = TS.ssm_fwd(p, tcfg, torch.from_numpy(u))
    assert got.shape == (B, L, tcfg.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_decode_matches_jax_token_by_token(arch):
    """Every token's output and both states (conv and ssm, float32) after
    every step within 1e-5; the port updates its state in place."""
    jcfg, tcfg, jp, p = _pair(arch, seed=2)
    u = _inputs(jcfg, seed=3)[:, :24]
    jstate = JS.init_ssm_state(jcfg, B)
    state = TS.init_ssm_state(tcfg, B)
    conv, ssm = state["conv"], state["ssm"]
    step = jax.jit(lambda s, x: JS.ssm_decode(jp, jcfg, x, s))
    for i in range(u.shape[1]):
        want, jstate = step(jstate, jnp.asarray(u[:, i:i + 1]))
        got, state = TS.ssm_decode(p, tcfg, torch.from_numpy(u[:, i:i + 1]), state)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
        for k in ("conv", "ssm"):
            assert state[k].dtype == torch.float32
            np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]), atol=1e-5, rtol=1e-5)
    assert state["conv"] is conv and state["ssm"] is ssm


@pytest.mark.parametrize("arch", ARCHS)
def test_scan_equals_recurrence(arch):
    _, tcfg, _, p = _pair(arch, seed=4)
    u = torch.from_numpy(_inputs(tcfg, seed=5))
    y_scan = TS.ssm_fwd(p, tcfg, u)
    state = TS.init_ssm_state(tcfg, B)
    ys = []
    for i in range(L):
        y, state = TS.ssm_decode(p, tcfg, u[:, i:i + 1], state)
        ys.append(y)
    np.testing.assert_allclose(y_scan.numpy(), torch.cat(ys, 1).numpy(), atol=3e-3, rtol=3e-3)


def test_ssm_fwd_raises_where_the_chunk_does_not_divide():
    cfg = tconfigs.get_config("mamba2-370m").smoke
    p = TS.init_ssm(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        TS.ssm_fwd(p, cfg, torch.zeros((1, 48, cfg.d_model)))
    assert TS.ssm_fwd(p, cfg, torch.zeros((1, 16, cfg.d_model))).shape == (1, 16, cfg.d_model)
