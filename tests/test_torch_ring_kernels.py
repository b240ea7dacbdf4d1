"""The port's MRB ring kernels' plain versions against the JAX package.

On CPU tensors ``repro_torch.kernels`` runs the plain torch versions of
``mrb_append`` and ``mrb_decode_attention``; here they are held against
the Pallas kernels in interpret mode and the jnp oracles on the same
numpy-seeded inputs.  Tolerances: the ring append is a copy, so exact;
attention 3e-5 in float32 and 2e-2 in bfloat16 (the JAX package's own
``tests/test_kernels.py`` bounds: float32 differs by summation order,
bfloat16 by where each side rounds to bfloat16).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import mrb_decode_attention as jax_decode_attention
from repro.kernels.mrb_ring import mrb_append as jax_mrb_append
from repro.kernels.ref import decode_attention_ref as jax_attention_ref
from repro.kernels.ref import mrb_append_ref as jax_append_ref
from repro.kernels.ref import mrb_read_window_ref as jax_read_window_ref
from repro_torch.kernels import decode_attention as kattn
from repro_torch.kernels import mrb_ring as kring
from repro_torch.kernels import ref, ring_append, ring_append_kv, ring_decode_attention

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(a: np.ndarray, dtype: str):
    """The same float32 numbers as a JAX and a torch array of ``dtype``
    (both round float32 to bfloat16 to nearest even)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(a).astype(jd), torch.from_numpy(a).to(td)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,C,H,d,block", [(1, 256, 2, 128, 128), (2, 512, 4, 64, 256)])
def test_mrb_append_plain_matches_jax(B, C, H, d, block, dtype):
    rng = np.random.default_rng(7)
    buf_np = rng.standard_normal((B, C, H, d), dtype=np.float32)
    tok_np = rng.standard_normal((B, 1, H, d), dtype=np.float32)
    jbuf, tbuf = _pair(buf_np, dtype)
    jtok, ttok = _pair(tok_np, dtype)
    for omega in (0, 1, block - 1, block, C - 1):
        want = jax_mrb_append(jbuf, jnp.int32(omega), jtok, block=block, interpret=True)
        oracle = jax_append_ref(jbuf, jnp.int32(omega), jtok)
        got = ring_append(tbuf.clone(), torch.tensor(omega, dtype=torch.int32), ttok)
        assert got.dtype == tbuf.dtype
        np.testing.assert_array_equal(_np(got), _np(want))
        np.testing.assert_array_equal(_np(got), _np(oracle))


def test_mrb_append_plain_casts_token_and_clamps_omega():
    rng = np.random.default_rng(3)
    buf_np = rng.standard_normal((2, 8, 2, 32), dtype=np.float32)
    tok_np = rng.standard_normal((2, 1, 2, 32), dtype=np.float32)
    jbuf, tbuf = _pair(buf_np, "bfloat16")
    for omega in (-100, -9, -3, -1, 8, 100):  # dynamic_update_slice: wrap once, then clamp
        want = jax_append_ref(jbuf, jnp.int32(omega), jnp.asarray(tok_np))
        got = ring_append(tbuf.clone(), torch.tensor(omega, dtype=torch.int32),
                          torch.from_numpy(tok_np))
        np.testing.assert_array_equal(_np(got), _np(want))


def test_mrb_append_sequence_builds_ring():
    """Appending C+3 tokens wraps: the buffer holds the last C tokens, and
    equals the Pallas kernel's buffer after the same sequence."""
    B, C, H, d = 1, 8, 1, 128
    tbuf = torch.zeros((B, C, H, d))
    jbuf = jnp.zeros((B, C, H, d), jnp.float32)
    for i in range(C + 3):
        tok = np.full((B, 1, H, d), float(i + 1), np.float32)
        ring_append(tbuf, torch.tensor(i % C, dtype=torch.int32), torch.from_numpy(tok))
        jbuf = jax_mrb_append(jbuf, jnp.int32(i % C), jnp.asarray(tok), block=8, interpret=True)
    np.testing.assert_array_equal(tbuf[0, :, 0, 0].numpy(),
                                  np.array([9, 10, 11, 4, 5, 6, 7, 8], np.float32))
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))


def _jax_append_kv(jbuf_k, jbuf_v, omega, jk, jv, block):
    """The reference's ring update: two Pallas appends (interpret mode)
    where ω lies in [0, C), else the jnp oracle (dynamic_update_slice,
    which wraps a negative ω once and clamps); then ``(omega + 1) % C``."""
    C = jbuf_k.shape[1]
    om = jnp.int32(omega)
    if 0 <= omega < C:
        new_k = jax_mrb_append(jbuf_k, om, jk, block=block, interpret=True)
        new_v = jax_mrb_append(jbuf_v, om, jv, block=block, interpret=True)
    else:
        new_k, new_v = jax_append_ref(jbuf_k, om, jk), jax_append_ref(jbuf_v, om, jv)
    return new_k, new_v, int((om + 1) % C)


@pytest.mark.parametrize("token_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,C,H,d,block", [(1, 256, 2, 128, 128), (2, 512, 4, 64, 256)])
def test_mrb_append_kv_plain_matches_jax(B, C, H, d, block, dtype, token_dtype):
    """The fused ring update on the CPU: both rings and ω exactly as the
    JAX package's two appends plus ``(omega + 1) % C``, over the sweep,
    a negative ω, ω past either end (clamped) and ω = C - 1 (wraps to 0)."""
    rng = np.random.default_rng(9)
    bufs = [rng.standard_normal((B, C, H, d), dtype=np.float32) for _ in range(2)]
    toks = [rng.standard_normal((B, 1, H, d), dtype=np.float32) for _ in range(2)]
    (jbk, tbk), (jbv, tbv) = (_pair(b, dtype) for b in bufs)
    (jk, tk), (jv, tv) = (_pair(t, token_dtype) for t in toks)
    for omega in (0, 1, block - 1, block, C - 1, -1, -C - 3, C + 5):
        want_k, want_v, want_om = _jax_append_kv(jbk, jbv, omega, jk, jv, block)
        got_k, got_v = tbk.clone(), tbv.clone()
        om = torch.tensor(omega, dtype=torch.int32)
        assert ring_append_kv(got_k, got_v, om, tk, tv) is None
        assert got_k.dtype == tbk.dtype and om.dtype == torch.int32
        np.testing.assert_array_equal(_np(got_k), _np(want_k))
        np.testing.assert_array_equal(_np(got_v), _np(want_v))
        assert int(om) == want_om


def test_mrb_append_kv_wrap_sequence_matches_jax():
    """2C + 3 fused updates from ω = C - 2: ω wraps twice and the rings
    hold the last C tokens, as the JAX package's step-by-step update."""
    B, C, H, d = 2, 8, 2, 32
    tbk, tbv = torch.zeros((B, C, H, d)), torch.zeros((B, C, H, d))
    jbk, jbv = jnp.zeros((B, C, H, d)), jnp.zeros((B, C, H, d))
    om = torch.tensor(C - 2, dtype=torch.int32)
    jom = C - 2
    for i in range(2 * C + 3):
        k = np.full((B, 1, H, d), float(i + 1), np.float32)
        v = -k
        ring_append_kv(tbk, tbv, om, torch.from_numpy(k), torch.from_numpy(v))
        jbk, jbv, jom = _jax_append_kv(jbk, jbv, jom, jnp.asarray(k), jnp.asarray(v), block=8)
        assert int(om) == jom
    np.testing.assert_array_equal(tbk.numpy(), np.asarray(jbk))
    np.testing.assert_array_equal(tbv.numpy(), np.asarray(jbv))
    np.testing.assert_array_equal(tbk[0, :, 0, 0].numpy(),
                                  np.array([19, 12, 13, 14, 15, 16, 17, 18], np.float32))


def test_cpu_fused_wrapper_leaves_launch_count_at_zero_and_refuses_meta():
    kring.launches = 0
    rng = np.random.default_rng(4)
    buf = torch.from_numpy(rng.standard_normal((1, 8, 2, 32), dtype=np.float32))
    tok = torch.from_numpy(rng.standard_normal((1, 1, 2, 32), dtype=np.float32))
    om = torch.tensor(7, dtype=torch.int32)
    ring_append_kv(buf, buf.clone(), om, tok, tok)
    assert kring.launches == 0 and int(om) == 0
    meta = torch.zeros((1, 4, 1, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ring_append_kv(meta, meta, torch.zeros((), dtype=torch.int32, device="meta"),
                       meta[:, :1], meta[:, :1])


@pytest.mark.parametrize("t,window", [(3, 8), (20, 8), (70, 16), (0, 4)])
def test_mrb_read_window_matches_jax(t, window):
    rng = np.random.default_rng(11)
    buf_np = rng.standard_normal((2, 16, 2, 32), dtype=np.float32)
    want, want_ok = jax_read_window_ref(jnp.asarray(buf_np), jnp.int32(t), window)
    got, ok = ref.mrb_read_window_ref(torch.from_numpy(buf_np), torch.tensor(t, dtype=torch.int32),
                                      window)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(want_ok))


ATTN_CASES = [  # the JAX package's tests/test_kernels.py sweep
    (2, 512, 4, 3, 128, 256, 0, 0.0, 100),     # partial fill
    (1, 512, 2, 8, 64, 128, 128, 30.0, 700),   # wrap + window + softcap
    (2, 256, 1, 12, 128, 256, 0, 0.0, 255),    # exactly full
    (1, 1024, 8, 2, 128, 512, 512, 0.0, 2000), # deep wrap + window
    (1, 256, 2, 1, 128, 256, 0, 0.0, 0),       # single token, G=1
]


def attention_inputs(B, C, kv, G, d, seed=7):
    rng = np.random.default_rng(seed)
    H = kv * G
    q = rng.standard_normal((B, H, d), dtype=np.float32) * 0.3
    k = rng.standard_normal((B, C, kv, d), dtype=np.float32) * 0.3
    v = rng.standard_normal((B, C, kv, d), dtype=np.float32) * 0.3
    return q, k, v


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,C,kv,G,d,block,window,cap,t", ATTN_CASES)
def test_decode_attention_plain_matches_jax(B, C, kv, G, d, block, window, cap, t, dtype):
    q, k, v = attention_inputs(B, C, kv, G, d)
    (jq, tq), (jk, tk), (jv, tv) = _pair(q, dtype), _pair(k, dtype), _pair(v, dtype)
    got = ring_decode_attention(tq, tk, tv, torch.tensor(t, dtype=torch.int32),
                                window=window, softcap=cap)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, kv * G, d)
    kernel = jax_decode_attention(jq, jk, jv, jnp.int32(t), window=window, softcap=cap,
                                  block=block, interpret=True)
    oracle = jax_attention_ref(jq, jk, jv, jnp.int32(t), window=window, softcap=cap)
    tol = 2e-2 if dtype == "bfloat16" else 3e-5
    np.testing.assert_allclose(_np(got), _np(kernel), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)


def test_decode_attention_multi_reader_equals_per_head_loop():
    """The MRB claim: one shared KV read serving G readers equals G
    independent single-reader attentions (readers are independent)."""
    B, C, kv, G, d = 1, 256, 2, 4, 128
    q, k, v = (torch.from_numpy(a) for a in attention_inputs(B, C, kv, G, d))
    t = torch.tensor(100, dtype=torch.int32)
    shared = ring_decode_attention(q, k, v, t)
    qh = q.reshape(B, kv, G, d)
    per_reader = [ring_decode_attention(qh[:, :, g, :].contiguous(), k, v, t).reshape(B, kv, 1, d)
                  for g in range(G)]
    stacked = torch.cat(per_reader, dim=2).reshape(B, kv * G, d)
    np.testing.assert_allclose(shared.numpy(), stacked.numpy(), atol=1e-5, rtol=1e-5)


def test_cpu_wrappers_leave_launch_counts_at_zero():
    kring.launches = 0
    kattn.launches = 0
    q, k, v = (torch.from_numpy(a) for a in attention_inputs(1, 64, 2, 2, 32))
    ring_append(k, torch.tensor(5, dtype=torch.int32), k[:, :1].clone())
    ring_decode_attention(q, k, v, torch.tensor(5, dtype=torch.int32), window=8, softcap=50.0)
    assert (kring.launches, kattn.launches) == (0, 0)


def test_wrappers_refuse_devices_without_a_kernel():
    buf = torch.zeros((1, 4, 1, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ring_append(buf, torch.zeros((), dtype=torch.int32, device="meta"), buf[:, :1])
    q = torch.zeros((1, 2, 32), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ring_decode_attention(q, buf, buf, torch.zeros((), dtype=torch.int32, device="meta"))
