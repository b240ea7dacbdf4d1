"""The CUDA decode-attention kernel's split-and-merge arithmetic, on the CPU.

``repro_torch.kernels.ref.decode_attention_split_ref`` walks the readable
positions of the ring, cuts them into ``splits`` ranges as the kernel's
thread-block cluster does, and merges the float32 partials as the kernel
does.  Here it is held against the port's plain version
(``decode_attention_ref``) and against the JAX package's Pallas kernel
(interpret mode) and its jnp oracle, on numpy-seeded inputs, at the
tolerances of ``tests/test_torch_ring_kernels.py``: 3e-5 in float32
(summation order) and 2e-2 in bfloat16 (where each side rounds).  The cases
reach the merge's edges: many splits, splits with no readable position
(their maxima are -inf), a window smaller than one tile, a deep wrap,
capacity 1, G=16, and no readable position at all (t < 0: the mean of V).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import mrb_decode_attention as jax_decode_attention
from repro.kernels.ref import decode_attention_ref as jax_attention_ref
from repro_torch.kernels import ref

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"float32": 3e-5, "bfloat16": 2e-2}

BASE = (2, 512, 4, 3, 128, 0, 0.0, 700)  # B, C, kv, G, d, window, softcap, t: wrapped, full
CASES = {  # name: (B, C, kv, G, d, window, softcap, t, splits)
    "partial_fill_most_splits_empty": (2, 1024, 2, 2, 64, 0, 0.0, 10, 8),
    "window_below_one_tile": (1, 512, 2, 4, 64, 5, 30.0, 300, 3),
    "deep_wrap_window": (1, 1024, 8, 2, 128, 512, 0.0, 2000, 8),
    "deep_wrap_softcap": (1, 256, 2, 2, 128, 0, 50.0, 5000, 4),
    "capacity_1": (2, 1, 1, 16, 32, 0, 0.0, 7, 2),
    "g16": (1, 256, 1, 16, 64, 0, 50.0, 300, 2),
}


def _inputs(B, C, kv, G, d, dtype, seed=7):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape, dtype=np.float32) * 0.3
              for shape in ((B, kv * G, d), (B, C, kv, d), (B, C, kv, d))]
    jd, td = DTYPES[dtype]
    return [jnp.asarray(a).astype(jd) for a in arrays], [torch.from_numpy(a).to(td) for a in arrays]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _check(B, C, kv, G, d, window, cap, t, splits, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(B, C, kv, G, d, dtype)
    tt = torch.tensor(t, dtype=torch.int32)
    got = ref.decode_attention_split_ref(tq, tk, tv, tt, window, cap, splits)
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, kv * G, d)
    assert torch.isfinite(got.float()).all()
    plain = ref.decode_attention_ref(tq, tk, tv, tt, window, cap)
    kernel = jax_decode_attention(jq, jk, jv, jnp.int32(t), window=window, softcap=cap,
                                  block=min(256, C), interpret=True)
    oracle = jax_attention_ref(jq, jk, jv, jnp.int32(t), window=window, softcap=cap)
    tol = TOL[dtype]
    for want in (plain, kernel, oracle):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("splits", [1, 2, 3, 8])
def test_split_ref_matches_plain_and_jax(splits, dtype):
    _check(*BASE, splits, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES), ids=str)
def test_split_ref_edge_cases(case, dtype):
    _check(*CASES[case], dtype)


def test_split_ranges_cover_exactly_the_readable_positions():
    """Each position's value lands in the output once: with V one-hot in
    the position and all scores equal, the output is the uniform average
    over exactly the readable positions, whatever the number of splits."""
    B, C, kv, G, d = 1, 96, 1, 2, 128
    for t, window in ((10, 0), (95, 0), (300, 0), (300, 40), (300, 200), (33, 7)):
        pos = t - np.mod(t - np.arange(C), C)  # the position each slot holds
        readable = (pos >= 0) & ((pos > t - window) if window > 0 else True)
        v = np.zeros((B, C, kv, d), np.float32)
        v[0, np.arange(C), 0, np.arange(C)] = 1.0
        q = np.zeros((B, kv * G, d), np.float32)
        for splits in (1, 2, 3, 5, 16):
            out = ref.decode_attention_split_ref(
                torch.from_numpy(q), torch.from_numpy(v), torch.from_numpy(v),
                torch.tensor(t, dtype=torch.int32), window, 0.0, splits,
            )
            want = np.zeros(d, np.float32)
            want[:C][readable] = 1.0 / readable.sum()
            np.testing.assert_allclose(out[0, 0].numpy(), want, atol=1e-7)


def test_split_ref_without_readable_positions_is_zero():
    """No readable position (t < 0): the split reference gives what the
    JAX package's oracle gives, the mean of V over all C slots (its softmax
    over C equally masked scores is uniform), finite, not NaN.  The name
    predates that fix: the split reference used to return zeros here."""
    (jq, jk, jv), (q, k, v) = _inputs(1, 64, 2, 2, 32, "float32")
    out = ref.decode_attention_split_ref(q, k, v, torch.tensor(-1, dtype=torch.int32), 0, 0.0, 4)
    want = jax_attention_ref(jq, jk, jv, jnp.int32(-1))
    assert torch.isfinite(out).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=TOL["float32"],
                               rtol=TOL["float32"])
    mean_v = v.mean(dim=1).repeat_interleave(2, dim=1)  # [B, kv*G, d], G = 2
    np.testing.assert_allclose(out.numpy(), mean_v.numpy(), atol=TOL["float32"],
                               rtol=TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (5, 30.0)], ids=["no_window", "window"])
def test_no_readable_position_gives_the_mean_of_v(window, cap, dtype):
    """t = -1, with and without a window: the plain version and the split
    reference at several split counts equal the JAX package's oracle and
    its Pallas kernel (interpret mode), all the mean of V."""
    B, C, kv, G, d = 2, 96, 2, 3, 64
    (jq, jk, jv), (q, k, v) = _inputs(B, C, kv, G, d, dtype)
    tt = torch.tensor(-1, dtype=torch.int32)
    oracle = jax_attention_ref(jq, jk, jv, jnp.int32(-1), window=window, softcap=cap)
    kernel = jax_decode_attention(jq, jk, jv, jnp.int32(-1), window=window, softcap=cap,
                                  block=32, interpret=True)
    mean_v = v.float().mean(dim=1).repeat_interleave(G, dim=1)
    tol = TOL[dtype]
    got = [ref.decode_attention_ref(q, k, v, tt, window, cap)]
    got += [ref.decode_attention_split_ref(q, k, v, tt, window, cap, splits)
            for splits in (1, 2, 3, 8)]
    for out in got:
        assert out.dtype == q.dtype and tuple(out.shape) == (B, kv * G, d)
        for want in (oracle, kernel, mean_v):
            np.testing.assert_allclose(_np(out), _np(want), atol=tol, rtol=tol)
