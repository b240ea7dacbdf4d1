"""Wrapper of the CUDA multi-reader decode attention (``csrc/decode_attention.cu``).

Replaces the JAX package's Pallas kernel
``src/repro/kernels/decode_attention.py::mrb_decode_attention``: a
thread-block cluster per (batch row, kv head) splits the readable
positions of the ring over its CTAs; each stages its K/V tiles in shared
memory once for all G = H / kv query-head readers through a pipeline of
``cp.async`` copies, and the cluster merges the float32 partials over
distributed shared memory.  What bounds it and how its design answers
that is noted at the top of the CUDA source; :func:`launch_plan` reports
the cluster size and shared memory a shape is launched with.

On CPU tensors :func:`mrb_decode_attention` runs the plain version,
:func:`~repro_torch.kernels.ref.decode_attention_ref`; on CUDA tensors it
launches the kernel or raises — there is no fallback.  :data:`launches`
counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaLibrary
from .mrb_ring import DTYPE_CODES
from .ref import decode_attention_ref

__all__ = [
    "mrb_decode_attention", "launch_plan", "launches", "LIBRARY", "MAX_READERS", "MAX_HEAD_DIM",
]

MAX_READERS = 16    # kMaxG in the source
MAX_HEAD_DIM = 256  # kMaxD in the source


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention_launch.argtypes = [p] * 5 + [i] * 6 + [ctypes.c_float, i, i, p]
    lib.decode_attention_launch.restype = i
    lib.decode_attention_smem_bytes.argtypes = [i, i, i]
    lib.decode_attention_smem_bytes.restype = ctypes.c_size_t
    lib.decode_attention_plan.argtypes = [i] * 8 + [
        ctypes.POINTER(i), ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(i),
    ]
    lib.decode_attention_plan.restype = i
    lib.decode_attention_max_readers.restype = i
    lib.decode_attention_max_head_dim.restype = i
    if (lib.decode_attention_max_readers(), lib.decode_attention_max_head_dim()) != (
        MAX_READERS, MAX_HEAD_DIM,
    ):
        raise RuntimeError("decode_attention: the wrapper's limits differ from the source's")


LIBRARY = CudaLibrary("decode_attention", _bind)

# Kernel launches made by mrb_decode_attention (plain-version calls are not counted).
launches = 0


def _check(q, buf_k, buf_v, t) -> None:
    if q.dim() != 3 or buf_k.dim() != 4:
        raise ValueError(
            f"mrb_decode_attention: need q [B, H, d] and K/V [B, C, kv, d], got "
            f"{tuple(q.shape)} and {tuple(buf_k.shape)}"
        )
    B, C, kv, d = buf_k.shape
    H = q.shape[1]
    if tuple(buf_v.shape) != tuple(buf_k.shape):
        raise ValueError(f"mrb_decode_attention: V has shape {tuple(buf_v.shape)}, K {tuple(buf_k.shape)}")
    if q.shape[0] != B or q.shape[2] != d or kv == 0 or H % kv:
        raise ValueError(
            f"mrb_decode_attention: q {tuple(q.shape)} does not fit K/V {tuple(buf_k.shape)}"
        )
    if not isinstance(t, torch.Tensor) or t.numel() != 1:
        raise ValueError("mrb_decode_attention: t must be a one-element int32 tensor on the card")
    for name, x in (("q", q), ("buf_k", buf_k), ("buf_v", buf_v), ("t", t)):
        if x.device != q.device:
            raise ValueError(f"mrb_decode_attention: {name} is on {x.device}, expected {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"mrb_decode_attention: {name} is not contiguous")
    if t.dtype != torch.int32:
        raise TypeError(f"mrb_decode_attention: t has dtype {t.dtype}, expected torch.int32")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"mrb_decode_attention: q has dtype {q.dtype}, expected float32 or bfloat16")
    if buf_k.dtype not in DTYPE_CODES or buf_v.dtype != buf_k.dtype:
        raise TypeError(
            f"mrb_decode_attention: K/V have dtypes {buf_k.dtype}/{buf_v.dtype}, "
            "expected one of float32, bfloat16 for both"
        )
    G = H // kv
    if B == 0 or C == 0 or G == 0:
        raise ValueError(f"mrb_decode_attention: empty problem B={B}, C={C}, G={G}")
    if G > MAX_READERS:
        raise ValueError(f"mrb_decode_attention: {G} readers per kv head, at most {MAX_READERS}")
    if d > MAX_HEAD_DIM or (d * buf_k.element_size()) % 16:
        raise ValueError(
            f"mrb_decode_attention: head dim {d} must be at most {MAX_HEAD_DIM} and a "
            "multiple of 16 bytes of K/V"
        )
    for name, x in (("buf_k", buf_k), ("buf_v", buf_v)):
        if x.data_ptr() % 16:
            raise ValueError(f"mrb_decode_attention: {name} is not 16-byte aligned")


def launch_plan(q: torch.Tensor, buf_k: torch.Tensor, *, window: int = 0) -> dict:
    """The cluster size (``splits``), dynamic shared memory per CTA
    (``smem_bytes``) and ring slots per shared-memory stage (``tile``) that
    :func:`mrb_decode_attention` launches with for these CUDA tensors'
    shape and dtypes; chosen once per shape."""
    B, C, kv, d = buf_k.shape
    G = q.shape[1] // kv
    lib = LIBRARY.load()
    splits, smem, tile = ctypes.c_int(0), ctypes.c_size_t(0), ctypes.c_int(0)
    err = lib.decode_attention_plan(
        B, C, kv, G, d, int(window), DTYPE_CODES[q.dtype], DTYPE_CODES[buf_k.dtype],
        ctypes.byref(splits), ctypes.byref(smem), ctypes.byref(tile),
    )
    LIBRARY.check(err, "mrb_decode_attention plan")
    return dict(splits=splits.value, smem_bytes=smem.value, tile=tile.value)


def mrb_decode_attention(
    q: torch.Tensor,
    buf_k: torch.Tensor,
    buf_v: torch.Tensor,
    t: torch.Tensor,
    *,
    window: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """q: [B, H, d]; buf_k/v: [B, C, kv, d]; t: one-element int32 position.
    ``window`` 0 means unlimited.  Returns [B, H, d] in ``q.dtype``."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_ref(q, buf_k, buf_v, t, window, softcap)
    if q.device.type != "cuda":
        raise ValueError(f"mrb_decode_attention: unsupported device {q.device}")
    _check(q, buf_k, buf_v, t)
    lib = LIBRARY.load()
    B, C, kv, d = buf_k.shape
    G = q.shape[1] // kv
    out = torch.empty_like(q)
    err = lib.decode_attention_launch(
        q.data_ptr(), buf_k.data_ptr(), buf_v.data_ptr(), t.data_ptr(), out.data_ptr(),
        B, C, kv, G, d, int(window), float(softcap),
        DTYPE_CODES[q.dtype], DTYPE_CODES[buf_k.dtype],
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    LIBRARY.check(err, "mrb_decode_attention")
    launches += 1
    return out
