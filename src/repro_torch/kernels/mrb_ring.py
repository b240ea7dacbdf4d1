"""Wrapper of the CUDA MRB ring append (``csrc/mrb_ring.cu``).

:func:`mrb_append` replaces the JAX package's Pallas kernel
``src/repro/kernels/mrb_ring.py::mrb_append``.  The Pallas kernel copies
the whole capacity tile that holds slot ω and returns a new (aliased)
buffer; this kernel writes the one slot **in place**: ``buf[:, ω] =
token``, with ω read from device memory (a negative ω counts from the
end, then ω is clamped into ``[0, C)``, as ``dynamic_update_slice`` does).

:func:`mrb_append_kv` is the decode step's ring update in one launch:
K and V into slot ω of their rings, then ``ω ← (ω + 1) mod C`` (floored,
as the reference's ``(omega + 1) % C``), all on the device.

On CPU tensors both run their plain versions,
:func:`~repro_torch.kernels.ref.mrb_append_ref` and
:func:`~repro_torch.kernels.ref.mrb_append_kv_ref` (also in place); on
CUDA tensors they launch the kernel or raise — there is no fallback.
The launch is bound by the host's path to it, so each wrapper checks a
call's shapes, strides, dtypes and device in full only the first time it
sees that signature, and after that only reads the pointers and the
stream.  :data:`launches` counts the kernel launches of both.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaLibrary
from .ref import mrb_append_kv_ref, mrb_append_ref

__all__ = ["mrb_append", "mrb_append_kv", "launches", "LIBRARY", "DTYPE_CODES"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SIGNATURES = 256  # a signature cache past this size starts again


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mrb_append_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.mrb_append_launch.restype = i
    lib.mrb_append_kv_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, p]
    lib.mrb_append_kv_launch.restype = i


LIBRARY = CudaLibrary("mrb_ring", _bind)

# Kernel launches made by mrb_append and mrb_append_kv (plain-version calls
# are not counted).
launches = 0

# signature → (launcher, its integer arguments, device index, stream getter
# [, nothing to write]); and the last signature seen with its entry, which
# a decode step's layers share (compared without hashing).  The stream
# getter is PyTorch's raw one: device index → stream handle, no Stream
# object made per call.
_seen_one: dict = {}
_seen_kv: dict = {}
_last_one: list = [None, None]
_last_kv: list = [None, None]


def _check(what: str, bufs, omega, tokens) -> None:
    """Today's full checks: each ring [B, C, H, d], each token [B, 1, H, d],
    ω one int32 element, all contiguous on the rings' device, float32 or
    bfloat16 data; rings of one dtype, tokens of one dtype."""
    buf = bufs[0]
    if buf.dim() != 4:
        raise ValueError(f"{what}: buf must be [B, C, H, d], got {tuple(buf.shape)}")
    B, C, H, d = buf.shape
    for x in bufs[1:]:
        if x.shape != buf.shape:
            raise ValueError(f"{what}: rings of shapes {tuple(buf.shape)} and {tuple(x.shape)}")
    for token in tokens:
        if tuple(token.shape) != (B, 1, H, d):
            raise ValueError(f"{what}: token has shape {tuple(token.shape)}, expected {(B, 1, H, d)}")
    if not isinstance(omega, torch.Tensor) or omega.numel() != 1:
        raise ValueError(f"{what}: omega must be a one-element int32 tensor on the card")
    named = [("buf", x) for x in bufs] + [("omega", omega)] + [("token", x) for x in tokens]
    for name, x in named:
        if x.device != buf.device:
            raise ValueError(f"{what}: {name} is on {x.device}, expected {buf.device}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    if omega.dtype != torch.int32:
        raise TypeError(f"{what}: omega has dtype {omega.dtype}, expected torch.int32")
    for name, x in named:
        if name != "omega" and x.dtype not in DTYPE_CODES:
            raise TypeError(f"{what}: {name} has dtype {x.dtype}, expected float32 or bfloat16")
    for group in (bufs, tokens):
        if any(x.dtype != group[0].dtype for x in group):
            raise TypeError(f"{what}: K and V differ in dtype: {[x.dtype for x in group]}")
    if C == 0:
        raise ValueError(f"{what}: the ring has capacity 0")


def _remember(seen: dict, key, entry):
    if len(seen) >= _MAX_SIGNATURES:
        seen.clear()
    seen[key] = entry
    return entry


def _c_ints(*xs):
    """ctypes ints made once per signature (cheaper to pass than Python ints)."""
    return tuple(ctypes.c_int(x) for x in xs)


def mrb_append(buf: torch.Tensor, omega: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """Write ``token`` [B, 1, H, d] at ring slot ``omega`` of ``buf``
    [B, C, H, d], in place, casting it to ``buf.dtype``; returns ``buf``."""
    global launches
    if not buf.is_cuda:
        if buf.device.type == "cpu":
            return mrb_append_ref(buf, omega, token)
        raise ValueError(f"mrb_append: unsupported device {buf.device}")
    # the signature: shapes, strides, dtypes, device indices (a one-element
    # ω is contiguous whatever its strides)
    key = (buf.shape, buf.stride(), buf.dtype, buf.get_device(),
           omega.shape, omega.dtype, omega.get_device(),
           token.shape, token.stride(), token.dtype, token.get_device())
    if key != _last_one[0]:
        entry = _seen_one.get(key)
        if entry is None:
            _check("mrb_append", (buf,), omega, (token,))
            B, C, H, d = buf.shape
            entry = _remember(_seen_one, key, (
                LIBRARY.load().mrb_append_launch,
                _c_ints(B, C, H * d, DTYPE_CODES[buf.dtype], DTYPE_CODES[token.dtype]),
                buf.get_device(), torch._C._cuda_getCurrentRawStream, B * H * d == 0,
            ))
        _last_one[:] = key, entry
    fn, args, index, stream, empty = _last_one[1]
    if empty:
        return buf
    err = fn(buf.data_ptr(), omega.data_ptr(), token.data_ptr(), *args, stream(index))
    if err:
        LIBRARY.check(err, "mrb_append")
    launches += 1
    return buf


def mrb_append_kv(buf_k: torch.Tensor, buf_v: torch.Tensor, omega: torch.Tensor,
                  k: torch.Tensor, v: torch.Tensor) -> None:
    """The decode step's ring update, in place: ``k`` and ``v`` [B, 1, H, d]
    into slot ``omega`` of ``buf_k`` and ``buf_v`` [B, C, H, d] (cast to the
    rings' dtype), then ``omega ← floor_mod(omega + 1, C)``."""
    global launches
    if not buf_k.is_cuda:
        if buf_k.device.type == "cpu":
            mrb_append_kv_ref(buf_k, buf_v, omega, k, v)
            return
        raise ValueError(f"mrb_append_kv: unsupported device {buf_k.device}")
    key = (buf_k.shape, buf_k.stride(), buf_k.dtype, buf_k.get_device(),
           buf_v.shape, buf_v.stride(), buf_v.dtype, buf_v.get_device(),
           omega.shape, omega.dtype, omega.get_device(),
           k.shape, k.stride(), k.dtype, k.get_device(),
           v.shape, v.stride(), v.dtype, v.get_device())
    if key != _last_kv[0]:
        entry = _seen_kv.get(key)
        if entry is None:
            _check("mrb_append_kv", (buf_k, buf_v), omega, (k, v))
            B, C, H, d = buf_k.shape
            entry = _remember(_seen_kv, key, (
                LIBRARY.load().mrb_append_kv_launch,
                _c_ints(B, C, H * d, DTYPE_CODES[buf_k.dtype], DTYPE_CODES[k.dtype]),
                buf_k.get_device(), torch._C._cuda_getCurrentRawStream,
            ))
        _last_kv[:] = key, entry
    fn, args, index, stream = _last_kv[1]
    err = fn(buf_k.data_ptr(), buf_v.data_ptr(), omega.data_ptr(), k.data_ptr(), v.data_ptr(),
             *args, stream(index))
    if err:
        LIBRARY.check(err, "mrb_append_kv")
    launches += 1
