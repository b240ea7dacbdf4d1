"""Wrapper of the CUDA MRB ring append (``csrc/mrb_ring.cu``).

Replaces the JAX package's Pallas kernel
``src/repro/kernels/mrb_ring.py::mrb_append``.  The Pallas kernel copies
the whole capacity tile that holds slot ω and returns a new (aliased)
buffer; this kernel writes the one slot **in place**: ``buf[:, ω] =
token``, with ω read from device memory (a negative ω counts from the
end, then ω is clamped into ``[0, C)``, as ``dynamic_update_slice`` does).

On CPU tensors :func:`mrb_append` runs the plain version,
:func:`~repro_torch.kernels.ref.mrb_append_ref` (also in place); on CUDA
tensors it launches the kernel or raises — there is no fallback.
:data:`launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import CudaLibrary
from .ref import mrb_append_ref

__all__ = ["mrb_append", "launches", "LIBRARY", "DTYPE_CODES"]

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mrb_append_launch.argtypes = [p, p, p, i, i, i, i, i, p]
    lib.mrb_append_launch.restype = i


LIBRARY = CudaLibrary("mrb_ring", _bind)

# Kernel launches made by mrb_append (plain-version calls are not counted).
launches = 0


def _check(buf: torch.Tensor, omega: torch.Tensor, token: torch.Tensor) -> None:
    if buf.dim() != 4:
        raise ValueError(f"mrb_append: buf must be [B, C, H, d], got {tuple(buf.shape)}")
    B, _, H, d = buf.shape
    if tuple(token.shape) != (B, 1, H, d):
        raise ValueError(f"mrb_append: token has shape {tuple(token.shape)}, expected {(B, 1, H, d)}")
    if not isinstance(omega, torch.Tensor) or omega.numel() != 1:
        raise ValueError("mrb_append: omega must be a one-element int32 tensor on the card")
    for name, x in (("buf", buf), ("omega", omega), ("token", token)):
        if x.device != buf.device:
            raise ValueError(f"mrb_append: {name} is on {x.device}, expected {buf.device}")
        if not x.is_contiguous():
            raise ValueError(f"mrb_append: {name} is not contiguous")
    if omega.dtype != torch.int32:
        raise TypeError(f"mrb_append: omega has dtype {omega.dtype}, expected torch.int32")
    for name, x in (("buf", buf), ("token", token)):
        if x.dtype not in DTYPE_CODES:
            raise TypeError(f"mrb_append: {name} has dtype {x.dtype}, expected float32 or bfloat16")


def mrb_append(buf: torch.Tensor, omega: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """Write ``token`` [B, 1, H, d] at ring slot ``omega`` of ``buf``
    [B, C, H, d], in place, casting it to ``buf.dtype``; returns ``buf``."""
    global launches
    if buf.device.type == "cpu":
        return mrb_append_ref(buf, omega, token)
    if buf.device.type != "cuda":
        raise ValueError(f"mrb_append: unsupported device {buf.device}")
    _check(buf, omega, token)
    lib = LIBRARY.load()
    B, C, H, d = buf.shape
    if C == 0:
        raise ValueError("mrb_append: the ring has capacity 0")
    if B == 0 or H * d == 0:
        return buf
    err = lib.mrb_append_launch(
        buf.data_ptr(), omega.data_ptr(), token.data_ptr(), B, C, H * d,
        DTYPE_CODES[buf.dtype], DTYPE_CODES[token.dtype],
        torch.cuda.current_stream(buf.device).cuda_stream,
    )
    LIBRARY.check(err, "mrb_append")
    launches += 1
    return buf
