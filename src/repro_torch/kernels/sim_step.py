"""Wrapper of the CUDA self-timed simulation kernel (``csrc/sim_step.cu``).

Replaces the JAX package's Pallas kernel
``src/repro/kernels/sim_step.py::build_pallas_sim``: the whole phased-round
simulation of one phenotype per CTA, state resident in shared memory and
registers, firing times written straight to global memory.  What bounds it
and how its design answers that is noted at the top of the CUDA source.

The source is compiled and bound by :mod:`._build` at first use: ``nvcc``
for ``sm_90a`` into ``build/repro_torch/``, ``ctypes``, a plain
``extern "C"`` launcher that returns ``cudaGetLastError()``.

:func:`sim_step` takes the compact lowering
(:class:`~repro_torch.sim.batched.SimTables`).  On CPU tensors it runs the
plain version, :func:`~repro_torch.sim.batched.simulate_plain`; on CUDA
tensors it launches the kernel or raises — there is no fallback.
:data:`launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..sim.batched import SimTables, simulate_plain
from ._build import CudaLibrary

__all__ = ["sim_step", "round_floor", "build", "launches", "build_info", "LIBRARY"]


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sim_step_launch.argtypes = [p] * 13 + [i] * 10 + [p]
    lib.sim_step_launch.restype = i
    lib.sim_step_smem_bytes.argtypes = [i] * 4
    lib.sim_step_smem_bytes.restype = ctypes.c_size_t
    lib.sim_round_floor_launch.argtypes = [p, i, i, p]
    lib.sim_round_floor_launch.restype = i


LIBRARY = CudaLibrary("sim_step", _bind)
# build() compiles (once) and loads the library; build_info holds its
# path, build seconds and nvcc's -Xptxas -v report.
build = LIBRARY.load
build_info = LIBRARY.info

# Kernel launches made by sim_step (plain-version calls are not counted).
launches = 0


_STATIC = (("kind", torch.int8), ("chan", torch.int16), ("slot", torch.int8),
           ("n_tasks", torch.int32), ("nread", torch.int32), ("delay", torch.int32))
_BATCHED = (("dur", torch.int32), ("route", torch.int32), ("core", torch.int32),
            ("gamma", torch.int32))


def _check(tab: SimTables) -> None:
    dev = tab.device
    B, A, C, Tmax = tab.B, tab.A, tab.C, tab.Tmax
    shapes = dict(
        kind=(A, Tmax), chan=(A, Tmax), slot=(A, Tmax), n_tasks=(A,),
        nread=(C,), delay=(C,), dur=(B, A, Tmax), route=(B, A, Tmax),
        core=(B, A), gamma=(B, C),
    )
    for name, dtype in _STATIC + _BATCHED:
        x = getattr(tab, name)
        if x.device != dev:
            raise ValueError(f"sim_step: {name} is on {x.device}, expected {dev}")
        if x.dtype != dtype:
            raise TypeError(f"sim_step: {name} has dtype {x.dtype}, expected {dtype}")
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"sim_step: {name} has shape {tuple(x.shape)}, expected {shapes[name]}")
        if not x.is_contiguous():
            raise ValueError(f"sim_step: {name} is not contiguous")
    if A > 1024:
        raise ValueError(f"sim_step: one thread per actor allows A <= 1024, got {A}")
    if tab.H > 32:
        raise ValueError(f"sim_step: route bitmask holds 32 interconnects, got {tab.H}")


def sim_step(tab: SimTables, K: int, k_max: int, ports: Optional[int]):
    """Simulate every phenotype of ``tab`` for ``K`` firings per actor.

    Returns ``(fire (B, A, k_max) int32, dead (B,) bool, horizon (B,)
    int32)``, the contract of :func:`~repro_torch.sim.batched.simulate_plain`.
    """
    global launches
    if tab.device.type == "cpu":
        return simulate_plain(tab, K, k_max, ports)
    if tab.device.type != "cuda":
        raise ValueError(f"sim_step: unsupported device {tab.device}")
    _check(tab)
    if not 1 <= K <= k_max:
        raise ValueError(f"sim_step: need 1 <= K <= k_max, got K={K}, k_max={k_max}")
    lib = build()
    dev = tab.device
    B, A = tab.B, tab.A
    fire = torch.full((B, A, k_max), -1, dtype=torch.int32, device=dev)
    dead = torch.empty(B, dtype=torch.bool, device=dev)
    horizon = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return fire, dead, horizon
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.sim_step_launch(
        *(ctypes.c_void_p(getattr(tab, n).data_ptr()) for n, _ in _STATIC + _BATCHED),
        ctypes.c_void_p(fire.data_ptr()), ctypes.c_void_p(dead.data_ptr()),
        ctypes.c_void_p(horizon.data_ptr()),
        B, A, tab.C, tab.R, tab.H, tab.Tmax, k_max, K, tab.max_steps(K),
        -1 if ports is None else int(ports),
        ctypes.c_void_p(stream),
    )
    LIBRARY.check(err, "sim_step")
    launches += 1
    return fire, dead, horizon


def round_floor(threads: int, rounds: int, device) -> torch.Tensor:
    """Launch the round-floor calibration (``csrc/sim_step.cu``): one CTA of
    ``threads`` threads, ``rounds`` dependent rounds of one shared-memory
    write, one barrier and one shared-memory read.  Returns its int32
    output [threads]; time it with CUDA events.  Not the simulator: not
    counted in :data:`launches`."""
    if not 1 <= threads <= 1024:
        raise ValueError(f"round_floor: 1 <= threads <= 1024, got {threads}")
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"round_floor: runs on the card, not on {dev}")
    out = torch.empty(threads, dtype=torch.int32, device=dev)
    err = build().sim_round_floor_launch(
        ctypes.c_void_p(out.data_ptr()), threads, int(rounds),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    LIBRARY.check(err, "sim_round_floor")
    return out
