"""Wrapper of the CUDA self-timed simulation kernel (``csrc/sim_step.cu``).

Replaces the JAX package's Pallas kernel
``src/repro/kernels/sim_step.py::build_pallas_sim``: the whole phased-round
simulation of one phenotype per CTA, state resident in shared memory and
registers, firing times written straight to global memory.  What bounds it
and how its design answers that is noted at the top of the CUDA source.

The source is compiled with ``nvcc -gencode arch=compute_90a,code=sm_90a``
into ``build/repro_torch/`` (or ``$REPRO_TORCH_BUILD_DIR``) at first use,
keyed by a hash of the source, and bound with ``ctypes`` through a plain
``extern "C"`` launcher that returns ``cudaGetLastError()``.

:func:`sim_step` takes the compact lowering
(:class:`~repro_torch.sim.batched.SimTables`).  On CPU tensors it runs the
plain version, :func:`~repro_torch.sim.batched.simulate_plain`; on CUDA
tensors it launches the kernel or raises — there is no fallback.
:data:`launches` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

from ..sim.batched import SimTables, simulate_plain

__all__ = ["sim_step", "build", "launches", "build_info", "SOURCE"]

SOURCE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc", "sim_step.cu")
_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(__file__))))
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Kernel launches made by sim_step (plain-version calls are not counted).
launches = 0
# Filled by build(): library path, build seconds (0.0 when the library was
# already built), and nvcc's -Xptxas -v report (registers, shared memory).
build_info: dict = {}

_LIB = None
_LOCK = threading.Lock()


def _build_dir() -> str:
    return os.environ.get(
        "REPRO_TORCH_BUILD_DIR", os.path.join(_REPO_ROOT, "build", "repro_torch")
    )


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the sim_step kernel is built on the GPU host")


def build():
    """Compile (if needed) and load the kernel library; returns the
    ``ctypes`` handle.  Thread-safe; the build runs once per source hash."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        with open(SOURCE, "rb") as f:
            digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out_dir = _build_dir()
        lib_path = os.path.join(out_dir, f"sim_step_{digest}.so")
        log_path = lib_path + ".log"
        seconds = 0.0
        if not os.path.exists(lib_path):
            os.makedirs(out_dir, exist_ok=True)
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                capture_output=True, text=True,
            )
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {SOURCE}:\n{proc.stderr}")
            with open(log_path, "w") as f:
                f.write(proc.stdout + proc.stderr)
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(lib_path)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sim_step_launch.argtypes = [p] * 13 + [i] * 10 + [p]
        lib.sim_step_launch.restype = i
        lib.sim_step_error_string.argtypes = [i]
        lib.sim_step_error_string.restype = ctypes.c_char_p
        lib.sim_step_smem_bytes.argtypes = [i] * 4
        lib.sim_step_smem_bytes.restype = ctypes.c_size_t
        log = ""
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        build_info.update(path=lib_path, seconds=seconds, ptxas=log)
        _LIB = lib
        return lib


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
    if err != 0:
        raise RuntimeError(
            f"sim_step launch failed: {lib.sim_step_error_string(err).decode()} ({err})"
        )
    launches += 1
    return fire, dead, horizon
