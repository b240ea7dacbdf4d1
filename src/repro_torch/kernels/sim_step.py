"""Wrapper of the CUDA self-timed simulation kernel (``csrc/sim_step.cu``).

Replaces the JAX package's Pallas kernel
``src/repro/kernels/sim_step.py::build_pallas_sim``: the whole phased-round
simulation of one phenotype per CTA, tables and state in shared memory and
registers, firing times written straight to global memory.  What bounds it
and how its design answers that is noted at the top of the CUDA source.

The source is compiled and bound by :mod:`._build` at first use: ``nvcc``
for ``sm_90a`` into ``build/repro_torch/``, ``ctypes``, a plain
``extern "C"`` launcher that returns ``cudaGetLastError()``.

:func:`sim_step` takes the compact lowering
(:class:`~repro_torch.sim.batched.SimTables`, with its packed tables
``pack``).  On CPU tensors it runs the plain version,
:func:`~repro_torch.sim.batched.simulate_plain`; on CUDA tensors it
launches the kernel or raises — there is no fallback.  :data:`launches`
counts kernel launches.  :func:`launch_plan` is the launch's shape (warps,
actors per thread, shared memory and its layout), worked out on the host
from the table sizes alone.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..sim.batched import SimTables, simulate_plain
from ._build import CudaLibrary

__all__ = [
    "sim_step", "launch_plan", "round_floor", "build", "launches", "build_info", "LIBRARY",
    "SMEM_LIMIT",
]

# Shared memory one CTA may use on an H100 (227 KB).
SMEM_LIMIT = 232_448


def _bind(lib) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sim_step_launch.argtypes = [p] * 11 + [i] * 12 + [p]
    lib.sim_step_launch.restype = i
    lib.sim_step_smem_bytes.argtypes = [i] * 6
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


# ------------------------------------------------------------- the launch
def _layout(A: int, C: int, R: int, H: int, T: int, warps: int) -> dict:
    """Word offsets of the kernel's shared memory (``make_layout`` in the
    CUDA source) and its bytes."""
    sizes = (
        ("desc", T), ("dur", T), ("route", T), ("gam", C), ("nrd", C), ("avail", C * R),
        ("nfull", C), ("rdr", C * R), ("wrt", C), ("blocked", A), ("active", C),
        ("owner", A), ("claim", A), ("icbusy", H), ("gx", warps), ("fw", warps),
        ("fm", warps), ("chcand", A),
    )
    layout, o = {}, 0
    for name, n in sizes:
        layout[name] = o
        o += n
    return dict(layout=layout, smem_bytes=4 * o)


def _plan(A: int, C: int, R: int, H: int, T: int, warps: int) -> dict:
    wv, wc = (C * R + 31) // 32, (C + 31) // 32
    plan = dict(
        warps=warps, actors_per_thread=1, threads=32 * warps,
        mask_words=dict(views=wv, channels=wc), tasks=T,
        pack=dict(off=0, desc=A + 1, gin=A + 1 + T, gout=A + 1 + T + A * wv,
                  words=A + 1 + T + A * (wv + wc)),
        **_layout(A, C, R, H, T, warps),
    )
    if plan["smem_bytes"] > SMEM_LIMIT:
        raise ValueError(f"sim_step: tables need {plan['smem_bytes']} B of shared memory, "
                         f"more than {SMEM_LIMIT}")
    return plan


def launch_plan(A: int, C: int, R: int, H: int, Tmax: int, T: int) -> dict:
    """How :func:`sim_step` launches at these table sizes (``T`` tasks in
    all, at most ``Tmax`` per actor): one actor per thread in ⌈A/32⌉
    warps, so one warp with no block barriers when A ≤ 32.  Gives threads,
    warps, ``actors_per_thread`` (always 1), ``smem_bytes``, the
    shared-memory ``layout`` (word offsets), the ``pack`` layout of :func:`~repro_torch.sim.batched.pack_tables` and
    the gate masks' ``mask_words``.  Raises ``ValueError`` on A outside
    1..1024, H > 32, T > A·Tmax, or tables that overflow shared memory."""
    if not 1 <= A <= 1024:
        raise ValueError(f"sim_step: one CTA holds 1 <= A <= 1024 actors, got {A}")
    if not 0 <= H <= 32:
        raise ValueError(f"sim_step: route bitmask holds 32 interconnects, got {H}")
    if not 0 <= T <= A * Tmax:
        raise ValueError(f"sim_step: {T} tasks do not fit {A} actors of at most {Tmax}")
    return _plan(A, C, R, H, T, (A + 31) // 32)


_STATIC = (("kind", torch.int8), ("chan", torch.int16), ("slot", torch.int8),
           ("n_tasks", torch.int32), ("nread", torch.int32), ("delay", torch.int32))
_BATCHED = (("dur", torch.int32), ("route", torch.int32), ("core", torch.int32),
            ("gamma", torch.int32))
_INPUTS = ("dur", "route", "core", "gamma", "nread", "delay")


def _check(tab: SimTables) -> None:
    dev = tab.device
    B, A, C, Tmax = tab.B, tab.A, tab.C, tab.Tmax
    shapes = dict(
        kind=(A, Tmax), chan=(A, Tmax), slot=(A, Tmax), n_tasks=(A,),
        nread=(C,), delay=(C,), dur=(B, A, Tmax), route=(B, A, Tmax),
        core=(B, A), gamma=(B, C),
    )
    for name, dtype in _STATIC + _BATCHED + (("pack", torch.int32),):
        x = getattr(tab, name)
        if x.device != dev:
            raise ValueError(f"sim_step: {name} is on {x.device}, expected {dev}")
        if x.dtype != dtype:
            raise TypeError(f"sim_step: {name} has dtype {x.dtype}, expected {dtype}")
        if name in shapes and tuple(x.shape) != shapes[name]:
            raise ValueError(f"sim_step: {name} has shape {tuple(x.shape)}, expected {shapes[name]}")
        if not x.is_contiguous():
            raise ValueError(f"sim_step: {name} is not contiguous")


def _launch(tab: SimTables, K: int, k_max: int, ports: Optional[int], plan: dict,
            stats: Optional[dict]):
    """One launch of the kernel with ``plan``'s warps."""
    global launches
    lib = build()
    dev = tab.device
    B, A = tab.B, tab.A
    fire = torch.empty((B, A, k_max), dtype=torch.int32, device=dev)
    dead = torch.empty(B, dtype=torch.bool, device=dev)
    horizon = torch.empty(B, dtype=torch.int32, device=dev)
    rounds = torch.empty(B, dtype=torch.int32, device=dev)
    if stats is not None:
        stats["rounds"] = rounds
    if B == 0:
        return fire, dead, horizon
    err = lib.sim_step_launch(
        ctypes.c_void_p(tab.pack.data_ptr()),
        *(ctypes.c_void_p(getattr(tab, n).data_ptr()) for n in _INPUTS),
        *(ctypes.c_void_p(x.data_ptr()) for x in (fire, dead, horizon, rounds)),
        B, A, tab.C, tab.R, tab.H, tab.Tmax, plan["tasks"], k_max, K, tab.max_steps(K),
        -1 if ports is None else int(ports), plan["warps"],
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream),
    )
    LIBRARY.check(err, "sim_step")
    launches += 1
    return fire, dead, horizon


def sim_step(tab: SimTables, K: int, k_max: int, ports: Optional[int],
             stats: Optional[dict] = None):
    """Simulate every phenotype of ``tab`` for ``K`` firings per actor.

    Returns ``(fire (B, A, k_max) int32, dead (B,) bool, horizon (B,)
    int32)``, the contract of :func:`~repro_torch.sim.batched.simulate_plain`;
    a ``stats`` dict receives ``rounds``, the rounds each element ran, as
    there.
    """
    if tab.device.type == "cpu":
        return simulate_plain(tab, K, k_max, ports, stats=stats)
    if tab.device.type != "cuda":
        raise ValueError(f"sim_step: unsupported device {tab.device}")
    if tab.pack is None:
        raise ValueError("sim_step: the tables carry no pack; build them with compact_tables")
    _check(tab)
    if not 1 <= K <= k_max:
        raise ValueError(f"sim_step: need 1 <= K <= k_max, got K={K}, k_max={k_max}")
    plan = launch_plan(tab.A, tab.C, tab.R, tab.H, tab.Tmax, tab.total_tasks())
    return _launch(tab, K, k_max, ports, plan, stats)


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
