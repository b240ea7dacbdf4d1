"""Mesh construction: the counterpart of the JAX package's ``launch/mesh.py``.

Single pod: 16×16 = 256 devices, axes (data, model).
Multi-pod:  2×16×16 = 512 devices, axes (pod, data, model); the pod axis is
pure data parallelism across hosts.

A :class:`~torch.distributed.device_mesh.DeviceMesh` needs a process group
of its size.  :func:`fake_process_group` opens one of any size in this
process (every collective a no-op) for the dry run, which plans the
production meshes on fake tensors; :class:`AbstractMesh` carries a mesh's
shape and axis names alone, which is all the sharding rules read.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterator, Tuple

import torch.distributed as dist

__all__ = ["HW", "AbstractMesh", "make_production_mesh", "make_mesh", "production_shape",
           "fake_process_group"]


class HW:
    """NVIDIA H100 SXM constants read by the dry run's memory check and
    roofline (``launch/dryrun.py``).  The rates are NVIDIA's data sheet
    (dense, at the full 700 W power limit), not measured.  ``HBM_BYTES`` is
    ``torch.cuda.get_device_properties(0).total_memory`` as ``chip_smoke.py``
    phase 16 read it on "NVIDIA H100 80GB HBM3, 700.00 W"."""

    PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 (data sheet)
    HBM_BW = 3.35e12                # bytes/s (data sheet)
    NVLINK_BW = 450e9               # bytes/s per GPU, each way, NVLink 4 (data sheet)
    INTER_NODE_BW = 50e9            # bytes/s per GPU, one 400 Gb/s NIC each (DGX H100)
    GPUS_PER_NODE = 8               # NVLink domain of one DGX H100 node
    HBM_BYTES = 85_017_493_504      # total_memory on the card (chip_smoke.py phase 16)


@dataclass(frozen=True)
class AbstractMesh:
    """A mesh's shape and axis names without devices or a process group:
    what the sharding rules need to compute specs (the counterpart of
    ``jax.sharding.AbstractMesh``)."""

    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


def production_shape(*, multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's shape and axis names."""
    if multi_pod:
        return AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    return AbstractMesh((16, 16), ("data", "model"))


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], *, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    default process group, which must be open and of the mesh's size."""
    from torch.distributed.device_mesh import init_device_mesh

    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an open process group (init_process_group, "
                           "or fake_process_group for a dry run)")
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production mesh (16×16, or 2×16×16 with ``multi_pod``)."""
    m = production_shape(multi_pod=multi_pod)
    return make_mesh(m.shape, m.mesh_dim_names, device_type=device_type)


@contextlib.contextmanager
def fake_process_group(world_size: int) -> Iterator[None]:
    """A process group of ``world_size`` ranks in this process, as rank 0,
    whose collectives move nothing (PyTorch's ``fake`` backend): meshes of
    any size can be built and planned on fake tensors.  Raises if a group
    is already open; the group is destroyed on exit, also on an error."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already open in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
