"""PyTorch/CUDA port of the MRB design-space exploration.

Mirrors the JAX package's layout (``core/``, ``sim/``, ``kernels/``) and
names; imports nothing of it.  The self-timed simulator's hot loop runs in a
hand-written CUDA kernel for Hopper (``csrc/sim_step.cu``), built at first
use; everything else is host Python.  Entry points run on the card unless
the caller passes ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
