"""Device resolution for the port: the counterpart of the JAX package's
``kernels/ops.py::on_tpu``.

Every entry point of the port runs on the card unless its caller asks for
the CPU.  ``resolve_device("cuda")`` (the default everywhere) raises when no
CUDA device is present or when it is not a Hopper part (compute capability
9.0), because the hand-written kernels are built for ``sm_90a`` only;
``resolve_device("cpu")`` is the explicit request for the plain torch path.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "HOPPER_CAPABILITY"]

HOPPER_CAPABILITY = (9, 0)


def resolve_device(device="cuda") -> torch.device:
    """The ``torch.device`` for ``device`` (a string or device); raises
    ``RuntimeError`` when CUDA is requested and absent or not Hopper."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r}: expected 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but no CUDA device is available; "
            "pass device='cpu' to run the plain torch path"
        )
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    cap = torch.cuda.get_device_capability(index)
    if tuple(cap) != HOPPER_CAPABILITY:
        raise RuntimeError(
            f"device {index} has compute capability {cap}; the port's kernels "
            f"are built for sm_90a (capability {HOPPER_CAPABILITY})"
        )
    return torch.device("cuda", index)
