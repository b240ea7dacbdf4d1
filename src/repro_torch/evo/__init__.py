"""Device-resident evolutionary subsystem: the ``torch_nsga2`` explorer.

Populations as dense tensors on the card, NSGA-II ranking and variation as
torch ops, and a batched list-scheduling relaxation of the caps_hms decode
whose ``sim_period`` is measured by the ``sim_step`` CUDA kernel on tables
the decode writes on the device:

* :mod:`repro_torch.evo.encoding`  — gene matrix layout (ξ | C_d | β_A);
* :mod:`repro_torch.evo.ranking`   — bit-exact float64 non-dominated sort + crowding;
* :mod:`repro_torch.evo.decode`    — per-ξ-pattern relaxed decode → simulate tables;
* :mod:`repro_torch.evo.variation` — tournament / crossover / mutation;
* :mod:`repro_torch.evo.explorer`  — the registered explorer (exact + relaxed paths).

Importing this package registers ``torch_nsga2`` in the explorer registry.
"""
from .encoding import PopulationLayout
from .explorer import TorchNSGA2Explorer

__all__ = ["PopulationLayout", "TorchNSGA2Explorer"]
