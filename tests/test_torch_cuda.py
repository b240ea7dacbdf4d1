"""The CUDA ``sim_step`` kernel against its plain version, on the card.

Marked ``gpu``: without a CUDA device every test here skips (decided in a
fixture, never at import).  Run on the card with

    python -m pytest -q -m gpu tests/test_torch_cuda.py

The cases are those of ``chip_smoke.py``'s kernel-vs-plain phase, at their
32 distinct decodes.  This file imports no JAX: the card's host has none.
"""
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from repro_torch import resolve_device

    return resolve_device("cuda")


@pytest.mark.parametrize("case", chip_smoke.CASES, ids=[c[0] for c in chip_smoke.CASES])
def test_kernel_matches_plain(device, case):
    from repro_torch.kernels import sim_step as kmod

    _, app, xi, ports = case
    gt, arch, scheds, cfg = chip_smoke.build_case(app, xi, ports)
    tab = chip_smoke.case_tables(gt, arch, scheds, device)
    before = kmod.launches
    for K, k_max in ((16, 16), (32, 32), (5, 8)):
        err, _ = chip_smoke.compare_kernel_plain(tab, K, k_max, cfg.mrb_ports)
        assert err == 0
    assert kmod.launches == before + 3


def test_kernel_path_matches_events(device):
    from repro_torch.sim import batch_simulate, simulate

    gt, arch, scheds, cfg = chip_smoke.build_case("sobel4", 1, None)
    mine = batch_simulate(gt, arch, scheds[:8], cfg, backend="cuda", device=device)
    for s, m in zip(scheds[:8], mine):
        e = simulate(gt, arch, s, cfg)
        assert (m.fire_times, m.period, m.deadlocked) == (e.fire_times, e.period, e.deadlocked)


def test_wrapper_rejects_bad_inputs(device):
    from repro_torch.kernels import sim_step as kmod

    gt, arch, scheds, _ = chip_smoke.build_case("sobel", 1, None)
    tab = chip_smoke.case_tables(gt, arch, scheds, device)
    bad = chip_smoke.case_tables(gt, arch, scheds, device)
    bad.dur = bad.dur.to(torch.int64)
    with pytest.raises(TypeError):
        kmod.sim_step(bad, 16, 16, None)
    with pytest.raises(ValueError):
        kmod.sim_step(tab, 32, 16, None)
