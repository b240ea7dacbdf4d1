"""The port's CUDA kernels against their plain versions, on the card.

Marked ``gpu``: without a CUDA device every test here skips (decided in a
fixture, never at import).  Run on the card with

    python -m pytest -q -m gpu tests/test_torch_cuda.py

The cases are those of ``chip_smoke.py``: ``sim_step``'s kernel-vs-plain
phase at its 32 distinct decodes, and the ring kernels' sweeps (exact for
``mrb_append``; 3e-5 float32 and 2e-2 bfloat16 for
``mrb_decode_attention``).  This file imports no JAX: the card's host has
none.
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", chip_smoke.ATTN_CASES, ids=str)
def test_decode_attention_kernel_matches_plain(device, case, dtype):
    from repro_torch.kernels import decode_attention as kattn

    before = kattn.launches
    chip_smoke.check_attention_case(case, dtype, device)
    assert kattn.launches == before + 1


def test_decode_attention_launch_plan(device):
    """One plan per shape, chosen once: a cluster of 1-16 CTAs, shared
    memory within the card's 227 KB per CTA, 32- or 64-slot stages; the
    served shape's 64-slot ring is one CTA per (batch row, kv head)."""
    from repro_torch.kernels.decode_attention import launch_plan

    cases = (  # B, C, kv, G, d, window, dtype, splits when fixed
        (4, 64, 8, 2, 256, 4096, torch.bfloat16, 1),
        (16, 4096, 8, 2, 128, 0, torch.bfloat16, None),
        (1, 4113, 8, 16, 256, 0, torch.float32, None),
        (2, 1, 1, 16, 256, 0, torch.float32, 1),
    )
    for B, C, kv, G, d, window, dt, splits in cases:
        q = torch.empty((B, kv * G, d), dtype=dt, device=device)
        k = torch.empty((B, C, kv, d), dtype=dt, device=device)
        plan = launch_plan(q, k, window=window)
        assert plan == launch_plan(q, k, window=window)
        assert plan["splits"] in (1, 2, 4, 8, 16) and plan["tile"] in (32, 64)
        assert 0 < plan["smem_bytes"] <= 232448
        if splits is not None:
            assert plan["splits"] == splits, (B, C, kv, G, d, plan)


def test_mrb_append_kernel_matches_plain(device):
    from repro_torch.kernels import mrb_ring as kring

    before = kring.launches
    chip_smoke.check_append(device)
    assert kring.launches > before


def test_ring_wrappers_reject_bad_inputs(device):
    from repro_torch.kernels import ring_append, ring_decode_attention

    buf = torch.zeros((2, 8, 2, 32), device=device)
    tok = torch.zeros((2, 1, 2, 32), device=device)
    om = torch.zeros((), dtype=torch.int32, device=device)
    with pytest.raises(TypeError):
        ring_append(buf.half(), om, tok)
    with pytest.raises(TypeError):
        ring_append(buf, om.long(), tok)
    with pytest.raises(ValueError):
        ring_append(buf[:, ::2], om, tok)  # not contiguous
    with pytest.raises(ValueError):
        ring_append(buf, om.cpu(), tok)
    with pytest.raises(ValueError):
        ring_append(buf, om, tok[:, :, :1])

    q = torch.zeros((2, 4, 32), device=device)
    with pytest.raises(TypeError):
        ring_decode_attention(q.half(), buf, buf, om)
    with pytest.raises(ValueError):
        ring_decode_attention(q, buf, buf, om.cpu())  # t on another device
    with pytest.raises(ValueError):
        ring_decode_attention(q, buf.transpose(1, 2).contiguous().transpose(1, 2), buf, om)
    with pytest.raises(ValueError):
        ring_decode_attention(torch.zeros((2, 34, 32), device=device), buf, buf, om)  # G=17
    with pytest.raises(ValueError):
        big = torch.zeros((1, 4, 1, 512), device=device)
        ring_decode_attention(torch.zeros((1, 1, 512), device=device), big, big, om)


def test_serving_on_the_card_matches_the_cpu(device):
    """Gemma-2 smoke with the ring wrapping: kernels on the card, plain
    versions on the CPU, same logits (1e-4, TF32 off) and tokens."""
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = chip_smoke.phase_ring_wrap(device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    assert out["tokens_identical"]
