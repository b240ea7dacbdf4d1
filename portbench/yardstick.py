"""The kernel's yardstick: published peaks and the bytes a launch needs.

Peaks are the data sheet's (``peaks.json``), never a time measured on the
card.  :func:`sim_step_bytes` counts what one ``sim_step`` launch must move
whatever implements it: every input table read once and every output
written once, from the launch's shape alone.  The simulation does integer
work only, so its bound is bytes over the HBM bandwidth.
"""
from __future__ import annotations

import json
import os

__all__ = ["peaks", "sim_step_bytes", "sim_step_bound_s"]

_HERE = os.path.dirname(os.path.abspath(__file__))


def peaks(device_name: str) -> dict:
    """The published peaks of the part ``device_name`` names."""
    with open(os.path.join(_HERE, "peaks.json")) as f:
        table = json.load(f)["devices"]
    for key, row in table.items():
        if key in device_name:
            return row
    raise KeyError(f"no published peaks for {device_name!r}")


def sim_step_bytes(B: int, A: int, C: int, R: int, T: int, K: int) -> int:
    """Bytes of one launch over ``B`` rows of ``A`` actors, ``C`` channels of
    at most ``R`` readers, ``T`` tasks in all and ``K`` firings per actor.

    Read once: the packed graph tables (actor offsets ``A + 1``, ``T`` task
    descriptors, per actor ⌈C·R/32⌉ + ⌈C/32⌉ gate words), the readers and
    initial tokens per channel, and per row the live tasks' durations and
    route masks (``2T``), the core of each actor (``A``) and each channel's
    capacity (``C``), all 4-byte words.  Written once: ``fire`` (B, A, K)
    int32, ``dead`` (B,) bool and the end time (B,) int32.  Interconnects
    enter only as the bits of one route word (at most 32)."""
    words_graph = (A + 1) + T + A * ((C * R + 31) // 32 + (C + 31) // 32) + 2 * C
    words_rows = B * (2 * T + A + C)
    return 4 * (words_graph + words_rows) + 4 * B * A * K + B + 4 * B


def sim_step_bound_s(shape: dict, device_name: str) -> float:
    """The least time a launch of ``shape`` can take on the part: its bytes
    over the published HBM bandwidth."""
    b = sim_step_bytes(shape["B"], shape["A"], shape["C"], shape["R"], shape["T"], shape["K"])
    return b / peaks(device_name)["hbm_bytes_per_s"]
