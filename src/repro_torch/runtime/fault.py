"""Fault tolerance: heartbeats, straggler detection, elastic re-meshing.

The port's own copy of the JAX package's ``runtime/fault.py`` (pure
Python; nothing here touches a device).  These components are cluster-agnostic state machines (pure Python over
timestamps/step-times) so they can run against a real fleet controller or
the simulated one in tests.  The training loop wires them to checkpoint
restore: on failure → pick the largest feasible mesh from surviving hosts
→ restore latest checkpoint with re-sharded placement → continue.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["HeartbeatMonitor", "StragglerDetector", "MeshPlan", "ElasticController"]


class HeartbeatMonitor:
    """Tracks per-host liveness.  A host missing `timeout_s` is declared
    dead; the controller then excludes it from the next mesh."""

    def __init__(self, hosts: Sequence[str], timeout_s: float = 60.0) -> None:
        self.timeout_s = timeout_s
        self.last_seen: Dict[str, float] = {h: time.monotonic() for h in hosts}

    def beat(self, host: str, now: Optional[float] = None) -> None:
        self.last_seen[host] = time.monotonic() if now is None else now

    def dead(self, now: Optional[float] = None) -> List[str]:
        t = time.monotonic() if now is None else now
        return sorted(h for h, s in self.last_seen.items() if t - s > self.timeout_s)

    def alive(self, now: Optional[float] = None) -> List[str]:
        deads = set(self.dead(now))
        return sorted(h for h in self.last_seen if h not in deads)


class StragglerDetector:
    """Rolling-median step-time outlier detection.

    A host whose step time exceeds ``threshold ×`` the fleet median for
    ``patience`` consecutive steps is flagged.  Mitigation at the caller:
    re-balance (drop to standby / shrink mesh) — on a mesh a straggler
    stalls every collective, so flag-and-replace beats waiting.
    """

    def __init__(self, threshold: float = 2.0, patience: int = 3, window: int = 32) -> None:
        self.threshold = threshold
        self.patience = patience
        self.window = window
        self._times: Dict[str, List[float]] = {}
        self._strikes: Dict[str, int] = {}

    def record(self, host: str, step_time_s: float) -> None:
        buf = self._times.setdefault(host, [])
        buf.append(step_time_s)
        if len(buf) > self.window:
            buf.pop(0)

    def _median_all(self) -> float:
        allv = sorted(v for buf in self._times.values() for v in buf)
        return allv[len(allv) // 2] if allv else 0.0

    def check(self) -> List[str]:
        med = self._median_all()
        flagged = []
        if med <= 0:
            return flagged
        for host, buf in self._times.items():
            if buf and buf[-1] > self.threshold * med:
                self._strikes[host] = self._strikes.get(host, 0) + 1
            else:
                self._strikes[host] = 0
            if self._strikes.get(host, 0) >= self.patience:
                flagged.append(host)
        return sorted(flagged)


@dataclass
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    hosts: Tuple[str, ...]


class ElasticController:
    """Chooses the next mesh after membership changes.

    Policy: keep the model axis fixed (TP degree is an architectural
    choice); scale the data axis down to the largest value such that
    data_axis × model_axis × pod ≤ surviving chips, preferring powers of
    two so batch re-sharding stays even.  Returns a MeshPlan the launcher
    builds its device mesh from, and the checkpoint manager re-shards onto it.
    """

    def __init__(self, chips_per_host: int, model_axis: int) -> None:
        self.chips_per_host = chips_per_host
        self.model_axis = model_axis

    def plan(self, alive_hosts: Sequence[str]) -> Optional[MeshPlan]:
        chips = len(alive_hosts) * self.chips_per_host
        if chips < self.model_axis:
            return None  # cannot even fit one model replica
        data = chips // self.model_axis
        data = 2 ** int(math.log2(data)) if data > 0 else 0
        if data == 0:
            return None
        used_hosts = (data * self.model_axis) // self.chips_per_host
        return MeshPlan(
            shape=(data, self.model_axis),
            axes=("data", "model"),
            hosts=tuple(sorted(alive_hosts)[:used_hosts]),
        )
