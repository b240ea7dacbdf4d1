"""Deterministic, seeded fault injection for the campaign service stack.

Zero dependencies, off by default, and *provably inert* when off: the
disabled path of :func:`fire` is one module-global read and a ``None``
check — the same cached-flag idiom as :mod:`repro_torch.obs` — so injection
sites can live inside the store/scheduler/HTTP hot paths permanently.

Enable by pointing ``REPRO_FAULTS`` at a :class:`FaultPlan` JSON file
(worker processes inherit the environment, so one plan governs the whole
pool), or programmatically via :func:`configure`.

A plan is a seed plus a list of :class:`FaultRule`\\ s.  Each rule names
an **injection site** (``store.save_cell``, ``sched.mid_decode``,
``http.request``, ... — ``fnmatch`` patterns allowed), a fault **kind**,
a probability ``p``, and a global fire budget ``max_fires``.  Generic
kinds are performed by the injector itself:

* ``crash`` — ``SIGKILL`` the calling process (models power loss /
  OOM-kill: no ``atexit``, no ``finally``, nothing flushes);
* ``hang``  — sleep ``delay_s`` (models a wedged decode; recovery must
  come from the supervisor's deadline/heartbeat machinery);
* ``slow`` / ``delay`` — sleep ``delay_s`` then proceed;
* ``error`` — raise :class:`FaultInjected`.

Any other kind (``torn``, ``lost``, ``corrupt``, ``reset``,
``error_5xx``, ``stall``, ``skip``, ...) is returned to the call site,
which implements the site-specific semantics — so ``fire`` both *is*
the fault for generic kinds and *selects* it for site-specific ones.

Determinism and replayability:

* rule draws use a per-rule ``random.Random(f"{seed}:{rule_index}")``
  stream — a plan replays the same draw sequence per call stream;
* ``max_fires`` is enforced **globally across processes** through
  ``O_CREAT|O_EXCL`` ticket files next to the fired log, so "crash the
  worker once" means once per chaos run, not once per worker;
* every fire is appended (``O_APPEND``, single ``write``) to the plan's
  ``fired_log`` *before* the fault acts, so even a ``crash`` fault
  leaves its audit line — the convergence checker uses this log to
  prove site-class coverage.
"""
from __future__ import annotations

import fnmatch
import json
import os
import random
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Union

__all__ = [
    "FAULTS_ENV",
    "FaultInjected",
    "FaultPlan",
    "FaultRule",
    "configure",
    "enabled",
    "fire",
    "kill_self",
    "read_fired_log",
    "reset",
]

FAULTS_ENV = "REPRO_FAULTS"

#: Kinds the injector performs itself; everything else is returned to
#: the call site.
GENERIC_KINDS = ("crash", "hang", "slow", "delay", "error")


class FaultInjected(RuntimeError):
    """Raised by ``fire`` for rules of kind ``error``."""

    def __init__(self, site: str) -> None:
        super().__init__(f"injected fault at {site}")
        self.site = site


def kill_self() -> None:  # pragma: no cover — the caller never returns
    """SIGKILL the current process: no cleanup of any kind runs, which
    is the point — crash faults model power loss, not graceful exits."""
    os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(60)  # the signal is async; never proceed past this line


# ==========================================================================
# Plan model
# ==========================================================================
@dataclass
class FaultRule:
    site: str                    # exact site name or fnmatch pattern
    kind: str                    # generic (GENERIC_KINDS) or site-specific
    p: float = 1.0               # per-eligible-call fire probability
    max_fires: int = 1           # global budget across all processes
    delay_s: float = 0.05        # sleep for hang/slow/delay/stall kinds
    note: str = ""               # free-form, carried into the fired log

    def to_json(self) -> Dict[str, Any]:
        return {
            "site": self.site, "kind": self.kind, "p": self.p,
            "max_fires": self.max_fires, "delay_s": self.delay_s,
            "note": self.note,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "FaultRule":
        return cls(
            site=str(d["site"]), kind=str(d["kind"]),
            p=float(d.get("p", 1.0)), max_fires=int(d.get("max_fires", 1)),
            delay_s=float(d.get("delay_s", 0.05)), note=str(d.get("note", "")),
        )


@dataclass
class FaultPlan:
    seed: int = 0
    rules: List[FaultRule] = field(default_factory=list)
    #: Append-only jsonl audit of every fire; also anchors the ticket
    #: directory (``<fired_log>.tickets/``) that makes ``max_fires``
    #: global.  Without it, budgets are per-process.
    fired_log: Optional[str] = None
    name: str = ""

    def to_json(self) -> Dict[str, Any]:
        return {
            "seed": self.seed, "name": self.name,
            "fired_log": self.fired_log,
            "rules": [r.to_json() for r in self.rules],
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "FaultPlan":
        return cls(
            seed=int(d.get("seed", 0)),
            rules=[FaultRule.from_json(r) for r in d.get("rules", [])],
            fired_log=d.get("fired_log"),
            name=str(d.get("name", "")),
        )

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")
        return path

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as f:
            return cls.from_json(json.load(f))


# ==========================================================================
# Per-process injection state
# ==========================================================================
class _State:
    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        # Per-rule seeded streams: draw sequences replay for a given
        # (seed, rule index) regardless of dict ordering or other rules.
        self.rngs = [
            random.Random(f"{plan.seed}:{i}") for i in range(len(plan.rules))
        ]
        self.local_counts = [0] * len(plan.rules)
        self.tickets_dir: Optional[str] = None
        if plan.fired_log:
            self.tickets_dir = plan.fired_log + ".tickets"
            os.makedirs(self.tickets_dir, exist_ok=True)

    # ------------------------------------------------------------- budget
    def _take_ticket(self, idx: int, rule: FaultRule) -> bool:
        if rule.max_fires <= 0:
            return True  # unlimited budget
        if self.tickets_dir is None:
            if self.local_counts[idx] >= rule.max_fires:
                return False
            self.local_counts[idx] += 1
            return True
        for n in range(rule.max_fires):
            path = os.path.join(self.tickets_dir, f"r{idx}.{n}")
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o666)
            except FileExistsError:
                continue
            os.close(fd)
            return True
        return False

    def _log_fire(self, idx: int, rule: FaultRule, site: str,
                  ctx: Dict[str, Any]) -> None:
        record = {
            "site": site, "kind": rule.kind, "rule": idx,
            "pid": os.getpid(), "note": rule.note,
        }
        record.update(
            (k, v) for k, v in ctx.items()
            if isinstance(v, (str, int, float, bool))
        )
        line = json.dumps(record, sort_keys=True) + "\n"
        if self.plan.fired_log is None:
            return
        # One O_APPEND write: atomic enough for jsonl, and it lands even
        # when the very next statement is SIGKILL.
        fd = os.open(
            self.plan.fired_log, os.O_CREAT | os.O_APPEND | os.O_WRONLY, 0o666
        )
        try:
            os.write(fd, line.encode())
        finally:
            os.close(fd)

    # --------------------------------------------------------------- fire
    def fire(self, site: str, ctx: Dict[str, Any]) -> Optional[str]:
        for idx, rule in enumerate(self.plan.rules):
            if rule.site != site and not fnmatch.fnmatch(site, rule.site):
                continue
            if rule.p < 1.0 and self.rngs[idx].random() >= rule.p:
                continue
            if not self._take_ticket(idx, rule):
                continue
            self._log_fire(idx, rule, site, ctx)
            if rule.kind == "crash":
                kill_self()
            if rule.kind == "hang":
                time.sleep(max(rule.delay_s, 1.0))
                return None
            if rule.kind in ("slow", "delay"):
                time.sleep(rule.delay_s)
                return None
            if rule.kind == "error":
                raise FaultInjected(site)
            return rule.kind  # site-specific: the call site acts
        return None


# ==========================================================================
# Module gate — mirrors repro_torch.obs: the disabled path never touches
# os.environ (a missing-key environ.get costs ~1µs via internal KeyError).
# ==========================================================================
_LOCK = threading.Lock()
#: tri-state programmatic override: None = follow the env,
#: False = forced off, FaultPlan = forced on with that plan.
_CONFIGURED: Union[None, bool, FaultPlan] = None
_ON: Optional[bool] = None  # cached gate; None = not yet computed
_STATE: Optional[_State] = None


def configure(plan: Union[None, bool, FaultPlan] = None) -> None:
    """Programmatic override of the ``REPRO_FAULTS`` gate (tests, the
    chaos driver).  ``configure(plan)`` arms the given plan;
    ``configure(False)`` disarms; ``configure(None)`` re-follows the
    environment."""
    global _CONFIGURED, _ON, _STATE
    with _LOCK:
        _CONFIGURED = plan
        _ON = None
        _STATE = None


def reset() -> None:
    """Alias for ``configure(None)`` — drop all cached state."""
    configure(None)


def _compute() -> bool:
    global _ON, _STATE
    with _LOCK:
        if _ON is not None:
            return _ON
        plan: Optional[FaultPlan] = None
        if isinstance(_CONFIGURED, FaultPlan):
            plan = _CONFIGURED
        elif _CONFIGURED is None:
            value = os.environ.get(FAULTS_ENV, "")
            if value:
                try:
                    if value.lstrip().startswith("{"):
                        plan = FaultPlan.from_json(json.loads(value))
                    else:
                        plan = FaultPlan.load(value)
                except (OSError, ValueError, KeyError):
                    plan = None  # unreadable plan: stay inert, never crash
        _STATE = _State(plan) if plan is not None and plan.rules else None
        _ON = _STATE is not None
        return _ON


def enabled() -> bool:
    on = _ON
    if on is None:
        on = _compute()
    return on


def fire(site: str, **ctx: Any) -> Optional[str]:
    """Evaluate the active plan at ``site``.  Returns ``None`` (no
    fault, or a generic fault already performed) or a site-specific kind
    string for the caller to act on.  With faults disabled this is one
    global read and a comparison."""
    on = _ON
    if on is None:
        on = _compute()
    if not on:
        return None
    state = _STATE
    if state is None:  # pragma: no cover — configure() race
        return None
    return state.fire(site, ctx)


def read_fired_log(path: str) -> List[Dict[str, Any]]:
    """Parsed fired-log records (torn trailing lines — a crash fault can
    interrupt anything except the O_APPEND itself — are skipped)."""
    out: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    continue
    except OSError:
        return []
    return out
