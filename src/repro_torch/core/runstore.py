"""Content-addressed, resumable artifact store for campaign cells.

A :class:`RunStore` holds the results of one campaign under
``runs/campaigns/<campaign_id>/``:

* ``manifest.json`` — the campaign spec plus its full ordered cell list
  (tags + canonical spec hashes).  The manifest is *deterministic*: it
  contains no timestamps or wall times, so an interrupted-then-resumed
  campaign produces a byte-identical manifest to an uninterrupted one.
* ``cells/<spec_hash>.json`` — one artifact per completed cell (the cell
  spec + its serialized :class:`~repro_torch.core.explorers.ExplorationRun`),
  written atomically (temp file + ``os.replace``) so a killed campaign
  never leaves a torn artifact; whatever is present is trustworthy, which
  is exactly what makes ``campaign resume`` free.
* ``report.json`` — the cross-cell report (fronts, relative-hypervolume
  table, per-backend timing); derived data, regenerate at will.
* ``claims/<spec_hash>.claim`` — in-flight execution claims (service
  mode).  A claim is taken with ``O_CREAT|O_EXCL`` — the filesystem is
  the arbiter, so two workers (threads, processes, or machines sharing
  the store) can never both decode the same cell; claim files carry
  their owner and are refreshed as a heartbeat, so a claim whose owner
  died (SIGKILL) goes stale and is taken over after ``ttl_s``.

Multi-writer discipline: cell artifacts are write-once-per-content
(atomic ``os.replace`` of identical payloads — any winner is correct);
``manifest.json`` writes additionally serialize through an advisory
``fcntl`` lock on ``<root>/.lock`` so concurrent submitters of the same
campaign never interleave.

``RunStore(None)`` keeps everything in memory — used by A/B benchmarks
and tests that must re-execute every cell on every repeat.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Any, Dict, Iterator, List, Optional

try:  # POSIX only; the claim protocol itself never needs it, the
    import fcntl  # advisory store lock degrades to a no-op without it.
except ImportError:  # pragma: no cover
    fcntl = None  # type: ignore[assignment]

from .. import faults, obs

__all__ = ["RunStore", "canonical_json", "list_campaign_dirs"]

_log = obs.get_logger("runstore")

MANIFEST = "manifest.json"
REPORT = "report.json"
CELL_DIR = "cells"
CLAIM_DIR = "claims"
LOCK_FILE = ".lock"
SUCCESS_LOG = "success.log"


def canonical_json(d: Any) -> str:
    """One canonical text per JSON value: sorted keys, no whitespace.
    Spec hashes and manifests are built over this form, so dict ordering
    never leaks into identities."""
    return json.dumps(d, sort_keys=True, separators=(",", ":"))


def _atomic_write(path: str, text: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=os.path.dirname(path) or ".", prefix=os.path.basename(path) + ".tmp."
    )
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        # mkstemp files are 0600; give artifacts the ordinary open()
        # permissions so a store survives uid changes (CI caches, shared
        # machines).
        umask = os.umask(0)
        os.umask(umask)
        os.chmod(tmp, 0o666 & ~umask)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


class RunStore:
    """Per-campaign artifact store; ``root=None`` is an in-memory store."""

    def __init__(self, root: Optional[str]) -> None:
        self.root = root
        self._mem: Dict[str, str] = {}  # in-memory mode: name -> text
        self._mem_claims: Dict[str, Dict[str, Any]] = {}  # hash -> claim info
        self._mem_success: List[Dict[str, Any]] = []  # in-memory success log

    # ----------------------------------------------------------------- paths
    def cell_path(self, spec_hash: str) -> str:
        return os.path.join(self.root or "", CELL_DIR, f"{spec_hash}.json")

    def claim_path(self, spec_hash: str) -> str:
        return os.path.join(self.root or "", CLAIM_DIR, f"{spec_hash}.claim")

    # ------------------------------------------------------------------ lock
    @contextlib.contextmanager
    def lock(self) -> Iterator[None]:
        """Advisory cross-process exclusive lock on the whole store
        (``flock`` on ``<root>/.lock``).  Guards read-modify-write and
        claim-takeover windows; plain artifact writes don't need it
        (``os.replace`` is atomic on its own).  No-op for in-memory
        stores and on platforms without ``fcntl``."""
        if self.root is None or fcntl is None:
            yield
            return
        os.makedirs(self.root, exist_ok=True)
        fd = os.open(os.path.join(self.root, LOCK_FILE), os.O_CREAT | os.O_RDWR, 0o666)
        try:
            fcntl.flock(fd, fcntl.LOCK_EX)
            yield
        finally:
            try:
                fcntl.flock(fd, fcntl.LOCK_UN)
            finally:
                os.close(fd)

    # ---------------------------------------------------------------- claims
    def _claim_payload(self, owner: str) -> str:
        now = time.time()
        # "hb" is the authoritative heartbeat: TTL staleness is judged on
        # it, never on the file mtime, whose granularity is filesystem-
        # dependent (coarse-mtime mounts made takeover decisions random).
        return canonical_json(
            {"owner": owner, "pid": os.getpid(), "time": now, "hb": now}
        )

    def _claim_age(self, spec_hash: str) -> Optional[float]:
        """Seconds since the claim's last heartbeat, or None if the claim
        is gone.  A torn/old-format payload falls back to the mtime (the
        heartbeat write also bumps it)."""
        info = self.claim_info(spec_hash)
        if info is not None and isinstance(info.get("hb"), (int, float)):
            return time.time() - float(info["hb"])
        try:
            return time.time() - os.stat(self.claim_path(spec_hash)).st_mtime
        except OSError:
            return None

    def claim(self, spec_hash: str, owner: str, *, ttl_s: Optional[float] = None) -> bool:
        """Try to claim ``spec_hash`` for execution.  Exactly one caller
        wins (``O_CREAT|O_EXCL`` — the filesystem arbitrates across
        processes); everyone else gets ``False`` and should either wait
        for the artifact or move on.  A claim whose heartbeat (the ``hb``
        field of the payload, rewritten by :meth:`refresh_claim`) is
        older than ``ttl_s`` seconds (owner presumed dead) is broken and
        re-taken under the store lock.

        Only a *loadable* artifact refuses the claim: a corrupt one
        counts as missing everywhere else (:meth:`try_load_cell`), so it
        must not also block the re-execution that would heal it — that
        combination would park every would-be executor forever."""
        if self.try_load_cell(spec_hash) is not None:
            return False
        if self.root is None:
            if spec_hash in self._mem_claims:
                return False
            now = time.time()
            self._mem_claims[spec_hash] = {"owner": owner, "time": now, "hb": now}
            return True
        path = self.claim_path(spec_hash)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o666)
        except FileExistsError:
            if ttl_s is None:
                return False
            age = self._claim_age(spec_hash)
            if age is None or age <= ttl_s:
                return False
            # Stale claim: break it under the store lock so two takeover
            # attempts can't both win.
            with self.lock():
                stale_age = self._claim_age(spec_hash)
                if stale_age is None or stale_age <= ttl_s:
                    return False  # owner heartbeat arrived meanwhile
                try:
                    os.unlink(path)
                except OSError:
                    pass
                try:
                    fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY, 0o666)
                except FileExistsError:
                    return False
                obs.event(
                    "runstore.claim_stale_break",
                    spec=spec_hash[:12], owner=owner, age_s=round(age, 3),
                )
        with os.fdopen(fd, "w") as f:
            f.write(self._claim_payload(owner))
        return True

    def refresh_claim(self, spec_hash: str, owner: str) -> None:
        """Heartbeat: rewrite the claim payload with a fresh ``hb``
        timestamp.  Opens without ``O_CREAT`` so a released claim is
        never resurrected by a late heartbeat; a reader racing the
        truncate+write sees a torn payload and falls back to the mtime,
        which this write also bumps — either way the claim looks live."""
        if self.root is None:
            info = self._mem_claims.get(spec_hash)
            if info is not None and info.get("owner") == owner:
                info["hb"] = time.time()
            return
        info = self.claim_info(spec_hash)
        if info is not None and info.get("owner") not in (None, owner):
            return  # the claim was taken over; it is not ours to refresh
        try:
            fd = os.open(self.claim_path(spec_hash), os.O_WRONLY)
        except OSError:
            return
        try:
            os.ftruncate(fd, 0)
            os.write(fd, self._claim_payload(owner).encode())
        except OSError:
            pass
        finally:
            os.close(fd)

    def release_claim(self, spec_hash: str, owner: Optional[str] = None) -> None:
        """Drop the claim.  With ``owner`` given, only a claim still held
        by that owner is dropped — a worker whose claim was broken by a
        stale takeover must not yank the new owner's claim out from under
        it on its way out."""
        if faults.fire("store.release_claim", spec=spec_hash[:12]) == "lost":
            return  # injected claim-release loss: the unlink never happens
        if self.root is None:
            info = self._mem_claims.get(spec_hash)
            if owner is None or (info is not None and info.get("owner") == owner):
                self._mem_claims.pop(spec_hash, None)
            return
        if owner is not None:
            info = self.claim_info(spec_hash)
            if info is not None and info.get("owner") not in (None, owner):
                return
        try:
            os.unlink(self.claim_path(spec_hash))
        except OSError:
            pass

    def claim_info(self, spec_hash: str) -> Optional[Dict[str, Any]]:
        """The live claim record for ``spec_hash`` (or None)."""
        if self.root is None:
            info = self._mem_claims.get(spec_hash)
            return dict(info) if info is not None else None
        try:
            with open(self.claim_path(spec_hash)) as f:
                return json.loads(f.read())
        except (OSError, ValueError):
            return None

    def release_claims_of(self, owner: str) -> List[str]:
        """Drop every claim held by ``owner`` (a dead worker's in-flight
        cells, released by the supervisor before retrying them).  Returns
        the released hashes."""
        released: List[str] = []
        if self.root is None:
            for h in [h for h, i in self._mem_claims.items() if i.get("owner") == owner]:
                self._mem_claims.pop(h, None)
                released.append(h)
            return released
        d = os.path.join(self.root, CLAIM_DIR)
        try:
            names = os.listdir(d)
        except OSError:
            return released
        for name in names:
            if not name.endswith(".claim"):
                continue
            h = name[: -len(".claim")]
            info = self.claim_info(h)
            if info is not None and info.get("owner") == owner:
                self.release_claim(h)
                released.append(h)
        return released

    def sweep_stale_claims(self, ttl_s: Optional[float] = None) -> List[str]:
        """Garbage-collect orphan claims: any claim whose artifact is
        already loadable (the work is done — a lost release or a crash
        between publish and unlink left the file behind), plus — when
        ``ttl_s`` is given — any claim whose heartbeat is older than
        ``ttl_s`` (dead owner nobody ever took over from).  Runs under
        the store lock; returns the swept hashes.  Called on scheduler
        shutdown so a cleanly stopped service leaves zero claims."""
        swept: List[str] = []
        if self.root is None:
            for h in list(self._mem_claims):
                if self.try_load_cell(h) is not None:
                    self._mem_claims.pop(h, None)
                    swept.append(h)
            return swept
        d = os.path.join(self.root, CLAIM_DIR)
        try:
            names = os.listdir(d)
        except OSError:
            return swept
        with self.lock():
            for name in names:
                if not name.endswith(".claim"):
                    continue
                h = name[: -len(".claim")]
                if self.try_load_cell(h) is not None:
                    reason = "artifact_exists"
                else:
                    age = self._claim_age(h)
                    if ttl_s is None or age is None or age <= ttl_s:
                        continue
                    reason = "stale_heartbeat"
                try:
                    os.unlink(os.path.join(d, name))
                except OSError:
                    continue
                swept.append(h)
                obs.event("runstore.claim_swept", spec=h[:12], reason=reason)
        return swept

    def _read(self, name: str) -> Optional[str]:
        if self.root is None:
            return self._mem.get(name)
        path = os.path.join(self.root, name)
        try:
            with open(path) as f:
                return f.read()
        except OSError:
            return None

    def _write(self, name: str, text: str) -> str:
        if self.root is None:
            self._mem[name] = text
            return name
        path = os.path.join(self.root, name)
        _atomic_write(path, text)
        return path

    # ----------------------------------------------------------------- cells
    def has_cell(self, spec_hash: str) -> bool:
        return self._read(os.path.join(CELL_DIR, f"{spec_hash}.json")) is not None

    def completed(self) -> List[str]:
        """Spec hashes of every completed cell artifact, sorted."""
        if self.root is None:
            return sorted(
                os.path.basename(n)[: -len(".json")]
                for n in self._mem
                if n.startswith(CELL_DIR + os.sep) and n.endswith(".json")
            )
        d = os.path.join(self.root, CELL_DIR)
        try:
            names = os.listdir(d)
        except OSError:
            return []
        return sorted(n[: -len(".json")] for n in names if n.endswith(".json"))

    def save_cell(self, spec_hash: str, payload: Dict[str, Any]) -> str:
        text = json.dumps(payload, sort_keys=True)
        kind = faults.fire("store.save_cell", spec=spec_hash[:12])
        if kind == "torn":
            # Model power loss mid-write: a truncated artifact lands on
            # the *final* path (bypassing the atomic tempfile dance) and
            # the process dies before any success accounting — resume
            # must treat the torn file as missing and re-execute.
            if self.root is not None:
                path = self.cell_path(spec_hash)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "w") as f:
                    f.write(text[: max(1, len(text) // 3)])
            faults.kill_self()
        elif kind == "lost":
            # Model a lost fsync/power loss just before durability: die
            # with nothing on disk and no success-log line.
            faults.kill_self()
        return self._write(os.path.join(CELL_DIR, f"{spec_hash}.json"), text)

    def publish_cell(
        self, spec_hash: str, payload: Dict[str, Any], owner: str
    ) -> bool:
        """Exactly-once artifact publication for claim-holding executors.
        Under the store lock: if the artifact is already loadable (a
        racing publisher won) or the claim now belongs to someone else (a
        stale takeover inherited the work while this owner hung), the
        decode result is discarded and ``False`` returned.  Otherwise the
        artifact is written and one line appended to the success log —
        the audit trail the chaos convergence checker uses to prove every
        unique cell hash was decoded exactly once."""
        if self.root is None:
            if self.try_load_cell(spec_hash) is not None:
                return False
            info = self._mem_claims.get(spec_hash)
            if info is not None and info.get("owner") not in (None, owner):
                return False
            self.save_cell(spec_hash, payload)
            self._append_success(spec_hash, owner)
            return True
        with self.lock():
            if self.try_load_cell(spec_hash) is not None:
                return False
            info = self.claim_info(spec_hash)
            if info is not None and info.get("owner") not in (None, owner):
                obs.event(
                    "runstore.publish_lost_claim",
                    spec=spec_hash[:12], owner=owner,
                )
                return False
            self.save_cell(spec_hash, payload)
            self._append_success(spec_hash, owner)
            return True

    # ----------------------------------------------------------- success log
    def _append_success(self, spec_hash: str, owner: str) -> None:
        record = canonical_json({"owner": owner, "spec": spec_hash})
        if self.root is None:
            self._mem_success.append(json.loads(record))
            return
        # One O_APPEND write per publish: atomic at jsonl granularity, so
        # the log survives arbitrary crash schedules uncorrupted.
        fd = os.open(
            os.path.join(self.root, SUCCESS_LOG),
            os.O_CREAT | os.O_APPEND | os.O_WRONLY, 0o666,
        )
        try:
            os.write(fd, (record + "\n").encode())
        finally:
            os.close(fd)

    def success_log(self) -> List[Dict[str, Any]]:
        """Parsed success-log records, in append order (torn trailing
        lines are skipped — they cannot occur from our own writes, but
        the reader should never be the thing that fails)."""
        if self.root is None:
            return [dict(r) for r in self._mem_success]
        out: List[Dict[str, Any]] = []
        try:
            with open(os.path.join(self.root, SUCCESS_LOG)) as f:
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

    def load_cell(self, spec_hash: str) -> Dict[str, Any]:
        text = self._read(os.path.join(CELL_DIR, f"{spec_hash}.json"))
        if text is None:
            raise KeyError(f"no cell artifact for {spec_hash}")
        return json.loads(text)

    def try_load_cell(self, spec_hash: str) -> Optional[Dict[str, Any]]:
        """Like :meth:`load_cell` but treats an unreadable or truncated
        artifact as missing: warn and return None, so resume re-executes
        the cell instead of dying on ``json.JSONDecodeError`` (a torn
        artifact can only come from outside interference — our own writes
        go through ``os.replace`` — but the store should still heal)."""
        faults.fire("store.load_cell", spec=spec_hash[:12])
        text = self._read(os.path.join(CELL_DIR, f"{spec_hash}.json"))
        if text is None:
            return None
        try:
            return json.loads(text)
        except ValueError:
            _log.warning(
                "corrupt cell artifact %s — treating as missing "
                "(will re-execute)",
                self.cell_path(spec_hash),
            )
            obs.event("runstore.corrupt_artifact", spec=spec_hash[:12])
            return None

    def delete_cell(self, spec_hash: str) -> None:
        if self.root is None:
            self._mem.pop(os.path.join(CELL_DIR, f"{spec_hash}.json"), None)
        else:
            try:
                os.unlink(self.cell_path(spec_hash))
            except OSError:
                pass

    # ------------------------------------------------------ manifest / report
    def write_manifest(self, manifest: Dict[str, Any]) -> str:
        # Serialized under the store lock: concurrent submitters of one
        # campaign (service mode) write byte-identical manifests, but the
        # lock keeps the temp-file churn and any future read-modify-write
        # of the manifest race-free.
        with self.lock():
            text = canonical_json(manifest) + "\n"
            if faults.fire("store.write_manifest") == "corrupt":
                # Injected torn manifest: half the canonical text plus an
                # undecodable tail.  read_manifest treats it as missing
                # and the next (idempotent) submit rewrites it whole.
                text = text[: len(text) // 2] + "\x00garbage"
            return self._write(MANIFEST, text)

    def read_manifest(self) -> Optional[Dict[str, Any]]:
        """The manifest, or None when absent *or unreadable*: a corrupt
        manifest (torn write from outside interference) must heal on the
        next submit, not wedge every status/resume call on a
        ``JSONDecodeError``."""
        text = self._read(MANIFEST)
        if text is None:
            return None
        try:
            return json.loads(text)
        except ValueError:
            _log.warning(
                "corrupt manifest under %s — treating as missing", self.root
            )
            obs.event("runstore.corrupt_manifest", root=str(self.root))
            return None

    def write_report(self, report: Dict[str, Any]) -> str:
        return self._write(REPORT, json.dumps(report, sort_keys=True, indent=2) + "\n")

    def read_report(self) -> Optional[Dict[str, Any]]:
        text = self._read(REPORT)
        return None if text is None else json.loads(text)


def list_campaign_dirs(root: str) -> List[str]:
    """Campaign store directories (those holding a manifest) under ``root``."""
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return []
    return [
        os.path.join(root, n)
        for n in names
        if os.path.isfile(os.path.join(root, n, MANIFEST))
    ]
