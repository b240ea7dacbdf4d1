"""The port's RunStore against the JAX package's (``tests/test_runstore.py``):
atomic same-hash writer races, the advisory store lock, the claim protocol
(exclusivity, heartbeat, stale takeover, owner release), exactly-once
publication, corruption-tolerant loads, and artifacts, manifests and
success logs byte-identical to the reference store's for the same calls.
Child processes touch no CUDA, so they are forked."""
import json
import multiprocessing
import os
import time

import pytest

from repro.core.runstore import RunStore as RefStore
from repro_torch.core.runstore import RunStore, canonical_json, list_campaign_dirs


HASH = "a" * 64


# ------------------------------------------------------------ writer races
def _hammer_writes(root, payload_id, n, start_evt):
    store = RunStore(root)
    start_evt.wait()
    for i in range(n):
        store.save_cell(HASH, {"writer": payload_id, "i": i, "pad": "x" * 2048})


@pytest.mark.parametrize("n_writers", [2])
def test_same_hash_concurrent_writers_never_tear(tmp_path, n_writers):
    """Two processes replaying the same cell hash race safely through
    ``os.replace``: at every instant the artifact is complete, valid JSON
    from exactly one writer — no torn or interleaved bytes."""
    root = str(tmp_path / "store")
    ctx = multiprocessing.get_context("fork")
    start = ctx.Event()
    n = 60
    procs = [
        ctx.Process(target=_hammer_writes, args=(root, w, n, start))
        for w in range(n_writers)
    ]
    for p in procs:
        p.start()
    store = RunStore(root)
    start.set()
    observed = 0
    deadline = time.monotonic() + 60
    while any(p.is_alive() for p in procs) and time.monotonic() < deadline:
        art = store.try_load_cell(HASH)
        if art is not None:
            assert art["writer"] in range(n_writers)
            assert len(art["pad"]) == 2048
            observed += 1
    for p in procs:
        p.join(timeout=30)
        assert p.exitcode == 0
    # One winner, fully intact.
    final = store.load_cell(HASH)
    assert final["writer"] in range(n_writers) and final["i"] == n - 1
    assert observed > 0  # the reader really raced the writers
    # No temp-file litter from the atomic writes.
    leftovers = [
        f for f in os.listdir(os.path.join(root, "cells")) if ".tmp." in f
    ]
    assert leftovers == []


# ----------------------------------------------------------------- claims
def _try_claim(root, owner, start_evt, out_q):
    store = RunStore(root)
    start_evt.wait()
    out_q.put((owner, store.claim(HASH, owner)))


def test_claim_exclusive_across_processes(tmp_path):
    """O_CREAT|O_EXCL arbitration: of N processes claiming one hash at
    the same instant, exactly one wins."""
    root = str(tmp_path / "store")
    ctx = multiprocessing.get_context("fork")
    start, out_q = ctx.Event(), ctx.Queue()
    procs = [
        ctx.Process(target=_try_claim, args=(root, f"w{i}", start, out_q))
        for i in range(4)
    ]
    for p in procs:
        p.start()
    start.set()
    results = [out_q.get(timeout=30) for _ in procs]
    for p in procs:
        p.join(timeout=30)
    winners = [owner for owner, won in results if won]
    assert len(winners) == 1
    info = RunStore(root).claim_info(HASH)
    assert info["owner"] == winners[0]


def _backdate_claim(store, spec_hash, age_s):
    """Rewrite the claim payload with an ``hb`` that is ``age_s`` old
    (and matching mtime, for the torn-payload fallback path)."""
    path = store.claim_path(spec_hash)
    with open(path) as f:
        info = json.loads(f.read())
    info["hb"] = time.time() - age_s
    with open(path, "w") as f:
        f.write(json.dumps(info))
    os.utime(path, (info["hb"], info["hb"]))


def test_claim_lifecycle_and_stale_takeover(tmp_path):
    store = RunStore(str(tmp_path / "store"))
    assert store.claim(HASH, "alice")
    assert not store.claim(HASH, "bob")          # held
    assert not store.claim(HASH, "bob", ttl_s=60)  # held and fresh
    # Age the heartbeat past the TTL: bob takes over.
    _backdate_claim(store, HASH, 120)
    assert store.claim(HASH, "bob", ttl_s=60)
    assert store.claim_info(HASH)["owner"] == "bob"
    # A heartbeat refresh prevents takeover.
    _backdate_claim(store, HASH, 50)
    store.refresh_claim(HASH, "bob")
    assert not store.claim(HASH, "carol", ttl_s=60)
    store.release_claim(HASH)
    assert store.claim_info(HASH) is None
    assert store.claim(HASH, "carol")


def test_claim_staleness_judged_on_heartbeat_not_mtime(tmp_path):
    """The ``hb`` payload field is the authoritative liveness signal.  An
    ancient mtime with a fresh heartbeat must NOT allow takeover (coarse-
    mtime filesystems would otherwise break live claims at random), and a
    fresh mtime with an ancient heartbeat MUST allow it."""
    store = RunStore(str(tmp_path / "store"))
    assert store.claim(HASH, "alice")
    # Fresh hb, ancient mtime: still live.
    old = time.time() - 600
    os.utime(store.claim_path(HASH), (old, old))
    assert not store.claim(HASH, "bob", ttl_s=60)
    # Ancient hb, fresh mtime: stale despite the young-looking file.
    _backdate_claim(store, HASH, 600)
    now = time.time()
    os.utime(store.claim_path(HASH), (now, now))
    assert store.claim(HASH, "bob", ttl_s=60)
    assert store.claim_info(HASH)["owner"] == "bob"


def test_refresh_claim_never_resurrects_or_steals(tmp_path):
    store = RunStore(str(tmp_path / "store"))
    # A heartbeat for a released claim must not recreate the file.
    assert store.claim(HASH, "alice")
    store.release_claim(HASH)
    store.refresh_claim(HASH, "alice")
    assert store.claim_info(HASH) is None
    # A heartbeat from the pre-takeover owner must not clobber the new
    # owner's claim.
    assert store.claim(HASH, "bob")
    store.refresh_claim(HASH, "alice")
    assert store.claim_info(HASH)["owner"] == "bob"


def test_release_claim_with_owner_spares_takeover_winner(tmp_path):
    store = RunStore(str(tmp_path / "store"))
    assert store.claim(HASH, "bob")
    store.release_claim(HASH, owner="alice")  # alice lost the claim: no-op
    assert store.claim_info(HASH)["owner"] == "bob"
    store.release_claim(HASH, owner="bob")
    assert store.claim_info(HASH) is None


def test_claim_refused_once_artifact_exists(tmp_path):
    store = RunStore(str(tmp_path / "store"))
    store.save_cell(HASH, {"done": True})
    assert not store.claim(HASH, "anyone")


def test_corrupt_artifact_does_not_block_claim(tmp_path, caplog):
    """A corrupt artifact counts as missing for loads, so it must count
    as missing for claims too — otherwise the re-executing worker parks
    on it forever (claim refused by the file it needs to replace)."""
    store = RunStore(str(tmp_path / "store"))
    store.save_cell(HASH, {"run": {}})
    with open(store.cell_path(HASH), "w") as f:
        f.write("{torn")
    with caplog.at_level("WARNING", logger="repro.runstore"):
        assert store.claim(HASH, "healer")
    assert "corrupt cell artifact" in caplog.text
    store.save_cell(HASH, {"run": {"front": []}})  # healed
    store.release_claim(HASH)
    assert not store.claim(HASH, "anyone")  # valid artifact refuses again


def test_release_claims_of_owner(tmp_path):
    store = RunStore(str(tmp_path / "store"))
    h2 = "b" * 64
    assert store.claim(HASH, "dead-worker")
    assert store.claim(h2, "live-worker")
    released = store.release_claims_of("dead-worker")
    assert released == [HASH]
    assert store.claim_info(HASH) is None
    assert store.claim_info(h2)["owner"] == "live-worker"


def test_claims_in_memory_store():
    store = RunStore(None)
    assert store.claim(HASH, "a")
    assert not store.claim(HASH, "b")
    store.release_claim(HASH)
    assert store.claim(HASH, "b")
    store.save_cell(HASH, {"x": 1})
    store.release_claim(HASH)
    assert not store.claim(HASH, "c")  # artifact exists


# --------------------------------------------- exactly-once publication
def test_publish_cell_exactly_once_and_success_log(tmp_path):
    store = RunStore(str(tmp_path / "store"))
    assert store.claim(HASH, "alice")
    assert store.publish_cell(HASH, {"run": {"front": []}}, "alice")
    # A racing publisher (claim lost, artifact already there) discards.
    assert not store.publish_cell(HASH, {"run": {"other": 1}}, "bob")
    assert store.load_cell(HASH) == {"run": {"front": []}}
    log = store.success_log()
    assert [(r["spec"], r["owner"]) for r in log] == [(HASH, "alice")]


def test_publish_cell_loses_to_takeover_owner(tmp_path):
    """A hung worker whose claim was broken by a stale takeover must not
    publish over the inheritor: its decode result is discarded."""
    store = RunStore(str(tmp_path / "store"))
    assert store.claim(HASH, "slow-worker")
    _backdate_claim(store, HASH, 600)
    assert store.claim(HASH, "inheritor", ttl_s=60)
    assert not store.publish_cell(HASH, {"run": {}}, "slow-worker")
    assert store.try_load_cell(HASH) is None
    assert store.publish_cell(HASH, {"run": {}}, "inheritor")
    assert len(store.success_log()) == 1


def test_publish_cell_in_memory(tmp_path):
    store = RunStore(None)
    assert store.publish_cell(HASH, {"x": 1}, "a")
    assert not store.publish_cell(HASH, {"x": 2}, "b")
    assert store.success_log() == [{"owner": "a", "spec": HASH}]


def test_sweep_stale_claims(tmp_path):
    store = RunStore(str(tmp_path / "store"))
    done, stale, live = HASH, "b" * 64, "c" * 64
    # A finished cell whose release was lost (claim + artifact coexist).
    assert store.claim(done, "gone")
    store.save_cell(done, {"run": {}})
    # A dead owner nobody took over from.
    assert store.claim(stale, "dead")
    _backdate_claim(store, stale, 600)
    # A live claim that must survive the sweep.
    assert store.claim(live, "alive")
    swept = store.sweep_stale_claims()  # no ttl: artifact-backed only
    assert swept == [done]
    swept = store.sweep_stale_claims(ttl_s=60)
    assert swept == [stale]
    assert store.claim_info(live)["owner"] == "alive"


def test_success_log_skips_torn_trailing_line(tmp_path):
    store = RunStore(str(tmp_path / "store"))
    store.publish_cell(HASH, {"run": {}}, "a")
    with open(os.path.join(str(tmp_path / "store"), "success.log"), "a") as f:
        f.write('{"owner": "b", "spe')  # torn mid-record
    assert [r["spec"] for r in store.success_log()] == [HASH]


# ------------------------------------------------------------------- locks
def _hold_lock(root, acquired, release):
    store = RunStore(root)
    with store.lock():
        acquired.set()
        release.wait()


def test_store_lock_is_exclusive_across_processes(tmp_path):
    root = str(tmp_path / "store")
    ctx = multiprocessing.get_context("fork")
    acquired, release = ctx.Event(), ctx.Event()
    p = ctx.Process(target=_hold_lock, args=(root, acquired, release))
    p.start()
    assert acquired.wait(timeout=30)
    import fcntl

    fd = os.open(os.path.join(root, ".lock"), os.O_RDWR)
    with pytest.raises(BlockingIOError):
        fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
    release.set()
    p.join(timeout=30)
    fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)  # free after release
    fcntl.flock(fd, fcntl.LOCK_UN)
    os.close(fd)


# ------------------------------------------------------ corrupt artifacts
def test_try_load_cell_corrupt_warns_and_returns_none(tmp_path, caplog):
    store = RunStore(str(tmp_path / "store"))
    store.save_cell(HASH, {"run": {"front": [[1, 2, 3]]}})
    # Truncate the artifact mid-payload (simulated torn write / bad disk).
    path = store.cell_path(HASH)
    with open(path) as f:
        text = f.read()
    with open(path, "w") as f:
        f.write(text[: len(text) // 2])
    with caplog.at_level("WARNING", logger="repro.runstore"):
        assert store.try_load_cell(HASH) is None
    assert "corrupt cell artifact" in caplog.text
    with pytest.raises(json.JSONDecodeError):
        store.load_cell(HASH)  # the strict loader still raises
    caplog.clear()
    assert store.try_load_cell("f" * 64) is None  # plain missing: no warning
    assert "corrupt cell artifact" not in caplog.text


# ------------------------------------------------- bytes as the reference's
def _same_calls(store):
    store.write_manifest({"campaign_id": "c-1", "cells": [{"tag": "t", "spec_hash": HASH}],
                          "nested": {"b": [1.5, None], "a": "é"}})
    store.save_cell(HASH, {"spec_hash": HASH, "run": {"front": [[1.0, 2.0, 3.0]],
                                                      "meta": {"x": float("inf")}}})
    assert store.claim("b" * 64, "alice")
    assert store.publish_cell("b" * 64, {"run": {"front": []}}, "alice")
    store.release_claim("b" * 64, owner="alice")
    store.write_report({"cells": {}, "n_cells": 2})


def test_store_files_byte_identical_to_reference(tmp_path):
    mine, theirs = tmp_path / "mine", tmp_path / "theirs"
    _same_calls(RunStore(str(mine)))
    _same_calls(RefStore(str(theirs)))
    names = sorted(
        os.path.relpath(os.path.join(d, f), mine)
        for d, _, fs in os.walk(mine) for f in fs
    )
    assert names == sorted(
        os.path.relpath(os.path.join(d, f), theirs)
        for d, _, fs in os.walk(theirs) for f in fs
    )
    assert ".lock" in names and "success.log" in names
    for name in names:
        assert (mine / name).read_bytes() == (theirs / name).read_bytes(), name
    # Each store reads the other's files.
    assert RunStore(str(theirs)).completed() == RefStore(str(mine)).completed()
    assert RunStore(str(theirs)).read_manifest() == RefStore(str(mine)).read_manifest()
    assert list_campaign_dirs(str(tmp_path)) == [str(mine), str(theirs)]


@pytest.mark.parametrize("value", [
    {"b": 1, "a": [1, 2.5, None, True]}, [{"z": {}, "y": "ü"}], "x", 3, 1e-300,
])
def test_canonical_json_equals_reference(value):
    from repro.core.runstore import canonical_json as ref_canonical_json

    assert canonical_json(value) == ref_canonical_json(value)
