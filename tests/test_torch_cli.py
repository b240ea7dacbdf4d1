"""``python -m repro_torch``: every ported subcommand through ``main([...])``
against the JAX package's CLI where both can run on the CPU (same
campaign ids, stores and fronts, the same problem hash), the ``--device``
rule, the one-line errors of the service and chaos subcommands and of
reference-only spec values, and two concurrent ``campaign resume``
processes converging."""
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from conftest import TINY, tiny_campaign
from repro.cli import main as ref_main
from repro.core import ExplorationProblem as RefProblem
from repro.scenarios import sample_scenarios
from repro_torch.cli import main
from repro_torch.core import Campaign, RunStore

SMOKE = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "specs",
                     "campaign_smoke.json")
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(tmp_path, camp=None):
    camp = camp or tiny_campaign()
    path = tmp_path / "spec.json"
    path.write_text(camp.dumps())
    return str(path), camp


def test_campaign_run_resume_report_list(tmp_path, capsys):
    spec, camp = _spec(tmp_path)
    root = str(tmp_path / "campaigns")
    assert main(["campaign", "run", spec, "--root", root, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"campaign {camp.campaign_id()}: 2 cells executed" in out
    store_dir = os.path.join(root, camp.campaign_id())
    assert os.path.isfile(os.path.join(store_dir, "report.json"))
    assert main(["campaign", "resume", camp.campaign_id(), "--root", root,
                 "--device", "cpu"]) == 0
    assert "0 cells executed, 2 already complete" in capsys.readouterr().out
    assert main(["campaign", "report", camp.campaign_id(), "--root", root,
                 "--verify", "--verify-limit", "2"]) == 0
    out = capsys.readouterr().out
    assert "relHV" in out and out.count(" OK") == 2 and "VIOLATED" not in out
    assert main(["campaign", "list", "--root", root]) == 0
    assert "2/2 cells" in capsys.readouterr().out
    # The reference's CLI on the same spec: same store directory, fronts.
    ref_root = str(tmp_path / "ref")
    assert ref_main(["campaign", "run", spec, "--root", ref_root]) == 0
    capsys.readouterr()
    mine = RunStore(store_dir).read_report()
    theirs = RunStore(os.path.join(ref_root, camp.campaign_id())).read_report()
    assert {t: r["front"] for t, r in mine["cells"].items()} == {
        t: r["front"] for t, r in theirs["cells"].items()}


def test_problem_validate_hash_equals_reference_and_explore(tmp_path, capsys):
    sc = sample_scenarios(seed=0, n=1, families=["split_join"])[0]
    spec = tmp_path / "problem.json"
    spec.write_text(json.dumps(RefProblem.from_scenario(sc).to_json()))
    assert main(["problem", "validate", str(spec)]) == 0
    mine = capsys.readouterr().out
    assert ref_main(["problem", "validate", str(spec)]) == 0
    theirs = capsys.readouterr().out
    assert "round-trip: OK" in mine and mine == theirs
    for explorer, params in (("nsga2", TINY), ("torch_nsga2", TINY),
                             ("random_search", {"samples": 6, "batch": 3, "seed": 1})):
        assert main(["problem", "explore", str(spec), "--explorer", explorer,
                     "--strategy", "MRB_Always", "--params", json.dumps(params),
                     "--out", str(tmp_path / "runs"), "--device", "cpu"]) == 0
        out = capsys.readouterr().out
        assert "front=" in out and "saved ->" in out


def test_sim_info_parity_and_verify(capsys):
    assert main(["sim", "info"]) == 0
    out = capsys.readouterr().out
    assert "'auto', 'events', 'cuda', 'torch'" in out
    assert "events below batch" in out and "batched backends" in out
    assert main(["sim", "parity", "--batch", "4", "--device", "cpu"]) == 0
    assert "periods identical across backends: OK" in capsys.readouterr().out
    assert main(["sim", "verify", "--families", "stencil_chain", "--samples", "2",
                 "--decoders", "caps_hms"]) == 0
    assert "0 violations -> OK" in capsys.readouterr().out


def test_device_defaults_to_the_card(tmp_path, capsys):
    """Without ``--device`` an engine-building subcommand runs on the card;
    without one it fails in one line."""
    spec, _ = _spec(tmp_path)
    rc = main(["campaign", "run", spec, "--root", str(tmp_path / "c")])
    if torch.cuda.is_available():
        assert rc == 0
        return
    assert rc == 2
    err = capsys.readouterr().err
    assert err.startswith("repro_torch: error: ") and "CUDA" in err
    assert len(err.strip().splitlines()) == 1


@pytest.mark.parametrize("argv,code,says", [
    (["campaign", "serve", "--device", "cpu", "--workers", "0", "--service-root",
      "{root}", "--port", "{busy}"], 2, "Address already in use"),
    (["campaign", "submit", "{spec}", "--url", "http://127.0.0.1:1", "--no-wait"],
     3, "cannot reach http://127.0.0.1:1"),
    (["campaign", "status", "t--c", "--url", "http://127.0.0.1:1"], 3, "HTTP 0"),
    (["campaign", "metrics", "--url", "http://127.0.0.1:1"], 3, "HTTP 0"),
    (["chaos", "run", "--spec", "{missing}", "--device", "cpu"], 2, "missing.json"),
])
def test_service_and_chaos_subcommands_fail_in_one_line(argv, code, says, tmp_path, capsys):
    """The served subcommands and ``chaos run`` are ported: a port already
    taken, an unreachable service (transient: exit 3) and a
    missing spec each end in one line, never "not ported"."""
    spec, _ = _spec(tmp_path)
    with socket.socket() as busy:
        busy.bind(("127.0.0.1", 0))
        busy.listen(1)
        argv = [a.format(spec=spec, missing=tmp_path / "missing.json", root=tmp_path / "svc",
                         busy=busy.getsockname()[1]) for a in argv]
        assert main(argv) == code
    err = capsys.readouterr().err
    assert err.startswith("repro_torch: error: ") and says in err
    assert "not ported" not in err and len(err.strip().splitlines()) == 1


def test_reference_only_spec_values_and_help(tmp_path, capsys):
    assert main(["campaign", "run", SMOKE, "--root", str(tmp_path), "--device", "cpu"]) == 2
    err = capsys.readouterr().err
    assert err == ("repro_torch: error: unknown explorer 'jax_nsga2'; registered: "
                   "nsga2, random_search, torch_nsga2\n")
    for argv in (["--help"], ["campaign", "--help"]):
        with pytest.raises(SystemExit):
            main(argv)
        mine = capsys.readouterr().out
        with pytest.raises(SystemExit):
            ref_main(argv)
        theirs = capsys.readouterr().out
        # The same subcommands, in the same order.
        assert mine.splitlines()[0].split(" ", 2)[2] == theirs.splitlines()[0].split(" ", 2)[2]


def test_concurrent_resume_two_processes_converge(tmp_path):
    """Two ``python -m repro_torch campaign resume`` processes racing on one
    store: claims arbitrate, each cell is decoded once (the success log),
    both exit 0, and the manifest stays byte-identical."""
    camp = Campaign.from_json(tiny_campaign().to_json())
    spec, _ = _spec(tmp_path)
    store_dir = str(tmp_path / "store")
    assert main(["campaign", "run", spec, "--root", str(tmp_path / "first"),
                 "--device", "cpu"]) == 0
    first = os.path.join(str(tmp_path / "first"), camp.campaign_id())
    os.rename(first, store_dir)
    manifest = open(os.path.join(store_dir, "manifest.json"), "rb").read()
    store = RunStore(store_dir)
    fronts = {c.tag: store.load_cell(c.spec_hash())["run"]["front"] for c in camp.expand()}
    for c in camp.expand():
        store.delete_cell(c.spec_hash())
    os.remove(os.path.join(store_dir, "success.log"))
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC),
               REPRO_SERVICE_CELL_DELAY_S="0.3", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch", "campaign", "resume", store_dir,
         "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, (out, err)
    assert sorted(r["spec"] for r in store.success_log()) == sorted(
        c.spec_hash() for c in camp.expand())
    for c in camp.expand():
        assert store.load_cell(c.spec_hash())["run"]["front"] == fronts[c.tag]
    assert open(os.path.join(store_dir, "manifest.json"), "rb").read() == manifest
    assert os.listdir(os.path.join(store_dir, "claims")) == []
