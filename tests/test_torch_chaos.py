"""The port's chaos harness (``repro_torch.faults.chaos``) against the JAX
package's: seeded plans serialised byte for byte as the reference's, the
port's default spec, and one plan of ``python -m repro_torch chaos run``
on the CPU (a served reference run, a faulty phase, a heal phase, the
convergence check) that converges with every site class fired."""
import json
import os

import pytest
import torch

from repro.faults.chaos import SITE_CLASSES as REF_SITE_CLASSES
from repro.faults.chaos import generate_plans as ref_generate_plans
from repro_torch.cli import main as cli_main
from repro_torch.core import Campaign
from repro_torch.faults import DEFAULT_SPEC, SITE_CLASSES, generate_plans

SMOKE = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "specs",
                     "campaign_smoke.json")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,seed", [(1, 0), (5, 3), (20, 0), (7, 11), (3, 12345)])
def test_generate_plans_serialise_as_reference(n, seed, tmp_path):
    mine, theirs = generate_plans(n, seed), ref_generate_plans(n, seed)
    assert [p.to_json() for p in mine] == [p.to_json() for p in theirs]
    assert json.dumps([p.to_json() for p in mine], sort_keys=True) == json.dumps(
        [p.to_json() for p in theirs], sort_keys=True)
    a, b = mine[0].save(str(tmp_path / "a.json")), theirs[0].save(str(tmp_path / "b.json"))
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()
    assert SITE_CLASSES == REF_SITE_CLASSES


def test_default_spec_is_the_smoke_spec_with_torch_nsga2():
    with open(DEFAULT_SPEC) as f:
        mine = f.read()
    with open(SMOKE) as f:
        theirs = f.read()
    assert mine == theirs.replace("jax_nsga2", "torch_nsga2")
    cells = Campaign.from_json(json.loads(mine)).expand()
    assert sorted(c.explorer for c in cells) == ["nsga2", "nsga2", "torch_nsga2"]


def test_chaos_run_one_plan_converges_on_the_cpu(tmp_path, capsys):
    out = str(tmp_path / "chaos")
    rc = cli_main(["chaos", "run", "--plans", "1", "--seed", "0", "--device", "cpu",
                   "--out", out])
    text = capsys.readouterr().out
    with open(os.path.join(out, "chaos_report.json")) as f:
        report = json.load(f)
    assert rc == 0 and report["ok"], text
    assert report["device"] == "cpu" and report["spec"] == DEFAULT_SPEC
    assert report["site_class_coverage"] == {"store": True, "sched": True, "http": True}
    (row,) = report["results"]
    assert row["violations"] == [] and row["n_fired"] > 0
    assert row["rules"] == [r.to_json() for r in generate_plans(1, 0)[0].rules]
    assert row["faulty_s"] > 0 and row["heal_s"] > 0
    assert set(row["worker_restarts"]) == {"faulty", "heal"}
    assert "plan000" in text and "CONVERGED" in text
    # a second sweep refuses to wipe a directory that is not chaos output
    foreign = tmp_path / "foreign"
    foreign.mkdir()
    (foreign / "keep.txt").write_text("x")
    assert cli_main(["chaos", "run", "--plans", "1", "--device", "cpu",
                     "--out", str(foreign)]) == 2
    assert "refusing to wipe" in capsys.readouterr().err
    assert (foreign / "keep.txt").exists()
