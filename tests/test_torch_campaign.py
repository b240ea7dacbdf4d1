"""The port's campaigns against the JAX package's (``tests/test_campaign.py``):
spec JSON, spec hashes, campaign ids, expansion and manifest bytes equal to
the reference's for the same spec; runner fronts, counters and artifacts
equal to the reference runner's on the CPU; kill/resume with a
byte-identical manifest; corrupt artifacts re-executed; the reference-only
spec values refused in one line; ``run_dse`` fronts equal.

Run meta differs by design in ``sim_backend`` (the port's engine defaults
to ``"cuda"``, the reference's to ``None``) and ``device``, which the
reference does not record; with the wall times (``wall_s``) these are the
only fields allowed to differ between the two packages' artifacts.
"""
import copy
import json
import os

import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from conftest import tiny_campaign
from repro.scenarios import sample_scenarios
from repro_torch.core.campaign import CampaignCell

SMOKE = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "specs",
                     "campaign_smoke.json")
CPU = {"device": "cpu"}
DIFFERS_BY_DESIGN = ("sim_backend", "device")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smoke(**edit):
    with open(SMOKE) as f:
        d = json.load(f)
    d.update(edit)
    return d


def _sobel_matrix():
    """Sobel with its graphs embedded and a generated scenario, swept over
    strategy × decoder × sim_backend × seed."""
    g, arch = ref.sobel(), ref.paper_architecture()
    sc = sample_scenarios(seed=1, n=1, families=["multicast_tree"])[0]
    objs = ["sim_period", "memory", "core_cost"]
    return ref.Campaign(
        name="sobel matrix",
        problems=[
            {"label": "Sobel", "graph": g.to_dict(), "arch": arch.to_dict(),
             "objectives": objs, "ilp_budget_s": 0.5},
            {"label": "mtree", "scenario": sc.to_json(), "objectives": objs},
        ],
        axes={"strategy": ["Reference", "MRB_Always", "MRB_Explore"],
              "decoder": ["caps_hms", "ilp"], "sim_backend": ["events", "auto"],
              "seed": [0, 1]},
        overrides=[
            {"match": {"decoder": "ilp", "problem": "mtree"}, "skip": True},
            {"match": {"strategy": "MRB_Always"},
             "set": {"explorer_params": {"generations": 1},
                     "engine": {"n_workers": 0}}},
        ],
        explorer_params={"population": 6, "offspring": 3, "generations": 2},
        engine={"cache_mode": "canonical", "n_workers": 0},
    ).to_json()


SPECS = {
    "tiny": lambda: tiny_campaign().to_json(),
    "smoke": _smoke,
    "sobel_matrix": _sobel_matrix,
}


def _pair(spec):
    return ref.Campaign.from_json(copy.deepcopy(spec)), port.Campaign.from_json(
        copy.deepcopy(spec))


# ------------------------------------------------------------ spec identity
@pytest.mark.parametrize("name", sorted(SPECS))
def test_identity_and_manifest_bytes_equal_reference(name):
    theirs, mine = _pair(SPECS[name]())
    assert mine.to_json() == theirs.to_json()
    assert mine.dumps() == theirs.dumps()
    assert mine.spec_hash() == theirs.spec_hash()
    assert mine.campaign_id() == theirs.campaign_id()
    a, b = mine.expand(), theirs.expand()
    assert len(a) == len(b) > 0
    for c, d in zip(a, b):
        assert c.to_json() == d.to_json()
        assert (c.spec_hash(), c.tag, c.group_key(), c.engine_key()) == (
            d.spec_hash(), d.tag, d.group_key(), d.engine_key())
    assert port.canonical_json(mine.manifest()) == ref.canonical_json(theirs.manifest())


def test_spec_hash_pinned_and_device_is_perf_only():
    cell = CampaignCell(problem={"strategy": "Reference", "decoder": "caps_hms"},
                        explorer="nsga2", explorer_params={"seed": 0}, engine={},
                        coords={"problem": "x"})
    assert cell.spec_hash() == (
        "4baa4d0d2b0188853317e886452266c967369fb88d6551a791ee2836e7a9df13")
    plain = port.Campaign.from_json(tiny_campaign().to_json())
    on_cpu = port.Campaign.from_json(tiny_campaign(engine={"device": "cpu",
                                                           "n_workers": 2}).to_json())
    assert on_cpu.campaign_id() == plain.campaign_id()
    assert [c.spec_hash() for c in on_cpu.expand()] == [c.spec_hash() for c in plain.expand()]
    with pytest.raises(ValueError, match="perf-only"):
        port.CampaignRunner(plain, store=port.RunStore(None),
                            engine_overrides={"cache_mode": "none"})


@pytest.mark.parametrize("case,match", [
    ({"overrides": [{"match": {"decoders": "ilp"}, "skip": True}]}, "unknown coordinates"),
    ({"overrides": [{"match": {"strategy": "Reference"},
                     "set": {"params": {"generations": 1}}}]}, "unknown sections"),
    ({"axes": {"strategy": []}}, "no values"),
    ({"axes": {"strategies": ["Reference"]}}, "unknown campaign axes"),
])
def test_malformed_specs_rejected(case, match):
    with pytest.raises(ValueError, match=match):
        port.Campaign.from_json(tiny_campaign(**case).to_json())


def test_expansion_rules_and_runner_rejections():
    camp = port.Campaign.from_json(tiny_campaign(
        axes={"strategy": ["Reference", "MRB_Explore"], "decoder": ["caps_hms", "ilp"]},
        overrides=[
            {"match": {"decoder": "ilp"},
             "set": {"problem": {"ilp_budget_s": 0.25},
                     "explorer_params": {"generations": 1}}},
            {"match": {"strategy": "Reference", "decoder": "ilp"}, "skip": True},
        ],
    ).to_json())
    by_coords = {(c.coords["strategy"], c.coords["decoder"]): c for c in camp.expand()}
    assert len(by_coords) == 3 and ("Reference", "ilp") not in by_coords
    assert by_coords[("MRB_Explore", "ilp")].problem["ilp_budget_s"] == 0.25
    dup = port.Campaign.from_json(tiny_campaign().to_json())
    dup.problems = dup.problems * 2
    with pytest.raises(ValueError, match="duplicate"):
        port.CampaignRunner(dup, store=port.RunStore(None))
    scs = sample_scenarios(seed=0, n=2, families=["stencil_chain"])
    same = port.Campaign.from_json(tiny_campaign(
        problems=[{"label": "same", "scenario": sc.to_json()} for sc in scs]).to_json())
    with pytest.raises(ValueError, match="identical tags"):
        port.CampaignRunner(same, store=port.RunStore(None))


@pytest.mark.parametrize("edit,msg", [
    ({}, "unknown explorer 'jax_nsga2'; registered: nsga2, random_search, torch_nsga2"),
    ({"engine": {"sim_backend": "vectorized"}}, "unknown sim_backend 'vectorized'"),
    ({"axes": {"sim_backend": ["events", "pallas"]}}, "unknown sim_backend 'pallas'"),
])
def test_reference_only_values_fail_fast(edit, msg):
    camp = port.Campaign.from_json(_smoke(**edit))
    with pytest.raises(ValueError) as e:
        port.CampaignRunner(camp, store=port.RunStore(None))
    assert msg in str(e.value) and "\n" not in str(e.value)


# --------------------------------------------------------- runner semantics
def _strip(run):
    run = dict(run)
    run.pop("wall_s")
    run["meta"] = {k: v for k, v in run["meta"].items() if k not in DIFFERS_BY_DESIGN}
    return run


def _same_results(mine_store, theirs_store, cells):
    for cell in cells:
        h = cell.spec_hash()
        a, b = mine_store.load_cell(h), theirs_store.load_cell(h)
        assert a["spec_hash"] == b["spec_hash"] == h
        assert (a["tag"], a["cell"]) == (b["tag"], b["cell"])
        assert _strip(a["run"]) == _strip(b["run"]), cell.tag


@pytest.mark.parametrize("name", ["tiny", "smoke_nsga2"])
def test_runner_equals_reference_runner(name, tmp_path):
    spec = tiny_campaign().to_json() if name == "tiny" else _smoke(
        axes={"strategy": ["Reference", "MRB_Explore"], "explorer": ["nsga2"]})
    theirs, mine = _pair(spec)
    r = ref.CampaignRunner(theirs, root=str(tmp_path / "ref")).run()
    m = port.CampaignRunner(mine, root=str(tmp_path / "port"), engine_overrides=CPU).run()
    assert m.store.root.endswith(r.store.root[len(str(tmp_path / "ref")):])
    assert sorted(m.executed) == sorted(r.executed) and not m.skipped
    _same_results(m.store, r.store, mine.expand())
    for tag, row in m.cells.items():
        other = r.cells[tag]
        assert row["front"] == other["front"]
        assert (row["evaluations"], row["cache_hits"], row["cache_misses"]) == (
            other["evaluations"], other["cache_hits"], other["cache_misses"])
        assert row["meta"]["sim_backend"] == "cuda" and row["meta"]["device"] == "cpu"
    assert m.report["groups"] == r.report["groups"]
    manifests = [open(os.path.join(s.store.root, "manifest.json"), "rb").read()
                 for s in (m, r)]
    assert manifests[0] == manifests[1]


def test_torch_nsga2_copy_runs_exact_equal_to_nsga2():
    """The smoke spec with ``torch_nsga2`` in place of ``jax_nsga2``: its
    exact mode is the host loop with device ranking, so its cell's front
    equals the ``nsga2`` cell's of the same strategy."""
    spec = json.loads(json.dumps(_smoke()).replace("jax_nsga2", "torch_nsga2"))
    res = port.CampaignRunner(port.Campaign.from_json(spec), store=port.RunStore(None),
                              engine_overrides=CPU).run()
    assert res.report["n_completed"] == 3
    tags = sorted(res.cells)
    assert "stencil0/Reference^caps_hms/torch_nsga2" in tags
    assert res.front("stencil0/Reference^caps_hms/torch_nsga2") == \
        res.front("stencil0/Reference^caps_hms/nsga2")
    assert res.cells["stencil0/Reference^caps_hms/torch_nsga2"]["meta"]["evaluation"] == "exact"


def test_kill_resume_corrupt_artifact_and_manifest_identity(tmp_path, caplog):
    camp = port.Campaign.from_json(tiny_campaign().to_json())
    store_dir = str(tmp_path / "store")
    res1 = port.CampaignRunner(camp, store=port.RunStore(store_dir),
                               engine_overrides=CPU).run()
    assert len(res1.executed) == 2 and not res1.skipped
    manifest = open(os.path.join(store_dir, "manifest.json"), "rb").read()
    ref_store = str(tmp_path / "ref")
    ref.CampaignRunner(ref.Campaign.from_json(tiny_campaign().to_json()),
                       store=ref.RunStore(ref_store)).run()
    assert open(os.path.join(ref_store, "manifest.json"), "rb").read() == manifest

    victim, other = camp.expand()[1], camp.expand()[0]
    port.RunStore(store_dir).delete_cell(victim.spec_hash())
    res2 = port.CampaignRunner(camp, store=port.RunStore(store_dir),
                               engine_overrides=CPU).run()
    assert res2.executed == [victim.spec_hash()]
    assert res2.skipped == [other.spec_hash()]
    assert open(os.path.join(store_dir, "manifest.json"), "rb").read() == manifest

    path = port.RunStore(store_dir).cell_path(other.spec_hash())
    text = open(path).read()
    with open(path, "w") as f:
        f.write(text[: len(text) // 2])
    with caplog.at_level("WARNING", logger="repro.runstore"):
        res3 = port.CampaignRunner(camp, store=port.RunStore(store_dir),
                                   engine_overrides=CPU).run()
    assert "corrupt cell artifact" in caplog.text
    assert res3.executed == [other.spec_hash()]
    for cell in camp.expand():
        assert res3.front(cell.tag) == res2.front(cell.tag) == res1.front(cell.tag)
    assert open(os.path.join(store_dir, "manifest.json"), "rb").read() == manifest


def test_engine_sharing_objective_groups_and_auto_meta():
    """Shared and isolated engines give equal fronts; 3- and 4-objective
    cells split into two report groups; an ``auto`` cell records its
    per-ξ-group choices; fronts equal the reference's inline events."""
    spec = tiny_campaign(
        explorer_params={"population": 6, "offspring": 3, "generations": 1, "seed": 3},
        axes={"strategy": ["Reference", "MRB_Explore"], "sim_backend": ["auto"]},
        overrides=[{"match": {"strategy": "MRB_Explore"},
                    "set": {"problem": {"objectives": [
                        "sim_period", "memory", "core_cost", "comm_volume"]}}}],
    ).to_json()
    spec["problems"][0]["objectives"] = ["sim_period", "memory", "core_cost"]
    shared = port.CampaignRunner(port.Campaign.from_json(spec), store=port.RunStore(None),
                                 engine_overrides=CPU).run()
    spec["share_engines"] = False
    isolated = port.CampaignRunner(port.Campaign.from_json(spec), store=port.RunStore(None),
                                   engine_overrides=CPU).run()
    for tag in shared.cells:
        assert shared.front(tag) == isolated.front(tag)
        choices = shared.cells[tag]["meta"]["sim_backend_choices"]
        assert set(choices) <= {"events", "torch"} and sum(choices.values()) >= 1
    assert len(shared.report["groups"]) == 2
    del spec["axes"]["sim_backend"]
    theirs = ref.CampaignRunner(ref.Campaign.from_json(spec), store=ref.RunStore(None)).run()
    for tag in shared.cells:
        assert shared.front(tag) == theirs.front(tag.replace("/auto", ""))


def test_report_verify_equals_reference(tmp_path):
    spec = tiny_campaign().to_json()
    theirs, mine = _pair(spec)
    m = port.CampaignRunner(mine, root=str(tmp_path / "p"), engine_overrides=CPU).run()
    r = ref.CampaignRunner(theirs, root=str(tmp_path / "r")).run()
    a = port.build_report(mine.expand(), m.store, verify=True, verify_limit=4)
    b = ref.build_report(theirs.expand(), r.store, verify=True, verify_limit=4)
    for tag in a["cells"]:
        assert a["cells"][tag]["verify"] == b["cells"][tag]["verify"]
        assert a["cells"][tag]["verify"]["ok"] and a["cells"][tag]["verify"]["checked"] > 0


# -------------------------------------------------------------------- run_dse
@pytest.mark.parametrize("strategy", ["Reference", "MRB_Always", "MRB_Explore"])
def test_run_dse_equals_reference(strategy):
    kw = dict(strategy=strategy, population=10, offspring=5, generations=3, seed=4)
    theirs = ref.run_dse(ref.sobel(), ref.paper_architecture(), ref.DSEConfig(**kw))
    seen = []
    mine = port.run_dse(port.sobel(), port.paper_architecture(), port.DSEConfig(**kw),
                        device="cpu", on_generation=lambda g, r: seen.append(g))
    assert seen == [0, 1, 2]
    assert mine.front == theirs.front
    assert mine.history == theirs.history
    assert (mine.evaluations, mine.cache_hits, mine.cache_misses) == (
        theirs.evaluations, theirs.cache_hits, theirs.cache_misses)
    def rows(res):
        return [((i.genotype.xi, i.genotype.cd, i.genotype.ba), i.objectives)
                for i in res.archive]

    assert rows(mine) == rows(theirs)
