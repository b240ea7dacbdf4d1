"""BENCHMARK.json against the contract's rules, the harness found by name,
the result line, and what a run refuses."""
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench.cells import ROOT, load_cell, load_reader
from portbench.yardstick import sim_step_bytes

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_names_and_units_use_the_allowed_characters():
    b = bench()
    names = [c["name"] for c in b["configs"]] + [w["name"] for w in b["workloads"]]
    names += [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["config"] for w in b["workloads"]] + [w["traffic"] for w in b["workloads"]]
    names += [k for c in b["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in b["end_to_end"] + b["per_layer"])
    assert len(set(m["name"] for m in b["end_to_end"] + b["per_layer"])) == len(
        b["end_to_end"]) + len(b["per_layer"])


def test_benchmark_keys_and_bounds():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    e2e = {m["name"] for m in b["end_to_end"]}
    layers = {}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["better"] in ("lower", "higher")
        layers.setdefault(m["layer"], m["layer"])
    cells = {w["name"] for w in b["workloads"]}
    for w in b["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    assert {w["config"] for w in b["workloads"]} == {c["name"] for c in b["configs"]}
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_finds_its_files_by_name():
    for w in bench()["workloads"]:
        cell = load_cell(w["name"])
        assert cell.config["name"] == w["config"] and cell.config["reduced"] == []
        assert cell.mix["params"]["population"] > 0
        for m in cell.end_to_end + cell.per_layer:
            assert callable(load_reader(m["name"]))


def test_a_mix_is_added_with_new_files_only(tmp_path):
    """A new traffic mix and its cell: a new file and a new entry, no edit."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = bench()
    with open(tmp_path / "portbench" / "mixes" / "always-k64.json", "w") as f:
        mix = json.load(open(os.path.join(ROOT, "portbench", "mixes", "always-k128.json")))
        mix["params"]["sim_iters"] = 64
        json.dump(mix, f)
    b["workloads"].append(dict(b["workloads"][0], name="dummy", traffic="always-k64"))
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(b, f)
    cell = load_cell("dummy", root=str(tmp_path))
    assert cell.mix["params"]["sim_iters"] == 64


def test_sim_step_bytes_by_hand():
    # B=2 rows, A=3 actors, C=2 channels of R=2 readers, T=7 tasks, K=4:
    # graph words 4 + 7 + 3·(1 + 1) + 2·2 = 21; row words 2·(14 + 3 + 2) = 38;
    # fire 2·3·4 int32 = 96 B; dead 2 B; end time 8 B.
    assert sim_step_bytes(2, 3, 2, 2, 7, 4) == 4 * (21 + 38) + 96 + 2 + 8


def _run(args, env_extra=None, cwd=ROOT):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_a_run_without_a_card_fails():
    p = _run(["portbench/run.py", "--workload", bench()["workloads"][0]["name"], "--seed", "5",
              "--seconds", "1", "--trace", "0"])
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_without_the_program_fails(tmp_path):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = _run(["portbench/run.py", "--workload", bench()["workloads"][0]["name"], "--seed", "5",
              "--seconds", "1", "--trace", "0"], cwd=str(tmp_path))
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_forbidden_modules_are_named_by_top_level_name(monkeypatch):
    from portbench import run as entry

    for name in ("repro_torch", "repro_torch.evo", "reproduce", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    base = set(entry.forbidden_modules())
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert set(entry.forbidden_modules()) - base == {"repro", "jaxlib"}


CPU_RUN = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
import torch
torch.set_num_threads(2)
from portbench.cells import load_cell
from portbench.bench import run
cell = load_cell({cell!r}, bench={bench!r})
cell.mix["params"].update(population=8, offspring=4, sim_iters=8)
result, lines = run(cell, 2**31 + 17, {seconds}, {trace}, "cpu")
top = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps(dict(result=result, modules=top)))
"""


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line_and_the_modules_a_run_loads(test_bench, trace):
    """The CPU path of a run (the card's look skipped): the result's keys in
    order, ``breakdown`` only when traced, the compared numbers last, and no
    module of JAX or of the JAX package loaded."""
    code = CPU_RUN.format(root=ROOT, src=os.path.join(ROOT, "src"), cell="sobel4-always-k128",
                          bench=test_bench, seconds=4 if trace else 2, trace=trace)
    p = _run(["-c", code])
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    keys = list(out["result"])
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert keys == want + (["breakdown"] if trace else []) + ["checks"]
    assert out["result"]["correct"] is True
    assert "repro_torch" in out["modules"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(out["modules"])
    metrics = out["result"]["metrics"]
    if trace:
        assert {"decode.eval_ms_per_gen", "ranking.ms_per_gen", "variation.ms_per_gen",
                "explorer.gen_ms_p95"} <= set(metrics)
        assert set(out["result"]["device"]) >= {"busy_s", "window_s"}
    else:
        assert set(metrics) == {"evals_per_s", "setup_s"}


@pytest.mark.gpu
def test_every_cell_on_the_card():
    """One short run of each cell on the card: it ends with a result that is
    correct (run on the card host)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for w in bench()["workloads"]:
        p = subprocess.run([sys.executable, "portbench/run.py", "--workload", w["name"],
                            "--seed", "4242424242", "--seconds", "4", "--trace", "0"],
                           cwd=ROOT, capture_output=True, text=True, timeout=900)
        assert p.returncode == 0, p.stderr[-3000:]
        assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
