import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

import pytest  # noqa: E402


def tiny(cell):
    """A cell at a size the CPU's plain simulator holds: the cell's own
    configuration and strategy, a population of 8, offspring 4, K = 16."""
    cell.mix["params"].update(population=8, offspring=4, sim_iters=16)
    return cell


# Sobel4, the paper's mid-size application, has no cell in BENCHMARK.json:
# its throughput spread too widely on the card host (PERF.md §7).  Its
# configuration stays under portbench/configs, and the tests drive the
# harness on its smaller graph as a cell of their own, reporting what the
# benchmark's first cell reports.
TEST_CELLS = [
    ({"name": "sobel4", "source": "https://arxiv.org/abs/2311.17473",
      "file": "portbench/configs/sobel4.json", "reduced": []},
     {"name": "sobel4-always-k128", "config": "sobel4", "traffic": "always-k128", "chips": 1}),
]


def with_test_cells(bench):
    """``bench`` with :data:`TEST_CELLS` added."""
    like = bench["workloads"][0]["name"]
    for conf, cell in TEST_CELLS:
        bench["configs"].append(conf)
        bench["workloads"].append(cell)
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", ()):
                m["workloads"].append(cell["name"])
    return bench


@pytest.fixture
def test_bench():
    """BENCHMARK.json with the tests' own cells."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return with_test_cells(json.load(f))


@pytest.fixture
def tiny_cell(test_bench):
    from portbench.cells import load_cell

    return lambda name: tiny(load_cell(name, bench=test_bench))
