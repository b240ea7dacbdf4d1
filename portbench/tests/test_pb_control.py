"""The check's control and the faults it has to catch, on the CPU at a size
a test run holds (the card's look skipped, the plain simulator in place of
the kernel)."""
import pytest
import torch

from portbench import check
from portbench.bench import run
from portbench.drive import build_problem, run_window

SEED = 2**31 + 11


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def window(cell, seconds=3.0):
    problem = build_problem(cell)
    with problem.make_engine(sim_backend="torch", device="cpu") as engine:
        return run_window(cell, problem, engine, SEED, seconds)


@pytest.mark.parametrize("name,seconds", [("sobel4-always-k128", 3.0), ("mcam-always-k128", 10.0)])
def test_the_control_is_not_correct(tiny_cell, name, seconds):
    """The program reads within every limit; the reference computed in
    float32 in its place fails the answers, the ranking or the archive."""
    cell = tiny_cell(name)
    outputs = window(cell, seconds).outputs
    sound = check.compare(cell, outputs, SEED)
    assert all(sound[k] <= v for k, v in check.LIMITS.items()), sound
    assert sound["answers_off"] == sound["ranking_rows_off"] == sound["archive_points_off"] == 0
    control = check.compare(cell, check.control_outputs(cell, outputs, SEED), SEED)
    assert any(control[k] > check.LIMITS[k] for k in
               ("answers_off", "ranking_rows_off", "archive_points_off")), control


def test_the_observer_sees_every_step(tiny_cell):
    """The check reads the timed path through the explorer's ``_step``
    (kinds vary, eval, rank) and ``on_generation``; a program that stops
    calling them fails here first."""
    from repro_torch.evo.explorer import TorchNSGA2Explorer

    assert callable(getattr(TorchNSGA2Explorer, "_step", None))
    w = window(tiny_cell("sobel4-always-k128"), 3.0)
    out, runs = w.outputs, len(w.ends)
    assert out["calls"] == {"vary": runs, "eval": runs + 1, "rank": runs}, (out["calls"], runs)
    assert len(out["first"]) == 1 and len(out["first"][0][0]) == 8
    assert len(out["generations"]) == out["expected"] >= 1
    for g in out["generations"][:-1]:
        assert g["next"] is not None
    for g in out["generations"]:
        assert len(g["child"]) == len(g["evals"][0][0]) == 4
        assert len(g["merged"]) == len(g["order"]) == 12
        assert len(g["archive"]) >= 1


def _state_unchanged(ex, monkeypatch):
    # Truncation keeps the current population whatever the offspring.
    monkeypatch.setattr(ex, "truncation_order",
                        lambda ranks, crowd: torch.arange(ranks.shape[0], device=ranks.device))


def _half_batch(ex, monkeypatch):
    # The evaluator computes the first half of its rows and gives the rest
    # the mean of that half.
    make = ex.make_relaxed_eval

    def make_half(*args, **kwargs):
        fn = make(*args, **kwargs)

        def evaluate(genes):
            h = max(1, genes.shape[0] // 2)
            F = fn(genes[:h])
            rest = F.mean(0, keepdim=True).expand(genes.shape[0] - h, -1)
            return torch.cat([F, rest])
        return evaluate
    monkeypatch.setattr(ex, "make_relaxed_eval", make_half)


def _answer_altered(ex, monkeypatch):
    # One answer altered where it is produced: row 0's memory, one byte off.
    make = ex.make_relaxed_eval

    def make_altered(*args, **kwargs):
        fn = make(*args, **kwargs)
        col = list(args[1]).index("memory")

        def evaluate(genes):
            F = fn(genes).clone()
            F[0, col] += 1
            return F
        return evaluate
    monkeypatch.setattr(ex, "make_relaxed_eval", make_altered)


def _parents_unchanged(ex, monkeypatch):
    # Variation hands the tournament's parents back: no crossover, no mutation.
    monkeypatch.setattr(ex, "uniform_crossover", lambda gen, pa, pb, rate: pa)
    monkeypatch.setattr(ex, "mutate", lambda gen, genes, bounds, mut_mask=None: genes)


def _fold_drops_a_point(ex, monkeypatch):
    # The archive fold loses one nondominated point.
    nd = ex.nondominated
    monkeypatch.setattr(ex, "nondominated", lambda pts: nd(pts)[:-1] if len(nd(pts)) > 1 else nd(pts))


def _tables(rows, actors):
    # The simulator's duration table altered before the launch.
    def plant(ex, monkeypatch):
        from repro_torch.kernels import sim_step as ks

        step = ks.sim_step

        def altered(tab, *args, **kwargs):
            tab.dur[rows(tab.dur.shape[0]), actors(tab.dur.shape[1])] += 3
            return step(tab, *args, **kwargs)
        monkeypatch.setattr(ks, "sim_step", altered)
    return plant


_last_row = _tables(lambda b: slice(b - 1, b), lambda a: slice(None))      # the last block
_upper_actors = _tables(lambda b: slice(None), lambda a: slice(a // 2, a))  # one warp's actors


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered,
                                   _parents_unchanged, _fold_drops_a_point, _last_row,
                                   _upper_actors])
def test_a_broken_timed_path_is_not_correct(tiny_cell, monkeypatch, fault):
    from repro_torch.evo import explorer as ex

    fault(ex, monkeypatch)
    result, lines = run(tiny_cell("sobel4-always-k128"), SEED, 3.0, False, "cpu")
    assert result["correct"] is False, lines


def test_outputs_never_seen_are_not_correct(tiny_cell):
    """A window whose steps the observer never saw (a program that no
    longer calls what it reads) counts every due row as off."""
    cell = tiny_cell("sobel4-always-k128")
    numbers = check.compare(cell, {"generations": [], "first": [], "expected": 4}, SEED)
    assert numbers["answers_off"] == 4 * 4 + 8
    assert numbers["offspring_copies_pct"] == 100.0
