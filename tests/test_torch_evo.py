"""The port's device-resident explorer (``repro_torch.evo``) against the JAX
package's ``repro.evo`` on the CPU, on the same seeded numpy inputs:

* ranking: ``(rank, crowd)`` equal to ``repro.core.pareto`` on inf- and
  duplicate-heavy sets, and the batched ops equal to ``repro.evo.ranking``;
* ``PopulationLayout`` round trips equal to the reference's;
* ``make_relaxed_eval``: the objective matrix equal to the reference's
  (jitted under a scoped ``jax.enable_x64(True)``) on four cases with
  ``sim_period`` and on Multicamera's 111-channel binding scan without it;
* exact mode: front, history and evaluations equal to the reference's
  host ``nsga2``; relaxed mode: relHV ≥ 0.25 against it;
* variation: bounds, forced genes and the mutation mask respected, and a
  run repeating exactly for a seed.

The reference's explorer and its ``parity_rank_crowd`` are not run: they
import ``jax.experimental.enable_x64``, which jax 0.9 removed.  Only its
pure functions are called, inside ``with jax.enable_x64(True):``, which
leaves the global config as it was.  torch runs at one intra-op thread
here (``one_thread``).
"""
import inspect
import math
import os
import random

os.environ.setdefault("REPRO_SIM_CACHE_DIR", "0")

import jax
import numpy as np
import pytest
import torch

import repro.core as ref
import repro_torch.core as port
from repro.evo import decode as rdecode
from repro.evo import ranking as rranking
from repro.evo.encoding import PopulationLayout as RefLayout
from repro.evo.explorer import JaxNSGA2Explorer
from repro.scenarios import sample_scenarios
from repro_torch.bridge import problem_from_json
from repro_torch.evo import PopulationLayout, TorchNSGA2Explorer
from repro_torch.evo import decode as pdecode
from repro_torch.evo import ranking as pranking
from repro_torch.evo import variation

# Relaxed objective matrices: every column exact, inf in the same places,
# except sim_period, whose fallback and rate divisions (D / R) the jitted
# reference computes as D * (1/R): XLA turns division by a constant into a
# multiplication by its reciprocal, one ulp off the IEEE quotient that
# torch and the host's measure_period take.  Those entries must agree to
# 1e-12 relative.
SIM_PERIOD_RTOL = 1e-12
EVAL_ROWS = 64
SIM_ITERS = 16
ALL_RELAXED = ("sim_period", "period", "memory", "core_cost", "comm_volume")
NO_SIM = ALL_RELAXED[1:]
CFG = dict(population=12, offspring=6, generations=4, seed=7)     # tests/test_evo.py:85
RELAXED_CFG = dict(population=32, offspring=16, generations=4, seed=11)  # :139


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _carry(rp):
    """(reference problem, port problem) from one JSON dict with the graphs
    embedded: the reference's own round trip fixes the graph order."""
    d = rp.to_json()
    d.pop("scenario", None)
    d["graph"], d["arch"] = rp.graph.to_dict(), rp.arch.to_dict()
    return ref.ExplorationProblem.from_json(d), problem_from_json(d)


def _stencil(objectives):
    sc = sample_scenarios(seed=3, n=1, families=["stencil_chain"])[0]
    return _carry(ref.ExplorationProblem.from_scenario(sc, objectives=objectives))


# ---------------------------------------------------------------- ranking
def _host_rank_crowd(objs):
    fronts = ref.fast_nondominated_sort(objs)
    rank, crowd = {}, {}
    for fi, front in enumerate(fronts):
        d = ref.crowding_distance(objs, front)
        for i in front:
            rank[i] = fi
            crowd[i] = d[i]
    return rank, crowd


def _objective_sets(seed, trials, vals):
    """tests/test_evo.py's fuzz sets: random k-objective sets drawn from
    ``vals`` (heavy duplication; inf where ``vals`` holds it)."""
    rng = random.Random(seed)
    out = []
    for _ in range(trials):
        n, k = rng.randint(1, 24), rng.randint(2, 4)
        out.append([tuple(rng.choice(vals) for _ in range(k)) for _ in range(n)])
    return out


SETS = {
    "inf_duplicates": _objective_sets(42, 25, [0.0, 1.0, 2.0, 3.0, 4.0, math.inf]),
    "finite": _objective_sets(7, 10, [float(v) for v in range(10)]),
}
# The same draws at three fixed shapes, for the reference's batched ops:
# jax compiles each op once per shape.
SHAPES = ((24, 3), (13, 2), (20, 4))


def _shaped_sets(seed, vals, trials=4):
    rng = random.Random(seed)
    return [[tuple(rng.choice(vals) for _ in range(k)) for _ in range(n)]
            for n, k in SHAPES for _ in range(trials)]


SHAPED_SETS = {
    "inf_duplicates": _shaped_sets(42, [0.0, 1.0, 2.0, 3.0, 4.0, math.inf]),
    "finite": _shaped_sets(7, [float(v) for v in range(10)]),
}


def _same_float(a, b):
    return a == b or (math.isinf(a) and math.isinf(b) and (a > 0) == (b > 0))


@pytest.mark.parametrize("kind", sorted(SETS))
def test_parity_rank_crowd_matches_host_pareto(kind):
    for objs in SETS[kind]:
        h_rank, h_crowd = _host_rank_crowd(objs)
        d_rank, d_crowd = pranking.parity_rank_crowd(objs, "cpu")
        assert d_rank == h_rank, objs
        assert set(d_crowd) == set(h_crowd)
        assert all(_same_float(h_crowd[i], d_crowd[i]) for i in h_crowd), objs


@pytest.mark.parametrize("kind", sorted(SETS))
def test_ranking_ops_match_reference(kind):
    """nondomination_ranks / crowding (row-order and host-sequence ties) /
    truncation_order equal repro.evo.ranking's, bit for bit."""
    for objs in SHAPED_SETS[kind]:
        F = np.asarray(objs, np.float64)
        Ft = torch.as_tensor(F)
        with jax.enable_x64(True):
            r_rank = np.asarray(rranking.nondomination_ranks(F))
            r_crowd = np.asarray(rranking.crowding(F, r_rank))
            r_order = np.asarray(rranking.truncation_order(r_rank, r_crowd))
            r_dom = np.asarray(rranking.domination_matrix(F))
            seq = [i for f in rranking.host_front_sequence(r_dom) for i in f]
            pos = np.argsort(seq).astype(np.int32)
            r_crowd_seq = np.asarray(rranking.crowding(F, r_rank, pos))
        p_rank = pranking.nondomination_ranks(Ft)
        p_crowd = pranking.crowding(Ft, p_rank)
        assert np.array_equal(pranking.domination_matrix(Ft).numpy(), r_dom)
        assert pranking.host_front_sequence(r_dom) == rranking.host_front_sequence(r_dom)
        assert p_rank.dtype == torch.int32 and np.array_equal(p_rank.numpy(), r_rank)
        assert np.array_equal(p_crowd.numpy(), r_crowd), objs
        assert np.array_equal(pranking.truncation_order(p_rank, p_crowd).numpy(), r_order)
        p_crowd_seq = pranking.crowding(Ft, p_rank, torch.as_tensor(pos))
        assert np.array_equal(p_crowd_seq.numpy(), r_crowd_seq), objs


def test_ranking_empty_and_singleton():
    assert pranking.parity_rank_crowd([], "cpu") == ({}, {})
    r, c = pranking.parity_rank_crowd([(1.0, 2.0)], "cpu")
    assert r == {0: 0} and math.isinf(c[0])
    empty = torch.zeros((0, 3), dtype=torch.float64)
    assert pranking.nondomination_ranks(empty).shape == (0,)
    assert pranking.crowding(empty, torch.zeros(0, dtype=torch.int32)).shape == (0,)


# --------------------------------------------------------------- encoding
@pytest.mark.parametrize("mode", ["explore", "always", "never"])
def test_layout_matches_reference(mode):
    rp, pp = _carry(ref.ExplorationProblem(graph=ref.sobel(), arch=ref.paper_architecture()))
    rs, ps = rp.space(), pp.space()
    rl, pl = RefLayout(rs, mode), PopulationLayout(ps, mode)
    assert np.array_equal(pl.bounds, rl.bounds) and pl.xi_forced == rl.xi_forced
    assert (pl.n_xi, pl.n_cd, pl.n_ba) == (rl.n_xi, rl.n_cd, rl.n_ba)
    rng = random.Random(5)
    gts = [rs.random(rng, "explore") for _ in range(16)]
    genes = rl.encode(gts)
    assert np.array_equal(pl.encode([port.Genotype(g.xi, g.cd, g.ba) for g in gts]), genes)
    assert [(g.xi, g.cd, g.ba) for g in pl.decode(genes)] == [
        (g.xi, g.cd, g.ba) for g in rl.decode(genes)
    ]
    assert np.array_equal(pl.force_xi(genes), rl.force_xi(genes))
    mine, theirs = pl.xi_patterns(genes), rl.xi_patterns(genes)
    assert [p for p, _ in mine] == [p for p, _ in theirs]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(mine, theirs))


# ---------------------------------------------------------- relaxed decode
EVAL_CASES = {  # name: (application, ξ, objectives, seed of the gene rows)
    "sobel_xi0": ("sobel", 0, ALL_RELAXED, 1),
    "sobel_xi1": ("sobel", 1, ALL_RELAXED, 2),
    "sobel4_xi1": ("sobel4", 1, ALL_RELAXED, 0),
    "stencil_chain3_xi1": ("stencil", 1, ALL_RELAXED, 3),
    # 111 channels at ξ=0 (37 at ξ=1): the binding scan's longest run of
    # capacity fallbacks.  No sim_period, so the reference compile is light.
    "multicamera_xi0": ("multicamera", 0, NO_SIM, 4),
    "multicamera_xi1": ("multicamera", 1, NO_SIM, 5),
}


def _eval_problem(app, objectives):
    if app == "stencil":
        return _stencil(objectives)
    g = getattr(ref, app)()
    return _carry(ref.ExplorationProblem(graph=g, arch=ref.paper_architecture(),
                                         objectives=objectives))


@pytest.fixture(scope="module")
def relaxed_reference():
    """case → (port problem, genes, ξ pattern, the reference's objective
    matrix): one reference compile per case, shared by every test that
    needs it."""
    memo = {}

    def get(case):
        if case not in memo:
            app, xi, objectives, seed = EVAL_CASES[case]
            rp, pp = _eval_problem(app, objectives)
            layout = RefLayout(rp.space(), "explore")
            genes = np.random.default_rng(seed).integers(
                0, layout.bounds, size=(EVAL_ROWS, layout.n_genes)).astype(np.int32)
            genes[:, layout.xi_slice] = xi
            pattern = (xi,) * layout.n_xi
            with jax.enable_x64(True):
                fn = rdecode.make_relaxed_eval(rdecode.DecodeTables(rp.space(), pattern),
                                               objectives, sim_iters=SIM_ITERS)
                F = np.asarray(jax.jit(fn)(genes))
            memo[case] = (pp, genes, pattern, F)
        return memo[case]

    return get


def assert_objectives_match(mine, theirs, objectives):
    assert mine.shape == theirs.shape and mine.dtype == np.float64
    assert np.array_equal(np.isinf(mine), np.isinf(theirs))
    for k, name in enumerate(objectives):
        a, b = mine[:, k], theirs[:, k]
        fin = np.isfinite(b)
        if name == "sim_period":
            assert np.allclose(a[fin], b[fin], rtol=SIM_PERIOD_RTOL, atol=0), name
        else:
            assert np.array_equal(a[fin], b[fin]), name


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_relaxed_eval_matches_reference(case, relaxed_reference):
    objectives = EVAL_CASES[case][2]
    pp, genes, pattern, F_ref = relaxed_reference(case)
    tab = pdecode.DecodeTables(pp.space(), pattern)
    fn = pdecode.make_relaxed_eval(tab, objectives, sim_iters=SIM_ITERS, device="cpu")
    F = fn(torch.as_tensor(genes))
    assert F.dtype == torch.float64 and F.device.type == "cpu"
    assert_objectives_match(F.numpy(), F_ref, objectives)
    # Column subsets and order follow the objective list.
    sub = pdecode.make_relaxed_eval(tab, ("core_cost", "period"), device="cpu")
    cols = [objectives.index("core_cost"), objectives.index("period")]
    assert np.array_equal(sub(torch.as_tensor(genes)).numpy(), F.numpy()[:, cols])


def _reference_asap(tab, dur):
    """The reference's ASAP loop (``repro/evo/decode.py:307-321``) written
    out in numpy for one phenotype: per actor in arbitration order, its
    window starts at the latest finish of its zero-delay inputs."""
    st, C, big = tab.static, tab.C, 1 << 40
    ts = st["ts_tab"]
    valid = np.arange(st["Tmax"])[None, :] < st["n_tasks"][:, None]
    slot_ch = (ts[:, :, 2:2 + C] > 0) & valid[:, :, None]
    is_rd, is_wr = ts[:, :, 0] > 0, ts[:, :, 1] > 0
    wfin, rfin, wstart = np.zeros(C, np.int64), np.full(C, -big), np.full(C, -big)
    for k in range(tab.A):
        ws = np.where(tab.in0mask[k], wfin, 0).max()
        ends = ws + np.cumsum(dur[k])
        starts = ends - dur[k]
        rd, wr = is_rd[k, :, None] & slot_ch[k], is_wr[k, :, None] & slot_ch[k]
        rfin = np.maximum(rfin, np.where(rd, ends[:, None], -big).max(0))
        wstart = np.where(tab.outmask[k], np.where(wr, starts[:, None], -big).max(0), wstart)
        wfin = np.where(tab.outmask[k], np.where(wr, ends[:, None], -big).max(0), wfin)
    return rfin, wstart


@pytest.mark.parametrize("app,xi,pipelined", [
    ("multicamera", 0, False), ("multicamera", 1, False), ("sobel4", 1, True),
])
def test_asap_pass_matches_the_reference_loop(app, xi, pipelined):
    """The ASAP pass on task triples against the reference's per-actor
    loop, on seeded durations; unpipelined graphs (δ = 0 everywhere) chain
    window starts through zero-delay inputs."""
    pp = port.ExplorationProblem(graph=getattr(port, app)(), arch=port.paper_architecture())
    tab = pdecode.DecodeTables(pp.space(), (xi,) * len(pp.space().mcast), pipelined=pipelined)
    valid = np.arange(tab.static["Tmax"])[None, :] < tab.static["n_tasks"][:, None]
    dur = np.random.default_rng(xi).integers(0, 60, size=(6, tab.A, tab.static["Tmax"])) * valid
    rfin, wstart = pdecode.asap_pass(tab, "cpu")(torch.as_tensor(dur))
    assert bool(tab.in0mask.any()) != pipelined
    for b in range(dur.shape[0]):
        want_r, want_w = _reference_asap(tab, dur[b])
        assert np.array_equal(rfin[b].numpy(), want_r) and np.array_equal(wstart[b].numpy(), want_w)


def test_relaxed_eval_rejects_unknown_objectives():
    _, pp = _carry(ref.ExplorationProblem(graph=ref.sobel(), arch=ref.paper_architecture()))
    tab = pdecode.DecodeTables(pp.space(), (0, 0))
    with pytest.raises(ValueError, match="cannot produce"):
        pdecode.make_relaxed_eval(tab, ("period", "latency"), device="cpu")


def test_relaxed_eval_is_inf_where_the_fire_buffer_wraps(monkeypatch):
    """Event times pass 2**31 within the first K firings and wrap as int32:
    sim_period is inf exactly on the rows where the plain program reports a
    deadlock or writes a negative fire time, and the other objectives stay
    finite."""
    from repro_torch.kernels import sim_step as kmod

    g = port.ApplicationGraph("huge")
    for a in ("A", "B"):
        g.add_actor(a, {"t1": 3 * 2**26, "t2": 3 * 2**26, "t3": 3 * 2**26})
    g.add_channel("c", "A", "B", delay=1, capacity=2, token_bytes=64)
    pp = port.ExplorationProblem(graph=g, arch=port.paper_architecture(),
                                 objectives=("sim_period", "memory"))
    layout = PopulationLayout(pp.space())
    genes = torch.as_tensor(np.random.default_rng(0).integers(
        0, layout.bounds, size=(16, layout.n_genes)).astype(np.int32))
    seen = []
    launch = kmod.sim_step
    monkeypatch.setattr(kmod, "sim_step", lambda *a: seen.append(launch(*a)) or seen[-1])
    F = pdecode.make_relaxed_eval(pdecode.DecodeTables(pp.space(), ()),
                                  ("sim_period", "memory"), sim_iters=SIM_ITERS,
                                  device="cpu")(genes)
    (fire, dead, horizon), = seen
    wrapped = dead | (fire[:, :, :SIM_ITERS] < 0).flatten(1).any(1)
    assert bool(wrapped.any()) and bool((horizon < 0).any())
    assert torch.equal(torch.isinf(F[:, 0]), wrapped)
    assert torch.isfinite(F[:, 1]).all()


def test_device_period_matches_host_measure_period():
    from repro_torch.sim.model import fallback_period, measure_period

    rng = np.random.default_rng(3)
    K = 32
    steps = rng.integers(1, 4, size=(6, 3, 1)) * rng.integers(5, 9, size=(6, 3, K))
    steps[:3] = steps[:3, :, :1]                        # settled: constant steps
    fire = np.cumsum(steps, 2).astype(np.int32)
    got = pdecode.device_period(torch.as_tensor(fire), torch.zeros(6, dtype=torch.bool), K)
    for b in range(6):
        ft = {a: [int(x) for x in fire[b, a]] for a in range(3)}
        want = measure_period(ft, max_multiplicity=16)
        want = fallback_period(ft) if want is None else want
        assert float(got[b]) == want, b
    dead = torch.tensor([True, False, False, False, False, False])
    fire[1, 0, 5] = -7
    got = pdecode.device_period(torch.as_tensor(fire), dead, K)
    assert torch.isinf(got[:2]).all() and torch.isfinite(got[2:]).all()


# ------------------------------------------------------------ exact mode
def _exact_case(rp, pp, **cfg):
    cfg = dict(CFG, **cfg)
    with rp.make_engine(sim_backend=None) as eng:
        host = ref.get_explorer("nsga2", **cfg).explore(rp, engine=eng)
    with pp.make_engine(sim_backend="torch", device="cpu") as eng:
        dev = port.get_explorer("torch_nsga2", evaluation="exact", **cfg).explore(pp, engine=eng)
    assert dev.front == host.front
    assert dev.history == host.history
    assert dev.evaluations == host.evaluations
    assert dev.meta == {"evaluation": "exact", "sim_backend": "torch", "device": "cpu"}


@pytest.mark.parametrize("strategy", ["Reference", "MRB_Explore"])
def test_exact_mode_matches_reference_host_nsga2_on_sobel(strategy):
    _exact_case(*_carry(ref.ExplorationProblem(
        graph=ref.sobel(), arch=ref.paper_architecture(), strategy=strategy)))


def test_exact_mode_matches_reference_host_nsga2_on_stencil_chain():
    _exact_case(*_stencil(("period", "memory", "core_cost", "comm_volume")))


# ----------------------------------------------------------- relaxed mode
def _relaxed_case(rp, pp, cfg, **extra):
    with rp.make_engine(sim_backend=None) as eng:
        host = ref.get_explorer("nsga2", **cfg).explore(rp, engine=eng)
    explorer = port.get_explorer("torch_nsga2", evaluation="relaxed", **cfg, **extra)
    with pp.make_engine(sim_backend="torch", device="cpu") as eng:
        dev = explorer.explore(pp, engine=eng)
    assert dev.front, "relaxed exploration produced an empty front"
    relhv = port.relative_hypervolume(dev.front, host.front)
    assert relhv >= 0.25, f"relaxed relHV {relhv:.3f} below tolerance"
    assert dev.meta["evaluation"] == "relaxed"
    assert dev.meta["relaxed_evaluations"] == cfg["population"] + (
        cfg["generations"] * cfg["offspring"])
    assert 0 < dev.meta["relaxed_final_candidates"] <= dev.evaluations + dev.cache_hits
    assert len(dev.history) == cfg["generations"] + 1
    return explorer


def test_relaxed_mode_within_relhv_of_reference():
    _relaxed_case(*_carry(ref.ExplorationProblem(
        graph=ref.sobel(), arch=ref.paper_architecture(), strategy="Reference")), RELAXED_CFG)


def test_relaxed_mode_with_sim_period_and_explored_xi():
    """sim_period among the objectives and ξ explored: every offspring
    batch is bucketed by ξ pattern, each bucket simulated in one call."""
    rp, pp = _carry(ref.ExplorationProblem(
        graph=ref.sobel(), arch=ref.paper_architecture(), strategy="MRB_Explore",
        objectives=("sim_period", "memory", "core_cost")))
    explorer = _relaxed_case(rp, pp, dict(population=16, offspring=8, generations=3, seed=2),
                             sim_iters=SIM_ITERS)
    assert len(explorer._evals) > 1       # one evaluator per ξ pattern seen


def test_relaxed_mode_rejects_host_only_objectives(monkeypatch):
    from repro_torch.core import problem as pproblem

    monkeypatch.setitem(pproblem.OBJECTIVES, "ctx_period", pproblem.Objective(
        "ctx_period", lambda ctx: float(ctx.schedule.period)))
    pp = port.ExplorationProblem(graph=port.sobel(), arch=port.paper_architecture(),
                                 objectives=("ctx_period", "memory"))
    with pp.make_engine(sim_backend=None, device="cpu") as eng:
        with pytest.raises(ValueError, match="not device-decodable"):
            TorchNSGA2Explorer(evaluation="relaxed", generations=1).explore(pp, engine=eng)


# -------------------------------------------------------------- variation
def _gen(seed=0):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


def test_variation_respects_bounds_forced_genes_and_mutation_mask():
    bounds = torch.tensor([2, 2, 5, 5, 5, 3, 1, 4], dtype=torch.int32)
    forced_m = torch.tensor([True, True] + [False] * 6)
    forced_v = torch.tensor([1, 1] + [0] * 6, dtype=torch.int32)
    genes = variation.init_population(_gen(1), 400, bounds, forced_m, forced_v)
    assert genes.dtype == torch.int32 and genes.shape == (400, 8)
    assert bool(((genes >= 0) & (genes < bounds)).all())
    assert bool((genes[:, :2] == 1).all())
    # every value of each free gene is drawn
    assert all(set(genes[:, g].tolist()) == set(range(int(bounds[g]))) for g in range(2, 8))
    mask = ~forced_m
    mutated = variation.mutate(_gen(2), genes, bounds, mask)
    assert bool(((mutated >= 0) & (mutated < bounds)).all())
    assert torch.equal(mutated[:, :2], genes[:, :2])
    changed = (mutated != genes).double().mean().item()
    assert 0.0 < changed < 0.2          # rate 1/G, some redraws land on the old value
    ranks = torch.tensor([0, 1, 0, 2], dtype=torch.int32)
    crowd = torch.tensor([1.0, math.inf, 0.5, 2.0], dtype=torch.float64)
    picks = variation.tournament_pick(_gen(3), ranks, crowd, 64)
    assert picks.min() >= 0 and picks.max() < 4
    pa, pb = genes[:10], genes[10:20]
    child = variation.uniform_crossover(_gen(4), pa, pb, 1.0)
    assert bool(((child == pa) | (child == pb)).all())
    assert torch.equal(variation.uniform_crossover(_gen(4), pa, pb, 0.0), pa)


def test_tournament_keeps_the_better_of_two_draws():
    ranks = torch.tensor([0, 1, 0, 2], dtype=torch.int32)
    crowd = torch.tensor([1.0, math.inf, 0.5, 2.0], dtype=torch.float64)
    g, twin = _gen(3), _gen(3)
    picks = variation.tournament_pick(g, ranks, crowd, 256)
    i, j = torch.randint(0, 4, (2, 256), generator=twin)
    key = lambda k: (int(ranks[k]), -float(crowd[k]))
    assert picks.tolist() == [a if key(a) <= key(b) else b for a, b in zip(i.tolist(), j.tolist())]


def test_relaxed_run_repeats_exactly_for_a_seed():
    pp = port.ExplorationProblem(graph=port.sobel(), arch=port.paper_architecture(),
                                 strategy="MRB_Always")
    runs = []
    for _ in range(2):
        with pp.make_engine(sim_backend=None, device="cpu") as eng:
            runs.append(TorchNSGA2Explorer(evaluation="relaxed", population=16, offspring=8,
                                           generations=3, seed=4).explore(pp, engine=eng))
    a, b = runs
    assert a.history == b.history and a.front == b.front
    assert [i.genotype for i in a.archive] == [i.genotype for i in b.archive]
    assert all(set(i.genotype.xi) == {1} for i in a.archive)


# --------------------------------------------------------------- registry
def test_registry_and_params_follow_the_reference():
    assert "torch_nsga2" in port.explorer_names()
    exp = port.get_explorer("torch_nsga2", evaluation="relaxed", population=4)
    assert isinstance(exp, TorchNSGA2Explorer)
    assert set(exp.params()) == {"population", "offspring", "generations", "crossover_rate",
                                 "seed", "time_budget_s", "evaluation"}
    assert (inspect.signature(TorchNSGA2Explorer.__init__).parameters.keys()
            == inspect.signature(JaxNSGA2Explorer.__init__).parameters.keys())
    with pytest.raises(ValueError):
        port.get_explorer("torch_nsga2", evaluation="approximate")
    with pytest.raises(ValueError):
        port.get_explorer("torch_nsga2", population=1)
