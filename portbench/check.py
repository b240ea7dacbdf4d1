"""``correct``: the timed path's outputs against the frozen reference.

Four numbers, each compared with the reference on what the timed path
produced (the initial population and the generations
:class:`~portbench.drive.Observer` kept):

* ``answers_off``: answers that differ from the reference's.  Each row of
  the initial population and of every kept offspring batch gives one
  answer, its ``memory`` and ``core_cost`` from the relaxed decode; it is
  off when they differ from the reference's decode of the same genes, or
  when the genes leave their bounds or the strategy's fixed ξ.  A sample
  (:func:`sim_sample`: in the initial population and in each kept
  generation, the first and last row of every launch, the largest and
  smallest ``sim_period`` and rows drawn from the seed, 16 a group) gives
  one more answer each, its ``sim_period``, against the reference
  simulator on the reference's own tables.  Every row of a generation
  that was due and never seen counts as off.
* ``ranking_rows_off``: in each kept generation, the merged rows whose
  objectives are not the parents' and the offspring's as evaluated, the
  places of the truncation order that differ from the reference's
  ranking, crowding and truncation of the same merged objectives, and the
  rows of the population handed to the next generation that are not the
  survivors.
* ``archive_points_off``: points of the archive after each kept
  generation that are not, or are missing from, the reference's fold of
  the archive before it with the survivors' objectives.
* ``offspring_copies_pct``: the share of the kept offspring rows that are
  equal to a row of their parent population.  Crossover and mutation make
  new rows; a variation that hands its parents back reads 100.

The first three are exact (the arithmetic is integer, or float64 with the
same operations), so their limit is 0; the last is a share whose limit
lies between the program's readings and its planted control's.  The
program's genes, parents and merged objectives are its state: the
reference takes them as the input of the stage it checks and works out
everything else again.

The control (:func:`control_outputs`) is the reference put in the
program's place with its objectives, ranking and archive fold computed
in float32, judged by the float64 reference.  ``sim_period`` is one
answer of the first number rather than a number of its own: float32
leaves most periods exact (D/R with R = 1), so alone it would have no
control reading.  Float32 cannot move the copies; their control is a
variation that hands the tournament's parents back
(``portbench/control.py --parents-seeds``).
"""
from __future__ import annotations

import random
from typing import Dict, Tuple

import numpy as np

from .reference import decode as rdecode
from .reference import model as rmodel
from .reference import ranking as rranking
from .reference import sim as rsim

__all__ = ["LIMITS", "compare", "control_outputs"]

LIMITS = {"answers_off": 0, "ranking_rows_off": 0, "archive_points_off": 0,
          "offspring_copies_pct": 60.0}
SIM_ROWS_PER_GROUP = 16
_FORCED = {"Reference": 0, "MRB_Always": 1, "MRB_Explore": None}


class Reference:
    """The reference of one cell: graph, target and a decode per ξ pattern."""

    def __init__(self, cell):
        self.graph = rmodel.graph_from_config(cell.config["application"])
        self.arch = rmodel.arch_from_config(cell.config["architecture"])
        self.layout = rdecode.Layout(self.graph, self.arch)
        self.pipelined = bool(cell.config["pipelined"])
        self.objectives = tuple(cell.mix["objectives"])
        self.K = int(cell.mix["params"]["sim_iters"])
        self.mu = int(cell.mix["params"]["population"])
        self.forced = _FORCED[cell.mix["strategy"]]
        self._decoders: Dict[Tuple[int, ...], rdecode.RelaxedDecode] = {}

    def decoder(self, pattern: Tuple[int, ...]) -> rdecode.RelaxedDecode:
        if pattern not in self._decoders:
            self._decoders[pattern] = rdecode.RelaxedDecode(self.graph, self.arch, pattern,
                                                            self.pipelined)
        return self._decoders[pattern]

    def valid(self, genes: np.ndarray) -> np.ndarray:
        """Rows whose genes lie in their bounds, with the strategy's ξ."""
        lay = self.layout
        ok = ((genes >= 0) & (genes < lay.bounds[None, :])).all(1)
        if self.forced is not None and lay.n_xi:
            ok &= (genes[:, :lay.n_xi] == self.forced).all(1)
        return ok

    def patterns(self, genes: np.ndarray):
        xi = genes[:, :self.layout.n_xi]
        for pat in sorted({tuple(int(v) for v in row) for row in xi}):
            yield pat, np.nonzero((xi == np.array(pat, dtype=xi.dtype)).all(1))[0]

    def objectives_of(self, genes: np.ndarray, dtype=np.float64, with_sim: bool = True):
        """The reference's objective matrix (float64 holding ``dtype``
        values) of gene rows; ``sim_period`` is NaN when ``with_sim`` is
        off."""
        F = np.full((len(genes), len(self.objectives)), np.nan)
        for pat, rows in self.patterns(genes):
            dec = self.decoder(pat)
            out = dec.decode(genes[rows], dtype)
            if with_sim and "sim_period" in self.objectives:
                fire, dead, _ = rsim.simulate(dec.kind, dec.chan, dec.slot, dec.n_tasks,
                                              dec.nread, dec.delay, out["dur"], out["route"],
                                              out["core"], out["gamma"], self.K)
                out["sim_period"] = rsim.period(fire, dead, self.K, dtype)
            for j, name in enumerate(self.objectives):
                if name in out:
                    F[rows, j] = np.asarray(out[name]).astype(np.float64)
        return F


def _groups(outputs: dict):
    """The evaluated batches, grouped: the initial population's (when it
    was seen), then each kept generation's."""
    groups = [outputs["first"]] if outputs.get("first") else []
    return groups + [g["evals"] for g in outputs["generations"]]


def sim_sample(outputs: dict, seed: int, col: int):
    """(group, batch, row) triples whose sim_period is compared: in each
    group of :func:`_groups`, the first and the last row of every batch
    (the first and the last block of a launch), the rows with the largest
    and the smallest sim_period, and rows drawn from the seed, up to
    :data:`SIM_ROWS_PER_GROUP`."""
    rng = random.Random(seed)
    picks = []
    for gi, batches in enumerate(_groups(outputs)):
        rows = [(bi, r) for bi, (genes, _) in enumerate(batches) for r in range(len(genes))]
        if not rows:
            continue
        sims = np.array([batches[bi][1][r, col] for bi, r in rows])
        chosen = {rows[int(np.argmax(sims))], rows[int(np.argmin(sims))]}
        for bi, (genes, _) in enumerate(batches):
            chosen.update({(bi, 0), (bi, len(genes) - 1)})
        rest = [x for x in rows if x not in chosen]
        chosen.update(rng.sample(rest, min(len(rest), max(0, SIM_ROWS_PER_GROUP - len(chosen)))))
        picks.extend((gi, bi, r) for bi, r in sorted(chosen))
    return picks


def child_objectives(child: np.ndarray, evals, m: int) -> np.ndarray:
    """The offspring's objectives in the offspring's order, looked up by
    genes in the evaluated batches (which may hold the rows in another
    order, one batch per ξ pattern); NaN for a row never evaluated."""
    seen = {}
    for genes, F in evals:
        for x, f in zip(np.ascontiguousarray(genes), F):
            seen[x.tobytes()] = f
    missing = np.full(m, np.nan)
    return np.stack([seen.get(x.tobytes(), missing) for x in np.ascontiguousarray(child)])


def copies(parents: np.ndarray, child: np.ndarray) -> int:
    """Offspring rows equal to a row of the parent population."""
    P = {row.tobytes() for row in np.ascontiguousarray(parents)}
    return sum(row.tobytes() in P for row in np.ascontiguousarray(child))


def compare(cell, outputs: dict, seed: int) -> Dict[str, float]:
    """The numbers compared, each against :data:`LIMITS`."""
    ref = Reference(cell)
    gens = outputs["generations"]
    objs = ref.objectives
    params = cell.mix["params"]
    mu = ref.mu
    numbers: Dict[str, float] = dict.fromkeys(LIMITS, 0)

    # Due but never seen: whole batches count as off.
    missing = outputs["expected"] - len(gens)
    numbers["answers_off"] += missing * int(params["offspring"])
    numbers["ranking_rows_off"] += missing * (mu + int(params["offspring"]))
    numbers["archive_points_off"] += missing
    if not outputs.get("first"):
        numbers["answers_off"] += mu
    decoded = [c for c, o in enumerate(objs) if o != "sim_period"]
    groups = _groups(outputs)
    for batches in groups:
        for genes, F in batches:
            bad = ~ref.valid(genes)
            ok = np.nonzero(~bad)[0]
            R = ref.objectives_of(genes[ok], with_sim=False)
            off = (F[ok][:, decoded] != R[:, decoded]).any(1)
            numbers["answers_off"] += int(bad.sum()) + int(off.sum())

    if "sim_period" in objs:
        col = objs.index("sim_period")
        picks = [(gi, bi, r) for gi, bi, r in sim_sample(outputs, seed, col)
                 if ref.valid(groups[gi][bi][0][r:r + 1])[0]]
        if picks:
            genes = np.stack([groups[gi][bi][0][r] for gi, bi, r in picks])
            got = np.array([groups[gi][bi][1][r, col] for gi, bi, r in picks])
            want = ref.objectives_of(genes)[:, col]
            numbers["answers_off"] += int((got != want).sum())

    n_copies = n_child = 0
    for g in gens:
        child = g["child"]
        child_F = child_objectives(child, g["evals"], len(objs))
        # The merged ranking: of the parents and the offspring as evaluated,
        # in the reference's truncation order.
        mF = g["merged"]
        want_F = np.concatenate([g["parents_F"], child_F])
        same = mF.shape == want_F.shape
        numbers["ranking_rows_off"] += (int((mF != want_F).any(1).sum()) if same
                                        else len(want_F))
        r = rranking.ranks(mF)
        want = rranking.truncation(r, rranking.crowding(mF, r))
        numbers["ranking_rows_off"] += int((g["order"] != want).sum())
        # The population handed on: the survivors, genes and objectives.
        kept = g["order"][:mu]
        if g["next"] is not None:
            mg = np.concatenate([g["parents"], child])
            nP, nF = g["next"]
            numbers["ranking_rows_off"] += int(((nP != mg[kept]).any(1)
                                                | (nF != mF[kept]).any(1)).sum())
        # The archive: the one before, folded with the survivors.
        fold = rranking.archive(g["archive_before"], mF[kept])
        numbers["archive_points_off"] += _multiset_gap(g["archive"], fold)
        # Variation: offspring that copy a parent row.
        n_copies += copies(g["parents"], g["child"])
        n_child += len(g["child"])
    numbers["offspring_copies_pct"] = (100.0 * n_copies / n_child if n_child
                                       else 100.0 if missing else 0.0)
    return numbers


def _multiset_gap(a: np.ndarray, b: np.ndarray) -> int:
    """Points in one archive and not in the other, counted with multiplicity."""
    from collections import Counter

    ca = Counter(tuple(row.tolist()) for row in a)
    cb = Counter(tuple(row.tolist()) for row in b)
    return sum(((ca - cb) + (cb - ca)).values())


def control_outputs(cell, outputs: dict, seed: int) -> dict:
    """The control in the program's place: the objectives of the initial
    population and of every kept offspring batch from the reference
    computed in float32 (``sim_period`` on the compared sample only, the
    rest as the program gave them), and each merged ranking, truncation
    and archive fold computed in float32 over the parents' objectives and
    those offspring objectives."""
    ref = Reference(cell)
    objs = ref.objectives
    out = dict(outputs, generations=[])
    decoded = [j for j, o in enumerate(objs) if o != "sim_period"]
    picked = set()
    if "sim_period" in objs:
        picked = {(gi, bi, r) for gi, bi, r in sim_sample(outputs, seed, objs.index("sim_period"))}

    def lower(gi, bi, genes, F):
        C = F.copy()
        C[:, decoded] = ref.objectives_of(genes, np.float32, with_sim=False)[:, decoded]
        rows = [r for r in range(len(genes)) if (gi, bi, r) in picked]
        if rows and "sim_period" in objs:
            j = objs.index("sim_period")
            C[rows, j] = ref.objectives_of(genes[rows], np.float32)[:, j]
        return C

    gi = 0
    if outputs.get("first"):
        out["first"] = [(genes, lower(0, bi, genes, F))
                        for bi, (genes, F) in enumerate(outputs["first"])]
        gi = 1
    for g in outputs["generations"]:
        evals = [(genes, lower(gi, bi, genes, F)) for bi, (genes, F) in enumerate(g["evals"])]
        gi += 1
        child = g["child"]
        mF = np.concatenate([g["parents_F"], child_objectives(child, evals, len(objs))])
        r = rranking.ranks(mF, np.float32)
        order = rranking.truncation(r, rranking.crowding(mF, r, np.float32))
        kept = order[:ref.mu]
        nxt = (np.concatenate([g["parents"], child])[kept], mF[kept])
        out["generations"].append(dict(
            g, evals=evals, merged=mF, order=order, next=nxt if g["next"] is not None else None,
            archive=rranking.archive(g["archive_before"], mF[kept], np.float32)))
    return out
