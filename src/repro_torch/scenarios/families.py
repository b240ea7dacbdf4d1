"""Parameterized SDF application-graph families (scenario subsystem).

Each family is a deterministic generator ``build(rng, **params) ->
ApplicationGraph`` registered in :data:`FAMILIES`.  All families follow the
repo-wide conventions of the paper apps (`repro_torch.core.apps`):

  * core types ``t1``/``t2``/``t3`` with the paper's 3×/2×/1× speed ratios,
    every actor runnable on every type (so any generated architecture with a
    subset of these types is feasible);
  * multi-cast actors satisfy the structural Eqs. (1)-(3): exactly one input
    channel, δ = 0 on all outputs, identical token sizes and capacities —
    enforced by construction and re-checked by ``multicast_actors``;
  * graphs are acyclic with δ = 0 everywhere (the DSE's
    ``pipeline_delays`` adds the §VI initial tokens).

Families (the "hundreds of graphs instead of three" axis):

  ``multicast_tree``    fan-out trees of multi-cast actors joined at a sink
  ``split_join``        Sobel4-style split → parallel branch pipelines → join
  ``stencil_chain``     repeated fork→{stencil ops}→combine stages in series
  ``camera_pipeline``   Multicamera-style chains with taps into a collector
  ``random_dag``        layered random DAGs with tunable multicast density

Add a new family by writing ``build_<name>(rng, **params)`` returning a
validated ``ApplicationGraph`` and registering it in ``FAMILIES`` (see
README "Scenario subsystem").
"""
from __future__ import annotations

import math
import random
from typing import Callable, Dict, List, Optional

from ..core.graph import ApplicationGraph, multicast_actors

__all__ = ["FAMILIES", "TOKEN_CLASSES", "exec_times", "build", "harmonize_graph"]

# Byte-size classes for generated tokens: image-plane-ish magnitudes scaled
# down so comm times stay small and decoding stays fast in tests.
TOKEN_CLASSES = (4_096, 19_000, 38_000, 76_000, 152_000)

CORE_TYPES = ("t1", "t2", "t3")


def exec_times(w: int) -> Dict[str, int]:
    """Core-type dependent execution times with the paper's 3×/2×/1× ratios."""
    return {
        "t1": max(1, math.ceil(w / 3)),
        "t2": max(1, math.ceil(w / 2)),
        "t3": max(1, w),
    }


def _work(rng: random.Random, lo: int = 4, hi: int = 40) -> Dict[str, int]:
    return exec_times(rng.randint(lo, hi))


def _tok(rng: random.Random) -> int:
    return rng.choice(TOKEN_CLASSES)


# ----------------------------------------------------------------- families
def build_multicast_tree(
    rng: random.Random,
    *,
    depth: int = 2,
    fanout: int = 2,
    capacity: int = 1,
) -> ApplicationGraph:
    """A fan-out tree: src → mc → fanout×(filter → mc → …) → leaves → join.

    Every internal level forks through a multi-cast actor, so |A_M| grows
    geometrically with depth — the densest MRB-replacement opportunity.
    """
    depth = max(1, depth)
    fanout = max(2, fanout)
    g = ApplicationGraph(f"mtree_d{depth}_f{fanout}")
    g.add_actor("src", _work(rng))
    g.add_actor("join", _work(rng))
    tok = _tok(rng)
    leaves: List[str] = []

    def grow(parent: str, level: int, tag: str) -> None:
        mc = f"mc_{tag}"
        g.add_actor(mc, _work(rng, 2, 8), multicast=True)
        g.add_channel(f"c_in_{tag}", parent, mc, token_bytes=tok, capacity=capacity)
        for k in range(fanout):
            child = f"f_{tag}{k}"
            g.add_actor(child, _work(rng))
            # mc outputs: δ=0, same token size and capacity (Eqs. 1-3).
            g.add_channel(f"c_out_{tag}{k}", mc, child, token_bytes=tok, capacity=capacity)
            if level + 1 < depth:
                grow(child, level + 1, f"{tag}{k}")
            else:
                leaves.append(child)

    grow("src", 0, "r")
    for i, leaf in enumerate(leaves):
        g.add_channel(f"c_leaf{i}", leaf, "join", token_bytes=_tok(rng), capacity=capacity)
    g.validate()
    return g


def build_split_join(
    rng: random.Random,
    *,
    branches: int = 4,
    stages: int = 2,
    fork_prob: float = 0.5,
) -> ApplicationGraph:
    """Sobel4-style: src → split → per-branch filter pipelines → join.

    Each branch stage is either a plain filter or (with ``fork_prob``) a
    fork through a multi-cast actor into a gx/gy pair merged by a combiner.
    """
    branches = max(2, branches)
    stages = max(1, stages)
    g = ApplicationGraph(f"sjoin_b{branches}_s{stages}")
    g.add_actor("src", _work(rng))
    g.add_actor("split", _work(rng, 2, 10))
    g.add_actor("join", _work(rng, 2, 10))
    g.add_channel("c_src", "src", "split", token_bytes=_tok(rng))
    for b in range(branches):
        for s in range(stages):
            name = f"b{b}_s{s}"
            if rng.random() < fork_prob:
                # fork stage: pre → mc → {gx, gy} → comb (named `name`_out)
                pre, mc, gx, gy, comb = (
                    f"{name}_pre", f"{name}_mc", f"{name}_gx", f"{name}_gy", f"{name}_out",
                )
                tok = _tok(rng)
                g.add_actor(pre, _work(rng))
                g.add_actor(mc, _work(rng, 2, 8), multicast=True)
                g.add_actor(gx, _work(rng))
                g.add_actor(gy, _work(rng))
                g.add_actor(comb, _work(rng))
                src_actor = "split" if s == 0 else f"b{b}_s{s - 1}_out"
                g.add_channel(f"c_{pre}", src_actor, pre, token_bytes=_tok(rng))
                g.add_channel(f"c_{mc}_in", pre, mc, token_bytes=tok)
                g.add_channel(f"c_{mc}_gx", mc, gx, token_bytes=tok)
                g.add_channel(f"c_{mc}_gy", mc, gy, token_bytes=tok)
                g.add_channel(f"c_{gx}_out", gx, comb, token_bytes=_tok(rng))
                g.add_channel(f"c_{gy}_out", gy, comb, token_bytes=_tok(rng))
            else:
                g.add_actor(f"{name}_out", _work(rng))
                src_actor = "split" if s == 0 else f"b{b}_s{s - 1}_out"
                g.add_channel(f"c_{name}", src_actor, f"{name}_out", token_bytes=_tok(rng))
        g.add_channel(f"c_b{b}_join", f"b{b}_s{stages - 1}_out", "join", token_bytes=_tok(rng))
    g.validate()
    return g


def build_stencil_chain(
    rng: random.Random,
    *,
    length: int = 3,
    taps: int = 2,
) -> ApplicationGraph:
    """Sobel-like stages in series: each stage forks (via a multi-cast
    actor) into ``taps`` stencil operators merged by a combiner."""
    length = max(1, length)
    taps = max(2, taps)
    g = ApplicationGraph(f"stencil_l{length}_t{taps}")
    g.add_actor("src", _work(rng))
    prev = "src"
    for s in range(length):
        mc, comb = f"s{s}_mc", f"s{s}_comb"
        tok = _tok(rng)
        g.add_actor(mc, _work(rng, 2, 8), multicast=True)
        g.add_actor(comb, _work(rng))
        g.add_channel(f"c_s{s}_in", prev, mc, token_bytes=tok)
        for k in range(taps):
            op = f"s{s}_op{k}"
            g.add_actor(op, _work(rng))
            g.add_channel(f"c_s{s}_op{k}_in", mc, op, token_bytes=tok)
            g.add_channel(f"c_s{s}_op{k}_out", op, comb, token_bytes=_tok(rng))
        prev = comb
    g.add_actor("sink", _work(rng, 2, 8))
    g.add_channel("c_sink", prev, "sink", token_bytes=_tok(rng))
    g.validate()
    return g


def build_camera_pipeline(
    rng: random.Random,
    *,
    cameras: int = 2,
    chain: int = 4,
    tap_every: int = 2,
    tap_width: int = 2,
) -> ApplicationGraph:
    """Multicamera-style rig: per camera a filter chain whose every
    ``tap_every``-th stage is a multi-cast actor tapping ``tap_width``
    streams out to a shared collector; camera outputs merge at a join."""
    cameras = max(1, cameras)
    chain = max(2, chain)
    tap_every = max(1, tap_every)
    tap_width = max(1, tap_width)
    g = ApplicationGraph(f"camera_c{cameras}_n{chain}")
    g.add_actor("collector", _work(rng, 2, 10))
    g.add_actor("csink", _work(rng, 2, 8))
    g.add_actor("join", _work(rng, 2, 10))
    for cam in range(cameras):
        src = f"cam{cam}_src"
        g.add_actor(src, _work(rng))
        prev = src
        for s in range(chain):
            is_tap = (s % tap_every) == (tap_every - 1)
            name = f"cam{cam}_m{s}" if is_tap else f"cam{cam}_f{s}"
            tok = _tok(rng)
            if is_tap:
                g.add_actor(name, _work(rng, 2, 8), multicast=True)
                g.add_channel(f"c_{name}_in", prev, name, token_bytes=tok)
                # continue-out plus taps (all mc outputs: δ=0, equal φ and γ)
                cont = f"cam{cam}_k{s}"
                g.add_actor(cont, _work(rng))
                g.add_channel(f"c_{name}_cont", name, cont, token_bytes=tok)
                for t in range(tap_width):
                    g.add_channel(f"tap_{name}_{t}", name, "collector", token_bytes=tok)
                prev = cont
            else:
                g.add_actor(name, _work(rng))
                g.add_channel(f"c_{name}_in", prev, name, token_bytes=tok)
                prev = name
        g.add_channel(f"c_cam{cam}_out", prev, "join", token_bytes=_tok(rng))
    g.add_channel("c_col", "collector", "csink", token_bytes=_tok(rng))
    g.validate()
    return g


def build_random_dag(
    rng: random.Random,
    *,
    n_actors: int = 10,
    width: int = 3,
    edge_prob: float = 0.5,
    multicast_density: float = 0.4,
) -> ApplicationGraph:
    """Layered random DAG with tunable multicast density.

    Actors are arranged in layers of ≤ ``width``; each actor reads from ≥ 1
    earlier actor and with probability ``edge_prob`` gains extra inputs.
    An actor whose fan-out is ≥ 2 is, with probability ``multicast_density``,
    routed through an inserted multi-cast copy actor (one input channel,
    equal-φ δ=0 outputs) instead of per-consumer private channels.
    """
    n_actors = max(2, n_actors)
    width = max(1, width)
    g = ApplicationGraph(f"rdag_n{n_actors}_w{width}")
    layers: List[List[str]] = []
    i = 0
    while i < n_actors:
        take = min(n_actors - i, rng.randint(1, width))
        layers.append([f"a{j}" for j in range(i, i + take)])
        i += take
    for layer in layers:
        for a in layer:
            g.add_actor(a, _work(rng))
    # Choose each non-first-layer actor's producers among earlier actors.
    fanout: Dict[str, List[str]] = {a: [] for layer in layers for a in layer}
    for li in range(1, len(layers)):
        earlier = [a for layer in layers[:li] for a in layer]
        for a in layers[li]:
            srcs = {rng.choice(earlier)}
            for b in earlier:
                if b not in srcs and rng.random() < edge_prob / max(1, len(earlier)):
                    srcs.add(b)
            for b in sorted(srcs):
                fanout[b].append(a)
    ci = 0
    for b in sorted(fanout):
        outs = fanout[b]
        if not outs:
            continue
        if len(outs) >= 2 and rng.random() < multicast_density:
            tok = _tok(rng)
            mc = f"mc_{b}"
            g.add_actor(mc, _work(rng, 2, 8), multicast=True)
            g.add_channel(f"c{ci}_in", b, mc, token_bytes=tok)
            ci += 1
            for a in outs:
                g.add_channel(f"c{ci}", mc, a, token_bytes=tok)
                ci += 1
        else:
            for a in outs:
                g.add_channel(f"c{ci}", b, a, token_bytes=_tok(rng))
                ci += 1
    g.validate()
    return g


FAMILIES: Dict[str, Callable[..., ApplicationGraph]] = {
    "multicast_tree": build_multicast_tree,
    "split_join": build_split_join,
    "stencil_chain": build_stencil_chain,
    "camera_pipeline": build_camera_pipeline,
    "random_dag": build_random_dag,
}


def harmonize_graph(g: ApplicationGraph) -> ApplicationGraph:
    """Quantize a graph onto the harmonic-period tier (in place).

    Every execution time is rounded up to the next power of two and every
    token shrunk to the smallest byte class, so feasible periods cluster on
    a few harmonically related values and exact decoders (branch-and-bound,
    CP-SAT) can close their search quickly.  Multicast structure (Eqs. 1-3)
    is preserved: all token sizes stay equal by construction.  Available as
    the ``harmonic: true`` param on every family (``AppSpec.make(family,
    seed, harmonic=True)``) — off by default, so existing seeds and golden
    values are untouched."""
    for a in g.actors.values():
        a.exec_times = {
            ctype: 1 << max(0, (t - 1).bit_length()) for ctype, t in a.exec_times.items()
        }
    for ch in g.channels.values():
        ch.token_bytes = TOKEN_CLASSES[0]
    return g


def build(family: str, seed: int, params: Optional[Dict] = None) -> ApplicationGraph:
    """Deterministically build one application graph of ``family``.

    The cross-family param ``harmonic`` (default False) is popped before
    dispatch and post-processes the graph via :func:`harmonize_graph` —
    the RNG draws are identical either way, so the harmonic variant of a
    seed has the same topology as the standard one."""
    if family not in FAMILIES:
        raise KeyError(f"unknown scenario family {family!r}; known: {sorted(FAMILIES)}")
    p = dict(params or {})
    harmonic = bool(p.pop("harmonic", False))
    # String seeds hash deterministically (tuple seeds go through the
    # process-salted hash() and would differ between runs).
    rng = random.Random(f"app:{family}:{seed}")
    g = FAMILIES[family](rng, **p)
    if harmonic:
        harmonize_graph(g)
    g.validate()
    multicast_actors(g)  # raises if any flagged actor violates Eqs. (1)-(3)
    return g
