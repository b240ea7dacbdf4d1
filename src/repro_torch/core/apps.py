"""The three benchmark applications of paper §VI, Table 1.

The paper's applications come from unpublished Matlab/Simulink models [6];
we reconstruct generator graphs that match every published statistic:

    application   |A|  |C|  |A_M|   M_F [MiB]   M_F_min [MiB]
    Sobel           7    7     1       71.15         55.33
    Sobel_4        23   29     4       71.22         55.38
    Multicamera    62  111    23       50.47         32.15

(M_F = Σ φ(c) with γ(c) = 1 everywhere; M_F_min after replacing every
multi-cast actor by its MRB with γ = γ_in + γ_out = 2.)

Token sizes are full-HD image planes where derivable (1920×1080 f64 gray
= 15.8203 MiB, f32 gradient = 7.9102 MiB, u8 magnitude = 1.9775 MiB,
quarter-frame equivalents for Sobel_4) and fitted constants otherwise so
that the Table-1 sums reproduce to 2 decimals.  Execution times are not
published; we assign plausible per-actor work w (µs on the slowest core
type ϑ3) with the paper's speed ratios τ(ϑ1) = ⌈w/3⌉, τ(ϑ2) = ⌈w/2⌉.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

from .graph import ApplicationGraph

__all__ = ["sobel", "sobel4", "multicamera", "APPLICATIONS", "table1_row"]

MIB = 1 << 20

# Full-HD planes.
F64_FULL = 1920 * 1080 * 8      # 15.8203 MiB
F32_FULL = 1920 * 1080 * 4      # 7.9102 MiB
U8_FULL = 1920 * 1080           # 1.9775 MiB
RGB_FULL = 1920 * 1080 * 3      # 5.9326 MiB
# Quarter frames (960×540).
F64_Q = 960 * 540 * 8           # 3.9551 MiB
RGB_Q = 960 * 540 * 3           # 1.4832 MiB
U16_Q = 960 * 540 * 2           # 0.9888 MiB

# Fitted constants (see module docstring).
SOBEL_IN = 6_177_000            # 5.8908 MiB  -> M_F = 71.15
SOBEL4_MC = 4_152_360           # 3.9600 MiB  -> savings 15.84
SOBEL4_MJ = 1_028_823           # 0.9812 MiB  -> M_F = 71.22
MCAM_MC = 376_666               # 0.3592 MiB  -> savings 18.32
MCAM_W = int(1.4832 * MIB)      # within-chain free channels
MCAM_CO = U16_Q                 # chain -> fusion
MCAM_F = int(0.75 * MIB)        # fusion internal
# collector -> sink residual solved below in multicamera().


def _et(w: int) -> Dict[str, int]:
    """Core-type dependent execution times with the paper's 3×/2×/1× ratios."""
    return {"t1": max(1, math.ceil(w / 3)), "t2": max(1, math.ceil(w / 2)), "t3": w}


def sobel(pipelined: bool = False) -> ApplicationGraph:
    """Sobel edge detection: read → grayscale → fork → {Gx, Gy} → magnitude
    → display.  One multi-cast actor (the fork after grayscale)."""
    g = ApplicationGraph("Sobel")
    g.add_actor("src", _et(2000))
    g.add_actor("gray", _et(6000))
    g.add_actor("mc", _et(3000), multicast=True)
    g.add_actor("gx", _et(12000))
    g.add_actor("gy", _et(12000))
    g.add_actor("mag", _et(8000))
    g.add_actor("sink", _et(1000))
    d = 1 if pipelined else 0
    g.add_channel("c_src", "src", "gray", token_bytes=SOBEL_IN, delay=d)
    g.add_channel("c_gray", "gray", "mc", token_bytes=F64_FULL, delay=d)
    g.add_channel("c_gx_in", "mc", "gx", token_bytes=F64_FULL)
    g.add_channel("c_gy_in", "mc", "gy", token_bytes=F64_FULL)
    g.add_channel("c_gx_out", "gx", "mag", token_bytes=F32_FULL, delay=d)
    g.add_channel("c_gy_out", "gy", "mag", token_bytes=F32_FULL, delay=d)
    g.add_channel("c_mag", "mag", "sink", token_bytes=U8_FULL, delay=d)
    g.validate()
    return g


def sobel4(pipelined: bool = False) -> ApplicationGraph:
    """Sobel over four quarter-frame tiles processed in parallel:
    src → split → 4 × (gray → fork → {Gx, Gy} → magnitude) → join."""
    g = ApplicationGraph("Sobel4")
    d = 1 if pipelined else 0
    g.add_actor("src", _et(2000))
    g.add_actor("split", _et(1200))
    g.add_actor("join", _et(1600))
    g.add_channel("c_src", "src", "split", token_bytes=RGB_FULL, delay=d)
    for i in range(1, 5):
        g.add_actor(f"gray{i}", _et(1500))
        g.add_actor(f"mc{i}", _et(800), multicast=True)
        g.add_actor(f"gx{i}", _et(3000))
        g.add_actor(f"gy{i}", _et(3000))
        g.add_actor(f"mag{i}", _et(2000))
        g.add_channel(f"c_sg{i}", "split", f"gray{i}", token_bytes=RGB_Q, delay=d)
        g.add_channel(f"c_gm{i}", f"gray{i}", f"mc{i}", token_bytes=SOBEL4_MC, delay=d)
        g.add_channel(f"c_gx_in{i}", f"mc{i}", f"gx{i}", token_bytes=SOBEL4_MC)
        g.add_channel(f"c_gy_in{i}", f"mc{i}", f"gy{i}", token_bytes=SOBEL4_MC)
        g.add_channel(f"c_gx_out{i}", f"gx{i}", f"mag{i}", token_bytes=U16_Q, delay=d)
        g.add_channel(f"c_gy_out{i}", f"gy{i}", f"mag{i}", token_bytes=U16_Q, delay=d)
        g.add_channel(f"c_mj{i}", f"mag{i}", "join", token_bytes=SOBEL4_MJ, delay=d)
    g.validate()
    return g


def multicamera(pipelined: bool = False) -> ApplicationGraph:
    """Four-camera processing rig: per camera a 14-actor filter chain whose
    multi-cast actors tap intermediate results out to a shared collector
    (preview / analytics / archival streams), fused by a join tree.

    Chains 1-3 carry 6 multi-cast actors each, chain 4 carries 5 (23 total);
    the first five multi-cast actors of chain 1 drive one extra tap (4
    outputs instead of 3), reproducing |C| = 111 and the Table-1 footprints.
    """
    g = ApplicationGraph("Multicamera")
    d = 1 if pipelined else 0

    # Residual channel size so M_F = 50.47 MiB exactly (to rounding):
    # 97 mc-adjacent × MCAM_MC + 6×MCAM_W + 4×MCAM_CO + 3×MCAM_F + rest.
    target = round(50.47 * MIB)
    rest = target - (97 * MCAM_MC + 6 * MCAM_W + 4 * MCAM_CO + 3 * MCAM_F)

    g.add_actor("join1", _et(900))
    g.add_actor("join2", _et(900))
    g.add_actor("join3", _et(1100))
    g.add_actor("sink", _et(500))
    g.add_actor("collector", _et(700))
    g.add_actor("csink", _et(400))

    mc_total = 0
    for cam in range(1, 5):
        n_mc = 6 if cam <= 3 else 5
        src = f"cam{cam}_src"
        g.add_actor(src, _et(1000))
        prev = src
        # actor sequence: f1, m1, f2, m2, ..., then trailing filters to 14.
        seq = []
        for i in range(1, n_mc + 1):
            seq += [f"cam{cam}_f{i}", f"cam{cam}_m{i}"]
        for t in range(1, 14 - 1 - len(seq) + 1):
            seq.append(f"cam{cam}_t{t}")
        assert len(seq) == 13
        for name in seq:
            kind = name.split("_")[1][0]  # 'f' | 'm' | 't'
            prev_is_mc = g.actors[prev].multicast if prev in g.actors else False
            if kind == "m":
                mc_total += 1
                extra = 1 if (cam == 1 and mc_total <= 5) else 0
                g.add_actor(name, _et(300), multicast=True)
                # the mc's input channel (always φ_mc; never from another mc)
                g.add_channel(
                    f"ch_{prev}_{name}", prev, name, token_bytes=MCAM_MC, delay=d
                )
                # taps to the collector (2 regular, 3 for the special five);
                # mc output channels must keep δ = 0 (Eq. 3).
                for k in range(2 + extra):
                    g.add_channel(
                        f"tap_{name}_{k}", name, "collector", token_bytes=MCAM_MC
                    )
            else:
                g.add_actor(name, _et(1500))
                # continue-out of an mc keeps φ_mc and δ=0; otherwise a free
                # channel (src→f1, or between trailing filters).
                g.add_channel(
                    f"ch_{prev}_{name}",
                    prev,
                    name,
                    token_bytes=MCAM_MC if prev_is_mc else MCAM_W,
                    delay=0 if prev_is_mc else d,
                )
            prev = name
        jt = "join1" if cam <= 2 else "join2"
        g.add_channel(f"out_cam{cam}", prev, jt, token_bytes=MCAM_CO, delay=d)

    g.add_channel("f_j1", "join1", "join3", token_bytes=MCAM_F, delay=d)
    g.add_channel("f_j2", "join2", "join3", token_bytes=MCAM_F, delay=d)
    g.add_channel("f_j3", "join3", "sink", token_bytes=MCAM_F, delay=d)
    g.add_channel("f_col", "collector", "csink", token_bytes=rest, delay=d)
    g.validate()
    return g


def table1_row(g: ApplicationGraph) -> Dict[str, float]:
    """Compute the Table-1 statistics for an application graph."""
    from .graph import multicast_actors
    from .mrb import substitute_mrbs

    n_a = len(g.actors)
    n_c = len(g.channels)
    mcs = multicast_actors(g)
    mf = sum(ch.token_bytes for ch in g.channels.values()) / MIB  # γ=1
    gt = substitute_mrbs(g, {a: 1 for a in mcs})
    mf_min = sum(
        (2 if ch.is_mrb else 1) * ch.token_bytes for ch in gt.channels.values()
    ) / MIB
    return {
        "|A|": n_a,
        "|C|": n_c,
        "|A_M|": len(mcs),
        "M_F": round(mf, 2),
        "M_F_min": round(mf_min, 2),
    }


APPLICATIONS = {"Sobel": sobel, "Sobel4": sobel4, "Multicamera": multicamera}
