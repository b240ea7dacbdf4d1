"""The frozen reference against schedules and rankings worked out by hand."""
import numpy as np
import pytest

from portbench.reference import model as M
from portbench.reference import decode as D
from portbench.reference import ranking as RK
from portbench.reference import sim as S

# Sobel (paper §VI): read → grayscale → fork → {Gx, Gy} → magnitude → display,
# work w on the one core type t3 (τ = w), token sizes as in the paper's Table 1.
W = {"src": 2000, "gray": 6000, "mc": 3000, "gx": 12000, "gy": 12000, "mag": 8000, "sink": 1000}
CHANNELS = [("c_src", "src", "gray", 6_177_000), ("c_gray", "gray", "mc", 16_588_800),
            ("c_gx_in", "mc", "gx", 16_588_800), ("c_gy_in", "mc", "gy", 16_588_800),
            ("c_gx_out", "gx", "mag", 8_294_400), ("c_gy_out", "gy", "mag", 8_294_400),
            ("c_mag", "mag", "sink", 2_073_600)]
# One core with memories large enough that every channel stays core-local:
# no transfer crosses an interconnect, so every read and write takes 0.
ONE_CORE = {"name": "one", "tiles": [{"name": "T1", "core_types": ["t3"]}],
            "core_local_bytes": 1 << 40, "tile_local_bytes": 1 << 40, "global_bytes": 1 << 60,
            "crossbar_bytes_per_unit": 8589.934592, "noc_bytes_per_unit": 4294.967296,
            "core_costs": {"t3": 0.5}}


def sobel():
    return M.graph_from_config({"name": "Sobel", "actors": [
        {"name": a, "exec_times": {"t3": w}, "multicast": a == "mc"} for a, w in W.items()],
        "channels": [dict(name=n, src=s, dsts=[d], token_bytes=b) for n, s, d, b in CHANNELS]})


@pytest.fixture
def decoded():
    g, arch = sobel(), M.arch_from_config(ONE_CORE)
    dec = D.RelaxedDecode(g, arch, (1,), pipelined=True)
    genes = np.zeros((1, dec.layout.n_genes), np.int64)
    genes[0, 0] = 1                      # ξ(mc) = 1; every C_d gene PROD, β_A the one core
    return g, dec, dec.decode(genes)


def simulate(dec, out, K):
    return S.simulate(dec.kind, dec.chan, dec.slot, dec.n_tasks, dec.nread, dec.delay,
                      out["dur"], out["route"], out["core"], out["gamma"], K)


def test_mrb_substitution_by_hand():
    gt = M.transformed(sobel(), {"mc": 1}, pipelined=True)
    mrb = gt.channels["mrb{c_gray,c_gx_in,c_gy_in}"]
    assert (mrb.src, mrb.dsts, mrb.capacity, mrb.delay, mrb.token_bytes) == (
        "gray", ["gx", "gy"], 2, 1, 16_588_800)
    assert list(gt.channels) == ["c_src", "c_gx_out", "c_gy_out", "c_mag",
                                 "mrb{c_gray,c_gx_in,c_gy_in}"]
    assert all(c.delay == 1 for c in gt.channels.values())
    # No zero-delay edge is left, so arbitration is by name.
    assert M.arbitration_order(gt) == ["gray", "gx", "gy", "mag", "sink", "src"]


def test_decode_by_hand(decoded):
    _, dec, out = decoded
    # γ̂ = γ: every read ends (at 0, first in its window) before its channel's
    # write starts, so ⌊(F − s_w)/P_lb⌋ + δ + 1 ≤ 1.
    assert out["gamma"].tolist() == [[1, 1, 1, 1, 2]]
    # M_F = φ(c_src) + 2·φ(MRB) + φ(c_gx_out) + φ(c_gy_out) + φ(c_mag).
    assert out["memory"].tolist() == [6_177_000 + 2 * 16_588_800 + 2 * 8_294_400 + 2_073_600]
    assert out["core_cost"].tolist() == [0.5]
    # P_lb is the one core's load: Σ τ over the six actors left.
    assert out["period"].tolist() == [41_000]
    assert out["dur"][0].tolist() == [[0, 6000, 0, 0], [0, 12000, 0, 0], [0, 12000, 0, 0],
                                      [0, 0, 8000, 0], [0, 1000, 0, 0], [2000, 0, 0, 0]]


def test_sobel_schedule_by_hand(decoded):
    """Two firings per actor on one core.  At each instant the first enabled
    actor in name order takes the core: gray (0), sink (6000: c_mag's initial
    token), mag (7000), gx (15000), gy (27000), sink (39000), mag (40000),
    gx (48000), gy (60000); src runs only once both views of the MRB are
    drained (72000), then gray (74000) and src (80000); the last window ends
    at 82000."""
    _, dec, out = decoded
    fire, dead, end = simulate(dec, out, 2)
    assert not dead[0] and end.tolist() == [82_000]
    assert fire[0].tolist() == [[0, 74_000], [15_000, 48_000], [27_000, 60_000],
                                [7_000, 40_000], [6_000, 39_000], [72_000, 80_000]]


def test_single_core_period_is_its_load(decoded):
    """Self-timed on one busy core, an iteration takes the sum of the six
    windows."""
    _, dec, out = decoded
    fire, dead, _ = simulate(dec, out, 16)
    assert S.period(fire, dead, 16).tolist() == [41_000.0]


def test_period_by_hand():
    K = 16
    steps = np.array([1, 2] * 8)                       # D = 3 over R = 2 firings
    ts = np.concatenate([[0], np.cumsum(steps)[:K - 1]])
    thirds = np.concatenate([[0], np.cumsum(np.array([1, 1, 2] * 6))[:K - 1]])  # D = 4, R = 3
    fire = np.stack([ts, thirds])[None].astype(np.int32)
    dead = np.array([False])
    assert S.period(fire[:, :1], dead, K).tolist() == [1.5]
    assert S.period(fire[:, 1:], dead, K).tolist() == [4 / 3]
    assert S.period(fire, dead, K).tolist() == [1.5]          # the slowest actor
    # The control divides in float32: 4/3 comes out another float64 value.
    third32 = S.period(fire[:, 1:], dead, K, np.float32).tolist()
    assert third32 == [float(np.float32(4) / np.float32(3))] and third32 != [4 / 3]
    assert S.period(fire, np.array([True]), K).tolist() == [np.inf]
    fire[0, 0, 3] = -5                                  # a wrapped firing time
    assert S.period(fire, dead, K).tolist() == [np.inf]


def test_ranking_by_hand():
    F = np.array([[1, 5], [2, 2], [5, 1], [3, 3], [4, 4], [2, 2]], float)
    r = RK.ranks(F)
    assert r.tolist() == [0, 0, 0, 1, 2, 0]
    c = RK.crowding(F, r)
    # Front 0 by objective 0 is rows 0, 1, 5, 2 (span 4), by objective 1 rows
    # 2, 1, 5, 0 (span 4): the ends get inf; row 1 adds (2 − 1)/4 twice, row 5
    # (5 − 2)/4 twice.
    assert c[[0, 2]].tolist() == [np.inf, np.inf]
    assert c[1] == 0.5 and c[5] == 1.5
    assert c[[3, 4]].tolist() == [np.inf, np.inf]        # one-row fronts
    # (rank, −crowding), ties by row: 0 and 2 (inf), 5 (1.5), 1 (0.5); then 3, 4.
    assert RK.survivors(F, 4).tolist() == [0, 2, 5, 1]
    assert RK.ranks(np.array([[np.inf, 1.0], [1.0, 2.0]])).tolist() == [0, 0]


def test_archive_fold_by_hand():
    """The archive so far and the survivors, folded: a point with no finite
    objective, a dominated point and a repeated vector are left out, the
    rest kept where first seen."""
    inf = np.inf
    before = np.array([[1.0, 5.0, 0.0], [3.0, 3.0, 0.0]])
    F = np.array([[2.0, 2.0, 0.0], [1.0, 5.0, 0.0], [4.0, 4.0, 0.0], [inf, inf, inf],
                  [0.5, inf, 0.0]])
    got = RK.archive(before, F)
    assert got.tolist() == [[1.0, 5.0, 0.0], [2.0, 2.0, 0.0], [0.5, inf, 0.0]]
    assert RK.archive(np.zeros((0, 3)), F[:1]).tolist() == [[2.0, 2.0, 0.0]]
