"""The plain reference against a brute-force Smith-Waterman, its hit order,
its E-value arithmetic, and its lower-precision control.

Run with ``python -m pytest benchmark/tests -q`` from the checkout's root.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(BENCH))

from reference import hits, scoring, sw  # noqa: E402

M = scoring.blosum50_ref()
GAPS = [{"gap": 2}, {"gap": 5}, {"gap_open": 10, "gap_extend": 2}, {"gap_open": 3, "gap_extend": 1}, {"gap_open": 4, "gap_extend": 4}]


def brute(q, s, gaps):
    """Gotoh's recurrence cell by cell; a linear gap g is open = extend = g."""
    o = gaps.get("gap_open", gaps.get("gap"))
    e = gaps.get("gap_extend", gaps.get("gap"))
    n, m = len(q), len(s)
    H = np.zeros((n + 1, m + 1), np.int64)
    E = np.full((n + 1, m + 1), -(10**9))
    F = np.full((n + 1, m + 1), -(10**9))
    best = 0
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            E[i, j] = max(H[i, j - 1] - o, E[i, j - 1] - e)
            F[i, j] = max(H[i - 1, j] - o, F[i - 1, j] - e)
            H[i, j] = max(0, H[i - 1, j - 1] + M[q[i - 1], s[j - 1]], E[i, j], F[i, j])
            best = max(best, H[i, j])
    return int(best)


def flat(subs):
    off = np.zeros(len(subs) + 1, np.int64)
    np.cumsum([len(s) for s in subs], out=off[1:])
    return np.concatenate(subs).astype(np.int8), off


@pytest.mark.parametrize("gaps", GAPS, ids=lambda g: "-".join(f"{k}{v}" for k, v in g.items()))
@pytest.mark.parametrize("trial", range(3))
def test_reference_equals_brute_force(gaps, trial):
    rng = np.random.default_rng(100 + trial)
    subs = [rng.integers(0, 25, int(rng.integers(0, 28))).astype(np.int8) for _ in range(20)]
    q = rng.integers(0, 25, int(rng.integers(1, 22))).astype(np.int8)
    subs[2] = q.copy()  # an exact copy
    subs[5] = np.zeros(0, np.int8)  # an empty record
    res, off = flat(subs)
    want = np.array([brute(q, s, gaps) for s in subs])
    ids = np.arange(len(subs))
    # one subject a tile, and all in one; in file order and reversed
    for ratio, cells in ((1.0, 1), (1e9, 1 << 30)):
        assert np.array_equal(sw.best_scores(q, res, off, ids, M, gaps, ratio=ratio, max_cells=cells), want)
    assert np.array_equal(sw.best_scores(q, res, off, ids[::-1], M, gaps)[::-1], want)


@pytest.mark.parametrize("gaps", GAPS[1:3], ids=lambda g: "-".join(f"{k}{v}" for k, v in g.items()))
def test_queries_scored_together_score_as_alone(gaps):
    """Queries of lengths 1 to 60 share tiles, each against its own
    subjects (an empty query and an empty id list among them): every score
    is the one the query gets alone, in one group or one a query."""
    rng = np.random.default_rng(7)
    subs = [rng.integers(0, 25, int(rng.integers(0, 70))).astype(np.int8) for _ in range(40)]
    res, off = flat(subs)
    qs = [rng.integers(0, 25, n).astype(np.int8) for n in (1, 60, 7, 0, 33, 12, 59)]
    ids = [rng.choice(40, int(rng.integers(1, 15)), replace=False) for _ in qs]
    ids[5] = np.zeros(0, np.int64)
    want = [sw.best_scores(q, res, off, i, M, gaps) for q, i in zip(qs, ids)]
    for query_ratio, ratio in ((1.0, 1.3), (1e9, 1.3), (2.0, 1e9)):
        got = sw.best_scores_many(qs, ids, res, off, M, gaps, ratio=ratio, query_ratio=query_ratio)
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
    assert sw.best_scores(qs[1], res, off, [0, 1, 2], M, gaps).tolist() == [brute(qs[1], subs[i], gaps) for i in range(3)]


def test_int16_control_saturates_where_int32_does_not():
    q = np.full(2300, scoring.ALPHABET.index("W"), np.int8)  # W/W scores 15: a self-alignment of 34,500
    res, off = flat([q, q[:100], np.arange(25, dtype=np.int8)])
    exact = sw.best_scores(q, res, off, np.arange(3), M, {"gap": 2})
    low = sw.best_scores(q, res, off, np.arange(3), M, {"gap": 2}, precision="int16")
    assert exact[0] == 15 * 2300 and low[0] == 32767
    assert np.array_equal(exact[1:], low[1:])


def test_tiles_bound_width_ratio_and_cells():
    lengths = np.array([5, 100, 6, 7, 130, 8, 0, 2000])
    parts = sw.tiles(lengths, ratio=1.3, max_cells=20)
    assert sorted(np.concatenate(parts).tolist()) == list(range(lengths.size))
    for p in parts:
        ls = lengths[p]
        assert ls.max() <= 1.3 * max(ls.min(), 1) or p.size == 1
        assert p.size * ls.max() <= 20 or p.size == 1


def test_hit_order_is_score_desc_then_id_asc():
    scores = np.array([5, 9, 9, 1, 9, 7, 0])
    assert hits.top_hits(scores, 4) == [(1, 9), (2, 9), (4, 9), (5, 7)]
    assert hits.top_hits(scores, 20)[-1] == (6, 0)


def _null_case(seed=3, n=20000):
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.lognormal(5.67, 0.62, n), 20, 8000).astype(np.int64)
    lengths[5] = 0
    scores = (rng.gumbel(40, 8, n) * np.log(lengths + 1) / 5.6).astype(np.int64).clip(0)
    scores[5], scores[7] = 0, 3000
    return scores, lengths


def test_evalues_equal_the_programs_stated_arithmetic():
    """The frozen float64 copy gives the port's own full-array E-values bit
    for bit (swtpu_torch.stats, imported by this test only)."""
    sys.path.insert(0, str(BENCH.parent))
    from swtpu_torch import stats as st

    scores, lengths = _null_case()
    top = hits.top_hits(scores, 10)
    want = st.hit_stats(scores, top, 300, lengths.sum() / lengths.size, lengths=lengths)
    got = hits.evalues(scores, lengths, 300, top)
    assert [(w.evalue, w.bits) for w in want] == got


def test_float32_control_moves_the_evalues():
    scores, lengths = _null_case()
    top = hits.top_hits(scores, 10)
    exact = hits.evalues(scores, lengths, 300, top)
    low = hits.evalues(scores, lengths, 300, top, np.float32)
    rel = [abs(a[0] - b[0]) / max(abs(b[0]), 1e-300) for a, b in zip(low, exact)]
    assert rel[0] == 1.0  # the planted 3,000: its E-value underflows in float32
    assert max(rel[1:]) > 1e-6
