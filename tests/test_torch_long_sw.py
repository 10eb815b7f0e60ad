"""The prefilter's long route (``ops/long_sw.py``), on the CPU.

Its plain version scores each sequence with the roles swapped (the sequence
down the rows, the query along the columns) and is held to the wavefront
kernel's plain version in K1's orientation (``wave_sw.sw_wave_plain``),
linear and affine, at the edges of a band (31/32/33 rows), of a pass (4,096
rows +- 1), at 993 and 8,000 residues, for a query longer than the
sequences, on random pairs, and under an asymmetric matrix.  The test's own
step-by-step run of the kernel's schedule (``csrc/sw_long.cu``: 128 bands of
32 rows a pass, a shuffle a step within a warp, the ring between warps read
only across the block's CHUNK-step barriers, the global carry between
passes, -128 below a sequence's end) gives the plain version's scores.
"""

import numpy as np
import pytest
import torch

from swtpu_torch.alphabet import ALPHABET_SIZE
from swtpu_torch.matrices import blosum50_ref
from swtpu_torch.ops import long_sw, wave_sw
from swtpu_torch.ops.profile import PAD_SUBJECT, make_profile

GAPS = {"linear": dict(gap=2), "affine": dict(gap_open=10, gap_extend=2)}


def _database(rng, lens):
    seqs = [rng.integers(0, ALPHABET_SIZE, int(n)).astype(np.int8) for n in lens]
    flat = torch.from_numpy(np.concatenate(seqs)) if seqs else torch.zeros(0, dtype=torch.int8)
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]).astype(np.int64))
    return seqs, flat, offsets


def _k1_orientation(query, seqs, matrix, kw):
    """sw_wave_plain's scores: the query down the rows, one sequence a lane."""
    prof = torch.from_numpy(make_profile(query, matrix, pad_rows_to=wave_sw.W))
    width = max([len(s) for s in seqs] + [1])
    stack = np.full((width + wave_sw.W, len(seqs)), PAD_SUBJECT, dtype=np.int8)
    for i, s in enumerate(seqs):
        stack[: len(s), i] = s
    return wave_sw.sw_wave_plain(prof, torch.from_numpy(stack), **kw)


def _long(query, flat, offsets, matrix, kw, ids=None):
    ids = torch.arange(offsets.shape[0] - 1, dtype=torch.int64) if ids is None else ids
    table = torch.from_numpy(long_sw.matrix_table(matrix))
    return long_sw.sw_long(torch.from_numpy(query), flat, offsets, ids, table, **kw)


@pytest.mark.parametrize("gaps", GAPS, ids=list(GAPS))
@pytest.mark.parametrize(
    "qlen,lens",
    [(45, (0, 1, 31, 32, 33, 993, 4095, 4096, 4097, 8000)), (1500, (1, 33, 300, 993, 1100))],
    ids=["edges", "query-longer"],
)
def test_plain_equals_wave_plain(gaps, qlen, lens):
    rng = np.random.default_rng(qlen)
    seqs, flat, offsets = _database(rng, lens)
    query = rng.integers(0, ALPHABET_SIZE, qlen).astype(np.int8)
    want = _k1_orientation(query, seqs, blosum50_ref(), GAPS[gaps])
    assert torch.equal(_long(query, flat, offsets, blosum50_ref(), GAPS[gaps]), want)


@pytest.mark.parametrize("gaps", GAPS, ids=list(GAPS))
def test_plain_equals_wave_plain_on_random_pairs(gaps):
    """Random pairs, ids in any order and repeated; a homolog planted in
    every third sequence, so that the scores are not all noise."""
    rng = np.random.default_rng(7)
    query = rng.integers(0, ALPHABET_SIZE, int(rng.integers(1, 400))).astype(np.int8)
    lens = rng.integers(1, 1500, 24)
    seqs, _, _ = _database(rng, lens)
    for i in range(0, len(seqs), 3):
        cut = query[: min(len(query), len(seqs[i]))]
        seqs[i][: len(cut)] = np.where(rng.random(len(cut)) < 0.3, seqs[i][: len(cut)], cut)
    flat = torch.from_numpy(np.concatenate(seqs))
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]).astype(np.int64))
    ids = torch.from_numpy(rng.integers(0, len(seqs), 30).astype(np.int64))
    want = _k1_orientation(query, seqs, blosum50_ref(), GAPS[gaps])[ids]
    got = _long(query, flat, offsets, blosum50_ref(), GAPS[gaps], ids)
    assert torch.equal(got, want) and int(got.max()) > 100


@pytest.mark.parametrize("gaps", GAPS, ids=list(GAPS))
def test_plain_needs_no_symmetric_matrix(gaps):
    """The cell (row r, column c) reads matrix[query[c]][sequence[r]]: an
    asymmetric matrix scores as in K1's orientation."""
    rng = np.random.default_rng(11)
    matrix = rng.integers(-6, 9, (ALPHABET_SIZE, ALPHABET_SIZE)).astype(np.int32)
    assert not np.array_equal(matrix, matrix.T)
    seqs, flat, offsets = _database(rng, (5, 64, 200, 1000))
    query = rng.integers(0, ALPHABET_SIZE, 150).astype(np.int8)
    assert torch.equal(_long(query, flat, offsets, matrix, GAPS[gaps]),
                       _k1_orientation(query, seqs, matrix, GAPS[gaps]))


# --- the kernel's schedule, step by step ---------------------------------------------------

NL, RB, LBLOCK, CHUNK = ALPHABET_SIZE, 32, 128, 16  # csrc/sw_long.cu
LAG, RING, WARPS = CHUNK + 31, 2 * CHUNK, LBLOCK // 32


def _band_column(h, e, s, diag, up, fup, gap, ext, affine):
    """csrc/sw_long.cu's band_column on the (k, 32) rows of k threads."""
    best = h.max(axis=1) * 0
    if affine:
        f = np.maximum(fup - ext, up - gap)
        xo = None
        for r in range(RB):
            left = h[:, r].copy()
            e[:, r] = np.maximum(e[:, r] - ext, left - gap)
            x = np.maximum(np.maximum(diag + s[:, r], e[:, r]), 0)
            if r:
                f = np.maximum(f - ext, xo)
            xo = x - gap
            diag = left
            h[:, r] = np.maximum(x, f)
            best = np.maximum(best, h[:, r])
        return f, best
    for r in range(RB):
        left = h[:, r].copy()
        x = np.maximum(np.maximum(diag + s[:, r], left - gap), 0)
        up = np.maximum(up - gap, x)
        diag = left
        h[:, r] = up
        best = np.maximum(best, up)
    return np.zeros_like(up), best


def _schedule_one(query, seq, table, gap, ext, affine):
    """One block's run: every thread's step in the kernel's order."""
    m, n = len(query), len(seq)
    neg = wave_sw.NEG
    b = np.arange(LBLOCK)
    lane, warp = b % 32, b // 32
    lag = lane + warp * LAG
    carry = np.zeros((max(m, 1), 2), dtype=np.int64)
    ring = np.zeros((WARPS - 1, RING, 2), dtype=np.int64)
    best = np.zeros(LBLOCK, dtype=np.int64)
    letters = np.minimum(query.astype(np.int64) & 255, NL - 1)
    n_pass = -(-n // (LBLOCK * RB))
    for p in range(n_pass):
        nb = min(LBLOCK, -(-(n - p * LBLOCK * RB) // RB))
        active_warps = -(-nb // 32)
        rows = p * LBLOCK * RB + b[:, None] * RB + np.arange(RB)[None, :]  # (128, 32)
        res = np.where(rows < n, seq[np.minimum(rows, n - 1)].astype(np.int64) & 31, -1)
        tab = np.where(res[:, None, :] >= 0, table[:, np.maximum(res, 0)].transpose(1, 0, 2), -128)  # (128, NL, 32)
        last = nb - 1
        steps = m + last % 32 + (last // 32) * LAG
        h = np.zeros((LBLOCK, RB), dtype=np.int64)
        e = np.full((LBLOCK, RB), neg, dtype=np.int64)
        top_prev = np.zeros(LBLOCK, dtype=np.int64)
        send_h = np.zeros(LBLOCK, dtype=np.int64)
        send_f = np.full(LBLOCK, neg, dtype=np.int64)
        for t0 in range(0, steps, CHUNK):
            pending, read = {}, set()  # ring slots written (visible after the barrier) and read in this chunk
            for t in range(t0, t0 + CHUNK):
                r_h = np.where(lane > 0, np.roll(send_h, 1), send_h)  # shfl.up by 1 within each warp
                r_f = np.where(lane > 0, np.roll(send_f, 1), send_f)
                c = t - lag
                act = (b < nb) & (c >= 0) & (c < m) & (warp < active_warps)
                if not act.any():
                    continue
                if act[0]:
                    r_h[0], r_f[0] = carry[c[0]] if p > 0 else (0, neg)
                for w in range(1, active_warps):
                    i = 32 * w
                    if act[i]:
                        slot = (w - 1, c[i] % RING)
                        read.add(slot)
                        r_h[i], r_f[i] = ring[slot]
                idx = np.nonzero(act)[0]
                s = tab[idx, letters[c[idx]], :]
                hh, ee = h[idx], e[idx]
                f, col_best = _band_column(hh, ee, s, top_prev[idx], r_h[idx], r_f[idx], gap, ext, affine)
                h[idx], e[idx] = hh, ee
                best[idx] = np.maximum(best[idx], col_best)
                top_prev[idx] = r_h[idx]
                send_h[idx], send_f[idx] = hh[:, RB - 1], f
                for j, i in enumerate(idx):
                    bottom = (hh[j, RB - 1], f[j])
                    if lane[i] == 31 and warp[i] + 1 < active_warps:
                        pending[(warp[i], c[i] % RING)] = bottom
                    if i == last and p + 1 < n_pass:
                        carry[c[i]] = bottom
            assert not read & pending.keys(), "a ring slot read and written between two barriers"
            for slot, v in pending.items():
                ring[slot] = v
    return int(best.max())


@pytest.mark.parametrize("gaps", GAPS, ids=list(GAPS))
def test_kernel_schedule_equals_plain(gaps):
    """Lengths at a band's, a warp's and a pass's edges (one band, one warp,
    one to four warps, two passes with a one-band second), queries of one
    residue and of a few dozen."""
    rng = np.random.default_rng(3)
    lens = (1, 33, 1000, 1025, 4096, 4097)
    seqs, flat, offsets = _database(rng, lens)
    table = long_sw.matrix_table(blosum50_ref()).astype(np.int64)
    kw = GAPS[gaps]
    gap, ext = (kw["gap"], 0) if gaps == "linear" else (kw["gap_open"], kw["gap_extend"])
    for qlen in (1, 23):
        query = rng.integers(0, ALPHABET_SIZE, qlen).astype(np.int8)
        query[: qlen // 2] = seqs[4][100 : 100 + qlen // 2]  # a shared stretch: scores above the noise
        want = _long(query, flat, offsets, blosum50_ref(), kw)
        got = [_schedule_one(query, s, table, gap, ext, gaps == "affine") for s in seqs]
        assert got == want.tolist()


def test_wrapper_checks_its_inputs():
    rng = np.random.default_rng(0)
    _, flat, offsets = _database(rng, (40, 50))
    query = torch.from_numpy(rng.integers(0, ALPHABET_SIZE, 10).astype(np.int8))
    ids = torch.tensor([1, 0])
    table = torch.from_numpy(long_sw.matrix_table(blosum50_ref()))
    with pytest.raises(ValueError, match="ids"):
        long_sw.sw_long(query, flat, offsets, ids.int(), table, gap=2)
    with pytest.raises(ValueError, match="table"):
        long_sw.sw_long(query, flat, offsets, ids, table[:, :25].contiguous(), gap=2)
    with pytest.raises(ValueError, match="query"):
        long_sw.sw_long(query.long(), flat, offsets, ids, table, gap=2)
    with pytest.raises(ValueError, match="gap_open"):
        long_sw.sw_long(query, flat, offsets, ids, table, gap_open=2, gap_extend=3)
    assert long_sw.sw_long(query, flat, offsets, ids[:0], table, gap=2).shape == (0,)
    assert torch.equal(long_sw.sw_long(query[:0], flat, offsets, ids, table, gap=2), torch.zeros(2, dtype=torch.int32))
    assert np.array_equal(long_sw.matrix_table(blosum50_ref()), make_profile(np.arange(ALPHABET_SIZE), blosum50_ref()))
