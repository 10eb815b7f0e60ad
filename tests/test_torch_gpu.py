"""CUDA kernel and engine on the card (marker ``gpu``).

These tests need an NVIDIA GPU with nvcc; elsewhere the ``cuda`` fixture
skips them.  The wavefront kernel (one query and a query axis, every
compiled (G, H) shape: the warp wavefront and the band sweep) is held
exactly to its plain PyTorch version on the same card, linear and affine,
its int16x2 route also on lanes past its int16 ceiling (the flags, the
int32 rescore and its count, the engine's ``rescored_lanes``) and beside
the int32 kernel, which hand-offs and wide gaps still run,
and the engine's single, batched, queued, streaming and top-K paths to the
committed goldens; align_top_k on the card gives the alignments it gives on
the CPU.  The row kernels K2 and K3 are held to their plain versions, and
the ``use_pallas`` engine (resident through K2, streamed through K3) to the
goldens; every compiled (G, H) shape of K2/K3 is held to the plain version
on one and several passes, odd widths and rows, and unaligned rows.  The
kernel's band-carry hand-off is held to its plain version slice
by slice (query_shard's band split), carry and scores, and the engine
launches K1 once a bucket with no hand-off, its scores the CPU engine's.  The
int8 kernels of K7 (coarse counts, the MAC-rate probe) and K8's chain are
held to their plain versions, and the prefiltered engine on the card to the
one on the CPU; the prefilter's long route (its kernel scoring each
sequence with the roles swapped) is held to its plain version at the
UniRef50 cell's shapes and on W-run pairs scoring past 32,767.  The wavefront lab kernels (K4's heights and blocks, K5's
prefetch depths, K6's stage switches, both on K1's band sweep) and K9's
int16 tiles and chains are held to their plain versions, the lab variants
that keep the DP to K1, and K5's copy of K1's sweep to K1's registers.
Every instantiation of the row-parallel lab kernel (K10: v2, v3, v4, v41) is
held to its plain version and to K2, at gap 2 and at a gap past JAX's int8
fold.  Every function of the card fuzz (``swtpu_torch.tools.card_fuzz``)
runs a few cases, and the CLI's ``--profile`` writes a trace whose device
events hold the wavefront kernel.  The CLI on a FASTA file runs on the card through the native host
runtime, and the streamed paths on natively packed buckets equal the
resident ones.  The lane-sharded and query-sharded engines on meshes that
name the card n times (and on distinct cards where there are several) equal
the single-device engine, and leave the thread's current device where it was;
so do the row path, the int16 mode, the prefilter and a streamed query-shard
database on such meshes, with K2 held to its plain version at the row-shard
shapes of a 3- and 4-way split; and a 2-process gloo fleet of the launcher,
both processes on the one card, prints the single-device top-K.
"""

import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from swtpu_torch import synth
from swtpu_torch.config import SWConfig
from swtpu_torch.io.fasta import Query, parse_database, parse_query
from swtpu_torch.matrices import blosum50_ref
from swtpu_torch.models.search import SearchEngine, SearchResult
from swtpu_torch.ops import (
    _build, bucket_sw, i16_probe, int8_mma, long_sw, row_sw, rows_lab, vpu_chain, wave_lab, wave_sw,
)
from swtpu_torch.ops.profile import PAD_SUBJECT, make_profile
from swtpu_torch.tools.card_fuzz import band_split

DATA = Path(__file__).resolve().parent / "data"
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bucket(rng, qlen, ws, S, B):
    prof = make_profile(rng.integers(0, 25, qlen).astype(np.int8), blosum50_ref(), pad_rows_to=32)
    stack = np.full((S * ws + 32, B), PAD_SUBJECT, dtype=np.int8)
    for k in range(B * S - 1):
        n = int(rng.integers(1, ws + 1))
        stack[(k % S) * ws : (k % S) * ws + n, k // S] = rng.integers(0, 25, n)
    return torch.from_numpy(prof), torch.from_numpy(stack)


@pytest.mark.parametrize(
    "qlen,ws,S,B",
    [(20, 32, 1, 64), (100, 200, 1, 130), (33, 48, 2, 77), (464, 96, 3, 1000), (64, 40, 8, 129), (300, 4100, 1, 65),
     (4548, 96, 1, 300), (300, 6, 8, 129), (464, 40, 8, 2600)],
)
def test_kernel_matches_plain(cuda, qlen, ws, S, B):
    prof, stack = _bucket(np.random.default_rng(qlen + S), qlen, ws, S, B)
    prof, stack = prof.to(cuda), stack.to(cuda)
    before = wave_sw.sw_wave.launches
    got = wave_sw.sw_wave(prof, stack, gap=2, n_segs=S)
    torch.cuda.synchronize()
    assert wave_sw.sw_wave.launches == before + 1
    want = wave_sw.sw_wave_plain(prof, stack, gap=2, n_segs=S)
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape", wave_sw.SHAPES, ids=[f"G{g}H{h}" for g, h in wave_sw.SHAPES])
@pytest.mark.parametrize("gaps", [None, (10, 2)], ids=["linear", "affine"])
def test_every_kernel_shape_matches_plain(cuda, shape, gaps):
    """Every compiled (G, H) forced with ``shape=``, whatever the wrapper
    would pick: 15 bands on chained segments, fused and as a hand-off chain
    of query_shard's slices (4, 4, 4, 3)."""
    rng = np.random.default_rng(sum(shape))
    prof, stack = _bucket(rng, 470, 40, 3, 99)
    prof, stack = prof.to(cuda), stack.to(cuda)
    kw = dict(n_segs=3, gap=2) if gaps is None else dict(n_segs=3, gap_open=gaps[0], gap_extend=gaps[1])
    assert torch.equal(wave_sw.sw_wave(prof, stack, shape=shape, **kw), wave_sw.sw_wave_plain(prof, stack, **kw))
    carry = wave_sw.virgin_carry(stack, gaps is not None)
    plain_carry, band = carry.clone(), 0
    for rung in band_split(prof.shape[0] // 32):
        part = prof[band * 32 : (band + rung) * 32]
        band += rung
        scores, carry = wave_sw.sw_wave(part, stack, carry, return_carry=True, shape=shape, **kw)
        want, plain_carry = wave_sw.sw_wave_plain(part, stack, plain_carry, return_carry=True, **kw)
        assert torch.equal(scores, want) and torch.equal(carry, plain_carry)


# --- K1's int16x2 kernel and its int32 rescore -------------------------------------------


def _gap_kw(gaps, n_segs):
    return dict(n_segs=n_segs, gap=2) if gaps is None else dict(n_segs=n_segs, gap_open=gaps[0], gap_extend=gaps[1])


@pytest.mark.parametrize("shape", wave_sw.SHAPES, ids=[f"G{g}H{h}" for g, h in wave_sw.SHAPES])
@pytest.mark.parametrize("gaps", [None, (10, 2)], ids=["linear", "affine"])
@pytest.mark.parametrize("n_queries,n_segs", [(1, 1), (3, 2)], ids=["one-query", "stack-chained"])
def test_int16_kernel_with_saturating_lanes_matches_plain(cuda, shape, gaps, n_queries, n_segs):
    """Every compiled (G, H), one query and a 3-query stack on chained
    segments, a 2,400-row query (75 bands: passes at every G, a 32-row tail
    band at H = 64) against W-run copies scoring 32,640 to 33,000
    (synth.saturating_bucket): bit-equal to the plain version after the
    rescore; without it exactly the entries over 32,640 read -1 and the rest
    are exact; the device's running total grows by the flagged count; the
    int32 kernel gives the same scores."""
    profile, bucket = synth.saturating_bucket(7, n_segs=n_segs, lanes=8 // n_segs + 2, n_queries=n_queries)
    prof, stack = torch.from_numpy(profile).to(cuda), torch.from_numpy(bucket).to(cuda)
    kw = _gap_kw(gaps, n_segs)
    want = wave_sw.sw_wave_plain(prof, stack, **kw)
    flagged = want > wave_sw.SAT16
    assert int(flagged.sum()) >= 4 * (1 if n_queries == 1 else 2)
    before = (wave_sw.sw_wave.int16_launches, wave_sw.sw_wave.rescore_launches)
    total = int(wave_sw.rescore_counter(cuda)[0])
    got = wave_sw.sw_wave(prof, stack, shape=shape, **kw)
    assert (wave_sw.sw_wave.int16_launches, wave_sw.sw_wave.rescore_launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, want)
    assert int(wave_sw.rescore_counter(cuda)[0]) - total == int(flagged.sum())
    raw = wave_sw._sw_wave_route(prof, stack, shape=shape, rescore=False, **kw)
    assert torch.equal(raw == -1, flagged) and torch.equal(raw[~flagged], want[~flagged])
    assert torch.equal(wave_sw._sw_wave_route(prof, stack, shape=shape, int32=True, **kw), want)


@pytest.mark.parametrize("gaps", [None, (10, 2)], ids=["linear", "affine"])
def test_rescore_scores_more_entries_than_a_block_scans(cuda, gaps):
    """1,100 lanes of W-run copies, every one over 32,640: more flagged
    entries than a rescore block scans (1,024) and many rounds of 8 a block,
    all rescored exactly, on the sweep and on the wavefront."""
    profile, _ = synth.saturating_bucket(1)
    lanes, seg_cols = 1100, 2240
    bucket = np.full((seg_cols + 32, lanes), PAD_SUBJECT, dtype=np.int8)
    for lane in range(lanes):
        bucket[: 2177 + lane % 24, lane] = 17  # W
    prof, stack = torch.from_numpy(profile).to(cuda), torch.from_numpy(bucket).to(cuda)
    kw = _gap_kw(gaps, 1)
    want = wave_sw.sw_wave_plain(prof, stack, **kw)
    assert bool((want > wave_sw.SAT16).all())
    for shape in ((1, wave_sw.BAND_H[gaps is not None]), (16, 32)):
        total = int(wave_sw.rescore_counter(cuda)[0])
        assert torch.equal(wave_sw.sw_wave(prof, stack, shape=shape, **kw), want), shape
        assert int(wave_sw.rescore_counter(cuda)[0]) - total == lanes


@pytest.mark.parametrize("gaps", [None, (10, 2)], ids=["linear", "affine"])
def test_hand_off_and_wide_gaps_run_the_int32_kernel(cuda, gaps):
    """A hand-off (top_in / return_carry) and gaps past I16_GAP_MAX launch
    the int32 kernel: no int16x2 launch, no rescore, exact scores."""
    prof, stack = _bucket(np.random.default_rng(3), 470, 40, 3, 99)
    prof, stack = prof.to(cuda), stack.to(cuda)
    kw = _gap_kw(gaps, 3)
    before = (wave_sw.sw_wave.int16_launches, wave_sw.sw_wave.rescore_launches, wave_sw.sw_wave.carry_launches)
    scores, carry = wave_sw.sw_wave(prof, stack, return_carry=True, **kw)
    want, plain_carry = wave_sw.sw_wave_plain(prof, stack, return_carry=True, **kw)
    assert torch.equal(scores, want) and torch.equal(carry, plain_carry)
    wide = dict(n_segs=3, gap=wave_sw.I16_GAP_MAX + 1) if gaps is None else dict(
        n_segs=3, gap_open=wave_sw.I16_GAP_MAX + 1, gap_extend=1)
    assert torch.equal(wave_sw.sw_wave(prof, stack, **wide), wave_sw.sw_wave_plain(prof, stack, **wide))
    after = (wave_sw.sw_wave.int16_launches, wave_sw.sw_wave.rescore_launches, wave_sw.sw_wave.carry_launches)
    assert after == (before[0], before[1], before[2] + 1)
    wave_sw.sw_wave(prof, stack, **kw)
    assert wave_sw.sw_wave.int16_launches == before[0] + 1


@pytest.mark.parametrize("gaps", [None, (10, 2)], ids=["linear", "affine"])
def test_engine_counts_rescored_lanes(cuda, gaps):
    """A database holding one W-run copy over 32,640 (and one at 32,640):
    a search and a batch each rescore exactly that entry, report it in
    ``SearchMetrics.rescored_lanes`` and on the engine, and score it exactly."""
    rng = np.random.default_rng(11)
    seqs = [np.full(2177, 17, dtype=np.int8), np.full(2176, 17, dtype=np.int8)]
    seqs += [rng.integers(0, 25, int(rng.integers(50, 600))).astype(np.int8) for _ in range(300)]
    db = synth.database_from_arrays(seqs)
    residues = np.concatenate([np.full(2200, 17), rng.integers(0, 25, 100)]).astype(np.int8)
    query = Query(name="w2200", residues=residues, raw="")
    cfg = SWConfig() if gaps is None else SWConfig(gap_open=gaps[0], gap_extend=gaps[1], top_k=5)
    eng = SearchEngine(cfg, device="cuda")
    res = eng.search(query, db)
    assert res.metrics.rescored_lanes == 1 and eng.rescored_lanes == 1
    if gaps is None:
        assert (int(res.scores[0]), int(res.scores[1])) == (32655, 32640)
    else:
        assert [tuple(map(int, h)) for h in res.hits[:2]] == [(0, 32655), (1, 32640)]
    batch = eng.search_many([query, query], db)
    assert [r.metrics.rescored_lanes for r in batch] == [2, 2] and eng.rescored_lanes == 3  # one piece of two


@pytest.mark.parametrize("query", ["P02232", "P01008", "P05013"])
def test_engine_subset_goldens_on_card(cuda, query):
    eng = SearchEngine(SWConfig(), device=cuda)
    db = parse_database(DATA / "uniprot_subset.fasta")
    res = eng.search(parse_query(DATA / "queries" / f"{query}.fasta"), db)
    golden = np.loadtxt(DATA / f"golden_{query}_subset.txt", dtype=np.int64)
    assert np.array_equal(res.scores, golden)
    assert res.metrics.kernel_launches == 2 * len(eng._resident_packed(db).wave_groups)  # K1 and its rescore


def test_engine_sat_golden_on_card(cuda):
    query, seqs = synth.synth_sat_case()
    res = SearchEngine(device=cuda).search(Query("sat", query, ""), synth.database_from_arrays(seqs))
    assert np.array_equal(res.scores, np.loadtxt(DATA / "golden_sat_case.txt", dtype=np.int64))


@pytest.mark.parametrize(
    "qlens,ws,S,B",
    [((20, 31), 32, 1, 64), ((100, 90, 70, 65, 96), 96, 3, 131), (tuple(range(449, 465)), 40, 8, 129),
     ((4548, 4500, 4400), 64, 1, 200)],
)
def test_multi_query_kernel_matches_plain(cuda, qlens, ws, S, B):
    rng = np.random.default_rng(sum(qlens))
    _, stack = _bucket(rng, 1, ws, S, B)
    qpad = -(-max(qlens) // 32) * 32
    profs = np.stack([make_profile(rng.integers(0, 25, n).astype(np.int8), blosum50_ref(), pad_rows_to=qpad) for n in qlens])
    prof, stack = torch.from_numpy(profs).to(cuda), stack.to(cuda)
    before = (wave_sw.sw_wave.launches, wave_sw.sw_wave.multi_launches)
    got = wave_sw.sw_wave(prof, stack, gap=2, n_segs=S)
    torch.cuda.synchronize()
    assert (wave_sw.sw_wave.launches, wave_sw.sw_wave.multi_launches) == (before[0] + 1, before[1] + 1)
    assert got.shape == (len(qlens), B * S)
    assert torch.equal(got, wave_sw.sw_wave_plain(prof, stack, gap=2, n_segs=S))


def test_serving_paths_subset_goldens_on_card(cuda):
    db = parse_database(DATA / "uniprot_subset.fasta")
    names = ["P02232", "P01008", "P05013", "P02232"]
    queries = [parse_query(DATA / "queries" / f"{q}.fasta") for q in names]
    goldens = [np.loadtxt(DATA / f"golden_{q}_subset.txt", dtype=np.int64) for q in names]
    eng = SearchEngine(SWConfig(), device=cuda)
    streamed = SearchEngine(SWConfig(device_resident=False), device=cuda)
    for results in (eng.search_many(queries, db), eng.search_queued(queries, db), streamed.search_many(queries, db)):
        for res, golden in zip(results, goldens):
            assert np.array_equal(res.scores, golden)
    topk = SearchEngine(SWConfig(top_k=10, evalue=True), device=cuda)
    full = SearchEngine(SWConfig(evalue=True), device=cuda)
    for results in (topk.search_many(queries, db), topk.search_queued(queries, db), [topk.search(q, db) for q in queries]):
        for res, q, golden in zip(results, queries, goldens):
            ref = SearchResult(scores=golden.astype(np.int32), metrics=res.metrics)
            assert res.top_k(10) == ref.top_k(10)
            want = full.search(q, db).top_k_stats(10)
            for g, w in zip(res.top_k_stats(10), want):
                assert (g.id, g.score) == (w.id, w.score)
                assert g.evalue == pytest.approx(w.evalue, rel=1e-9) and g.bits == pytest.approx(w.bits, rel=1e-9)


@pytest.mark.parametrize(
    "qlens,ws,S,B,gaps",
    [
        ((20,), 32, 1, 64, (10, 2)),
        ((100,), 200, 1, 130, (10, 1)),
        ((464,), 96, 3, 1000, (11, 1)),
        ((300,), 4100, 1, 65, (5, 5)),
        ((100, 90, 70, 65, 96), 96, 3, 131, (10, 2)),
        (tuple(range(449, 465)), 40, 8, 129, (10, 1)),
        ((4548,), 96, 1, 300, (10, 2)),
        ((464,), 40, 8, 2600, (10, 2)),
    ],
)
def test_affine_kernel_matches_plain(cuda, qlens, ws, S, B, gaps):
    rng = np.random.default_rng(sum(qlens) + S)
    _, stack = _bucket(rng, 1, ws, S, B)
    qpad = -(-max(qlens) // 32) * 32
    profs = [make_profile(rng.integers(0, 25, n).astype(np.int8), blosum50_ref(), pad_rows_to=qpad) for n in qlens]
    prof = torch.from_numpy(profs[0] if len(qlens) == 1 else np.stack(profs)).to(cuda)
    stack = stack.to(cuda)
    kw = dict(n_segs=S, gap_open=gaps[0], gap_extend=gaps[1])
    before = (wave_sw.sw_wave.launches, wave_sw.sw_wave.affine_launches)
    got = wave_sw.sw_wave(prof, stack, **kw)
    torch.cuda.synchronize()
    assert (wave_sw.sw_wave.launches, wave_sw.sw_wave.affine_launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(got, wave_sw.sw_wave_plain(prof, stack, **kw))
    if gaps[0] == gaps[1]:
        assert torch.equal(got, wave_sw.sw_wave(prof, stack, gap=gaps[0], n_segs=S))


@pytest.mark.parametrize("gaps", [None, (10, 1)], ids=["linear", "affine"])
def test_align_top_k_on_card(cuda, gaps):
    from swtpu_torch.models.align import align_top_k

    db = parse_database(DATA / "uniprot_subset.fasta")
    q = parse_query(DATA / "queries" / "P02232.fasta")
    cfg = SWConfig() if gaps is None else SWConfig(gap_open=gaps[0], gap_extend=gaps[1])
    before = wave_sw.sw_wave.affine_launches
    on_card = align_top_k(q, db, k=5, config=cfg, device=cuda)
    assert (wave_sw.sw_wave.affine_launches > before) == (gaps is not None)
    assert on_card == align_top_k(q, db, k=5, config=cfg, device="cpu")


def test_affine_kernel_chained_equals_unchained(cuda):
    rng = np.random.default_rng(5)
    S, ws, n = 4, 300, 515
    subjects = [rng.integers(0, 25, int(k)).astype(np.int8) for k in rng.integers(1, ws + 1, n)]
    chained = np.full((S * ws + 32, -(-n // S)), PAD_SUBJECT, dtype=np.int8)
    single = np.full((ws + 32, n), PAD_SUBJECT, dtype=np.int8)
    for k, s in enumerate(subjects):
        chained[(k % S) * ws : (k % S) * ws + len(s), k // S] = s
        single[: len(s), k] = s
    prof = torch.from_numpy(make_profile(rng.integers(0, 25, 200).astype(np.int8), blosum50_ref(), pad_rows_to=224)).to(cuda)
    kw = dict(gap_open=10, gap_extend=2)
    got = wave_sw.sw_wave(prof, torch.from_numpy(chained).to(cuda), n_segs=S, **kw)[:n]
    assert torch.equal(got, wave_sw.sw_wave(prof, torch.from_numpy(single).to(cuda), **kw))


@pytest.mark.parametrize(
    "qlen,C,B,L,gap",
    [(1, 1, 1, 8, 2), (20, 3, 77, 40, 1), (33, 17, 129, 128, 2), (100, 3, 333, 200, 11), (464, 1, 9, 4100, 2),
     (300, 3, 31, 6000, 1)],
)
def test_row_kernels_match_plain(cuda, qlen, C, B, L, gap):
    rng = np.random.default_rng(qlen + C)
    prof = make_profile(rng.integers(0, 25, qlen).astype(np.int8), blosum50_ref(), pad_rows_to=32)
    stack = np.full((C, B, L), PAD_SUBJECT, dtype=np.int8)
    for c in range(C):
        for b in range(B - (c == C - 1)):  # the last row of the last chunk stays empty
            n = int(rng.integers(1, L + 1))
            stack[c, b, :n] = rng.integers(0, 25, n)
    prof, stack = torch.from_numpy(prof).to(cuda), torch.from_numpy(stack).to(cuda)
    before = (bucket_sw.sw_score_bucket_fused.launches, bucket_sw.sw_score_bucket.launches)
    fused = bucket_sw.sw_score_bucket_fused(prof, stack, gap=gap)
    single = bucket_sw.sw_score_bucket(prof, stack[C // 2], gap=gap)
    torch.cuda.synchronize()
    assert (bucket_sw.sw_score_bucket_fused.launches, bucket_sw.sw_score_bucket.launches) == (before[0] + 1, before[1] + 1)
    assert fused.shape == (C, B) and torch.equal(fused, row_sw.sw_score_stack(prof, stack, gap=gap, strip=32))
    assert torch.equal(single, row_sw.sw_score_bucket(prof, stack[C // 2], gap=gap, strip=32))


def _row_stack(rng, qlen, C, B, L):
    prof = make_profile(rng.integers(0, 25, qlen).astype(np.int8), blosum50_ref(), pad_rows_to=32)
    stack = np.full((C, B, L), PAD_SUBJECT, dtype=np.int8)
    for c in range(C):
        for b in range(B - (c == C - 1)):  # the last row of the last chunk stays empty
            n = int(rng.integers(1, L + 1))
            stack[c, b, :n] = rng.integers(0, 25, n)
    return torch.from_numpy(prof), torch.from_numpy(stack)


@pytest.mark.parametrize("shape", bucket_sw.SHAPES, ids=[f"G{g}H{h}" for g, h in bucket_sw.SHAPES])
@pytest.mark.parametrize(
    "qlen,C,B,L,offset",
    [(464, 3, 77, 40, 0), (4548, 2, 9, 300, 0), (100, 2, 33, 7, 0), (200, 2, 65, 64, 0), (200, 2, 65, 64, 1),
     (1000, 1, 31, 129, 0)],
    ids=["one-pass", "nine-passes", "width-7", "aligned", "unaligned", "odd-rows"],
)
def test_every_row_kernel_shape_matches_plain(cuda, shape, qlen, C, B, L, offset):
    """Every compiled (G, H) of K2/K3 forced with ``shape=``, whatever
    rows_shape would pick: one pass and several (4,548 residues: nine at G =
    16), B not a multiple of 32 / G, C > 1, L < 16, L % 16 != 0, and 16-byte
    rows at an odd address (``offset``), through both wrappers, bit-equal to
    the plain version."""
    prof, stack = _row_stack(np.random.default_rng(qlen + L + offset), qlen, C, B, L)
    buf = torch.zeros(stack.numel() + offset, dtype=torch.int8, device=cuda)
    dev_stack = buf[offset:].view(C, B, L)
    dev_stack.copy_(stack.to(cuda))
    prof = prof.to(cuda)
    assert (dev_stack.data_ptr() % 16 != 0) == bool(offset)
    want = row_sw.sw_score_stack(prof, dev_stack, gap=2, strip=32)
    before = (bucket_sw.sw_score_bucket_fused.launches, bucket_sw.sw_score_bucket.launches)
    fused = bucket_sw.sw_score_bucket_fused(prof, dev_stack, gap=2, shape=shape)
    single = bucket_sw.sw_score_bucket(prof, dev_stack[C - 1], gap=2, shape=shape)
    torch.cuda.synchronize()
    assert (bucket_sw.sw_score_bucket_fused.launches, bucket_sw.sw_score_bucket.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(fused, want) and torch.equal(single, want[C - 1])


@pytest.mark.parametrize("shape", [(3, 32), (16, 64), (32, 32)])
def test_row_kernel_refuses_a_shape_not_compiled(cuda, monkeypatch, shape):
    """The wrappers' ``shape=`` refuses it before a launch; a rule that
    picks it reaches the kernel, which refuses it."""
    prof, stack = _row_stack(np.random.default_rng(0), 40, 1, 4, 16)
    prof, stack = prof.to(cuda), stack.to(cuda)
    for fn, x in ((bucket_sw.sw_score_bucket_fused, stack), (bucket_sw.sw_score_bucket, stack[0])):
        with pytest.raises(ValueError, match="not a compiled"):
            fn(prof, x, gap=2, shape=shape)
    with pytest.raises(ValueError, match="not a compiled"):
        wave_sw.sw_wave(*[t.to(cuda) for t in _bucket(np.random.default_rng(0), 40, 16, 1, 4)], gap=2, shape=shape)
    monkeypatch.setattr(bucket_sw, "rows_shape", lambda n_bands, rows: shape)
    with pytest.raises(RuntimeError, match="sw_rows kernel launch"):
        bucket_sw.sw_score_bucket_fused(prof, stack, gap=2)


@pytest.mark.parametrize("name", ["main", "main_multi", "main_shard", "main_chain", "main_affine", "main_rows",
                                  "main_shapes", "main_thresholds"])
def test_card_fuzz_functions(cuda, name):
    """``swtpu_torch.tools.card_fuzz`` on the card, a few cases a function:
    every launch bit-equal to its plain version and to the oracle sample,
    and counted by its wrapper as by the fuzz."""
    from swtpu_torch.tools import card_fuzz

    fz = card_fuzz.Fuzz(cuda)
    assert getattr(card_fuzz, name)(n_cases=3, fuzz=fz) == 0, fz.failures
    summary = fz.summary(0.0)
    assert summary["failures"] == 0 and summary["launch_total"] > 0
    assert summary["wrapper_launches"] == {k: sum(n for key, n in fz.launches.items() if key.startswith(k + " "))
                                           for k in ("K1", "K2", "K3")}
    assert set(summary["max_abs_err"].values()) == {0}


def test_cli_profile_on_card(cuda, tmp_path):
    """``--profile`` on the card writes a Chrome trace; its device events
    hold the wavefront kernel, and the dump equals the run without it."""
    import subprocess
    import sys

    from swtpu_torch.utils.profiling import TRACE_NAME, trace_summary

    root = Path(__file__).resolve().parent.parent
    cmd = [sys.executable, "-m", "swtpu_torch", "--query", str(DATA / "queries" / "P02232.fasta"),
           "--db", str(DATA / "uniprot_subset.fasta")]
    runs = [subprocess.run(cmd + extra, cwd=root, capture_output=True, text=True, timeout=600)
            for extra in ([], ["--profile", str(tmp_path / "trace")])]
    assert all(r.returncode == 0 for r in runs), [r.stderr[-2000:] for r in runs]
    assert runs[0].stdout.split("=" * 80)[0] == runs[1].stdout.split("=" * 80)[0]
    s = trace_summary(tmp_path / "trace" / TRACE_NAME)
    # K1: the int16x2 kernels (sw_wave16_kernel, sw_band16_kernel) and their rescore, or the int32 ones
    assert s["device_events"] > 0 and any(k.startswith(("sw_wave16_kernel<", "sw_band16_kernel<", "sw_wave_kernel<",
                                                        "sw_band_kernel<")) for k in s["kernel_ms"])
    assert any(k.startswith("sw_rescore_kernel<") for k in s["kernel_ms"])
    assert 0 < s["busy_share"]


@pytest.mark.parametrize("resident", [True, False], ids=["K2 resident", "K3 streamed"])
def test_pallas_engine_subset_goldens_on_card(cuda, resident):
    db = parse_database(DATA / "uniprot_subset.fasta")
    eng = SearchEngine(SWConfig(use_wave=False, use_pallas=True, device_resident=resident), device=cuda)
    for query in ("P02232", "P01008", "P05013"):
        before = (bucket_sw.sw_score_bucket_fused.launches, bucket_sw.sw_score_bucket.launches)
        res = eng.search(parse_query(DATA / "queries" / f"{query}.fasta"), db)
        assert np.array_equal(res.scores, np.loadtxt(DATA / f"golden_{query}_subset.txt", dtype=np.int64))
        k2 = bucket_sw.sw_score_bucket_fused.launches - before[0]
        k3 = bucket_sw.sw_score_bucket.launches - before[1]
        if resident:
            assert (k2, k3) == (len(eng._resident_packed(db).groups), 0) and k2 > 0
        else:
            assert (k2, k3) == (0, len(eng.plan(db).batches))


@pytest.mark.parametrize("gaps", [None, (10, 2)], ids=["linear", "affine"])
@pytest.mark.parametrize(
    "qlen,ws,S,B", [(20, 32, 1, 64), (470, 96, 3, 1000), (1000, 40, 8, 129), (300, 4100, 1, 65), (470, 40, 8, 2600)]
)
def test_hand_off_kernel_matches_plain_rung_by_rung(cuda, gaps, qlen, ws, S, B):
    rng = np.random.default_rng(qlen + S)
    _, stack = _bucket(rng, 1, ws, S, B)
    qpad = -(-qlen // 32) * 32
    prof = torch.from_numpy(make_profile(rng.integers(0, 25, qlen).astype(np.int8), blosum50_ref(), pad_rows_to=qpad))
    kw = dict(n_segs=S, gap=2) if gaps is None else dict(n_segs=S, gap_open=gaps[0], gap_extend=gaps[1])
    prof, stack = prof.to(cuda), stack.to(cuda)
    carry = wave_sw.virgin_carry(stack, gaps is not None)
    plain_carry = carry.clone()
    best = None
    band = 0
    for rung in band_split(qpad // 32):
        part = prof[band * 32 : (band + rung) * 32]
        band += rung
        before = wave_sw.sw_wave.carry_launches
        scores, carry = wave_sw.sw_wave(part, stack, carry, return_carry=True, **kw)
        torch.cuda.synchronize()
        assert wave_sw.sw_wave.carry_launches == before + 1
        want, plain_carry = wave_sw.sw_wave_plain(part, stack, plain_carry, return_carry=True, **kw)
        assert torch.equal(scores, want) and torch.equal(carry, plain_carry)
        best = scores if best is None else torch.maximum(best, scores)
    assert torch.equal(best, wave_sw.sw_wave(prof, stack, **kw))


@pytest.mark.parametrize("gaps", [None, (10, 2)], ids=["linear", "affine"])
def test_engine_launches_once_a_bucket_on_card(cuda, gaps):
    """Queries of several bands run fused on the card: one K1 launch a
    bucket, no hand-off, the scores, queued scores, top-K and E-values those
    of the engine on the CPU."""
    db = parse_database(DATA / "uniprot_subset.fasta")
    queries = [parse_query(DATA / "queries" / f"{q}.fasta") for q in ("P02232", "P01008", "P05013")]
    extra = {} if gaps is None else dict(gap_open=gaps[0], gap_extend=gaps[1])
    eng = SearchEngine(SWConfig(**extra), device=cuda)
    cpu = SearchEngine(SWConfig(**extra), device="cpu")
    want = [cpu.search(q, db).scores for q in queries]
    n_buckets = len(eng._resident_packed(db).wave_groups)
    for q, w in zip(queries, want):
        launches, carries = wave_sw.sw_wave.launches, wave_sw.sw_wave.carry_launches
        res = eng.search(q, db)
        assert wave_sw.sw_wave.launches - launches == n_buckets and wave_sw.sw_wave.carry_launches == carries
        assert np.array_equal(res.scores, w)
    for got, w in zip(eng.search_queued(queries, db), want):
        assert np.array_equal(got.scores, w)
    topk = SearchEngine(SWConfig(top_k=10, evalue=True, **extra), device=cuda)
    ref = SearchEngine(SWConfig(top_k=10, evalue=True, **extra), device="cpu")
    for q in queries:
        got, r = topk.search(q, db), ref.search(q, db)
        assert got.hits == r.hits and got.top_k_stats(10) == r.top_k_stats(10)


@pytest.mark.parametrize("n,n_q,dim", [(1, 1, 64), (15, 2, 1024), (17, 17, 2048), (4097, 8, 96), (100003, 33, 1024)])
def test_coarse_counts_kernel_matches_plain(cuda, n, n_q, dim):
    gen = torch.Generator(device=cuda)
    gen.manual_seed(n + dim)
    db = torch.randint(0, 2, (n, dim), dtype=torch.int8, device=cuda, generator=gen)
    qs = torch.randint(0, 2, (n_q, dim), dtype=torch.int8, device=cuda, generator=gen)
    db[0, :5], qs[-1, 2:6] = 5, -5
    before = int8_mma.coarse_counts.launches
    got = int8_mma.coarse_counts(qs, db)
    torch.cuda.synchronize()
    assert int8_mma.coarse_counts.launches == before + 1
    assert torch.equal(got, int8_mma.coarse_counts_plain(qs, db))


def test_probe_and_chain_kernels_match_plain(cuda):
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-5, 5, (128, 384), dtype=np.int8)).to(cuda)
    b = torch.from_numpy(rng.integers(0, 2, (384, 512), dtype=np.int8)).to(cuda)
    for iters, unroll in ((1, 1), (2, 5), (3, 100)):
        assert torch.equal(int8_mma.mma_probe(a, b, iters, unroll), int8_mma.mma_probe_plain(a, b, iters, unroll))
    x = torch.from_numpy(rng.integers(0, 1000, (32, 512), dtype=np.int32)).to(cuda)
    for y_lo in (0, -3):  # with negative y the max picks x on some links
        y = torch.from_numpy(rng.integers(y_lo, 3, (32, 512), dtype=np.int32)).to(cuda)
        for iters in (0, 1, 7):
            assert torch.equal(vpu_chain.vpu_chain(x, y, iters), vpu_chain.vpu_chain_plain(x, y, iters))


def test_coarse_counts_kernel_refuses_misaligned_rows(cuda):
    buf = torch.zeros(8 + 3 * 96, dtype=torch.int8, device=cuda)
    db = buf[8:].view(3, 96)  # contiguous, 8 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="16-byte aligned"):
        int8_mma.coarse_counts(torch.zeros(1, 96, dtype=torch.int8, device=cuda), db)


@pytest.mark.parametrize("evalue", [False, True], ids=["hits", "evalue"])
def test_prefiltered_engine_on_card_matches_cpu(cuda, evalue):
    db = parse_database(DATA / "uniprot_subset.fasta")
    queries = [parse_query(DATA / "queries" / f"{q}.fasta") for q in ("P02232", "P01008", "P05013")]
    cfg = SWConfig(prefilter=0.2, top_k=5, prefilter_min_candidates=1, evalue=evalue)
    card, cpu = SearchEngine(cfg, device=cuda), SearchEngine(cfg, device="cpu")
    for q in queries:
        before = int8_mma.coarse_counts.launches
        got = card.search(q, db)
        assert int8_mma.coarse_counts.launches == before + 1
        want = cpu.search(q, db)
        assert got.hits == want.hits
        if evalue:
            assert got.top_k_stats(5) == want.top_k_stats(5)
    before = int8_mma.coarse_counts.launches
    many = card.search_many(queries, db)
    assert int8_mma.coarse_counts.launches == before + 1
    assert [r.hits for r in many] == [cpu.search(q, db).hits for q in queries]


# --- the prefilter's long route --------------------------------------------------------------


def _long_database(rng, lens, query, planted=()):
    """(flat, offsets) on the card of sequences of the given lengths, a
    30%-mutated copy of the query's head planted in the named ones."""
    seqs = [rng.integers(0, 25, int(n)).astype(np.int8) for n in lens]
    for i in planted:
        cut = query[: min(len(query), len(seqs[i]))]
        seqs[i][: len(cut)] = np.where(rng.random(len(cut)) < 0.3, seqs[i][: len(cut)], cut)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    return torch.from_numpy(np.concatenate(seqs)).cuda(), torch.from_numpy(offsets).cuda()


@pytest.mark.parametrize("gaps", [None, (10, 2)], ids=["linear", "affine"])
@pytest.mark.parametrize("qlen", [20, 320, 1736, 5478])
def test_long_route_kernel_matches_plain(cuda, gaps, qlen):
    """The long route's kernel at the UniRef50 cell's shapes: sequences of
    993-8,000 residues (one warp, a pass +- 1, two passes), queries of
    20-5,478, ids longest first and then shuffled with repeats: equal to its
    plain version on the card, one launch each."""
    rng = np.random.default_rng(qlen)
    query = rng.integers(0, 25, qlen).astype(np.int8)
    lens = [8000, 6100, 4097, 4096, 4095, 3000, 2016, 1025, 1024, 993]
    flat, offsets = _long_database(rng, lens, query, planted=(0, 3, 9))
    table = torch.from_numpy(long_sw.matrix_table(blosum50_ref())).cuda()
    kw = dict(gap=2) if gaps is None else dict(gap_open=gaps[0], gap_extend=gaps[1])
    q = torch.from_numpy(query).cuda()
    for ids in (np.arange(len(lens)), rng.integers(0, len(lens), 16)):
        ids = torch.from_numpy(ids.astype(np.int64)).cuda()
        before = long_sw.sw_long.launches
        got = long_sw.sw_long(q, flat, offsets, ids, table, **kw)
        assert long_sw.sw_long.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, long_sw.sw_long_plain(q, flat, offsets, ids, table, **kw))


@pytest.mark.parametrize("gaps", [None, (10, 2)], ids=["linear", "affine"])
def test_long_route_scores_saturating_pairs_exactly(cuda, gaps):
    """W-run copies of synth.SAT_RUNS (2,176-2,200 residues, 15 a residue:
    32,640-33,000) against a 2,200-W query with a random tail: exact int32
    past 32,767 in one launch, with no rescore (the int16x2 kernel's
    counter does not move)."""
    rng = np.random.default_rng(5)
    query = np.concatenate([np.full(2200, 17), rng.integers(0, 25, 200)]).astype(np.int8)
    seqs = [np.full(k, 17, dtype=np.int8) for k in synth.SAT_RUNS] + [rng.integers(0, 25, 3000).astype(np.int8)]
    lens = [len(x) for x in seqs]
    flat = torch.from_numpy(np.concatenate(seqs)).cuda()
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)).cuda()
    table = torch.from_numpy(long_sw.matrix_table(blosum50_ref())).cuda()
    kw = dict(gap=2) if gaps is None else dict(gap_open=gaps[0], gap_extend=gaps[1])
    ids = torch.arange(len(seqs), dtype=torch.int64, device=cuda)
    rescored = int(wave_sw.rescore_counter(cuda)[0])
    got = long_sw.sw_long(torch.from_numpy(query).cuda(), flat, offsets, ids, table, **kw)
    assert got[: len(synth.SAT_RUNS)].tolist() == [15 * k for k in synth.SAT_RUNS]
    assert int(got.max()) > 32767
    assert torch.equal(got, long_sw.sw_long_plain(torch.from_numpy(query).cuda(), flat, offsets, ids, table, **kw))
    assert int(wave_sw.rescore_counter(cuda)[0]) == rescored


@pytest.mark.parametrize(
    "qlen,ws,S,B",
    [(20, 32, 1, 64), (33, 48, 2, 77), (100, 96, 3, 130), (1000, 160, 4, 515), (464, 4100, 1, 129),
     (300, 40, 3, 129), (1100, 24, 2, 65), (4548, 16, 1, 33), (464, 7, 5, 97)],
)
def test_wave_lab_kernels_match_plain(cuda, qlen, ws, S, B):
    """K4 at every height and block on the profile padded to its height; K5
    and K6 (K1's band sweep at H = 64) on K1's unpadded profile, odd band
    counts ending in a 32-row tail, and 7-column segments that run only the
    D ring's remainder."""
    prof, stack = _bucket(np.random.default_rng(qlen * 3 + S), qlen, ws, S, B)
    stack = stack.to(cuda)
    k1 = wave_sw.sw_wave(prof.to(cuda), stack, gap=2, n_segs=S)
    for h in wave_lab.HEIGHTS:
        p = wave_lab.pad_profile(prof, h).to(cuda)
        want = wave_lab.sw_wave_lab_plain(p, stack, gap=2, n_segs=S, height=h)
        assert torch.equal(want, k1)
        for blk in wave_lab.BLOCKS:
            sched = wave_lab.band_schedule(p.shape[0] // h, h, blk, B)
            before = wave_lab.sw_wave_band.launches
            got = wave_lab.sw_wave_band(p, stack, gap=2, n_segs=S, height=h, block=blk)
            torch.cuda.synchronize()
            assert wave_lab.sw_wave_band.launches == before + 1
            assert torch.equal(got, want), (h, blk, sched)
    p, h = prof.to(cuda), wave_lab.SWEEP_HEIGHT
    assert torch.equal(wave_lab.sw_wave_lab_plain(p, stack, gap=2, n_segs=S, height=h), k1)
    for d in wave_lab.DEPTHS:
        before = wave_lab.sw_wave_prefetch.launches
        assert torch.equal(wave_lab.sw_wave_prefetch(p, stack, gap=2, n_segs=S, depth=d), k1), d
        assert wave_lab.sw_wave_prefetch.launches == before + 1
    for skip in wave_lab.SKIPS:
        before = wave_lab.sw_wave_skip.launches
        got = wave_lab.sw_wave_skip(p, stack, gap=2, n_segs=S, skip=skip)
        torch.cuda.synchronize()
        assert wave_lab.sw_wave_skip.launches == before + 1
        assert torch.equal(got, wave_lab.sw_wave_lab_plain(p, stack, gap=2, n_segs=S, height=h, skip=skip)), skip
        if skip == "none":
            assert torch.equal(got, k1)


def test_k5_copy_of_k1_sweep_has_its_registers(cuda):
    """K5 at D = 1 with no stage skipped is a copy of K1's linear band sweep
    at H = 64: ``cuobjdump -res-usage`` of the built libraries reports the
    same registers, and neither uses local memory."""
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")

    def usage(name, kernel):  # (registers, local bytes) of the one kernel matching ``kernel``
        dump = subprocess.run([str(cuobjdump), "-res-usage", str(_build.build(name)[name]["path"])],
                              capture_output=True, text=True, check=True).stdout
        (found,) = [(int(m[2]), int(m[3])) for m in
                    re.finditer(r"Function (\S+?):\s+REG:(\d+) STACK:\d+ SHARED:\d+ LOCAL:(\d+)", dump)
                    if re.search(kernel, m[1])]
        return found

    k1 = usage("sw_wave", r"sw_band_kernelILb0ELb0ELi64E")
    k5 = usage("sw_wave_lab", rf"sw_band_lab_kernelILi{wave_lab.SWEEP_HEIGHT}ELi1ELi0E")
    assert k5[0] == k1[0], (k5, k1)
    assert k5[1] == k1[1] == 0, (k5, k1)


def test_i16_tiles_and_chains_match_plain(cuda):
    rng = np.random.default_rng(9)
    for dtype in i16_probe.DTYPES:
        a = torch.arange(16 * 512).reshape(16, 512) % 1000
        tiles = [(a, (a * 3 + 7) % 997)]  # tools/probe_i16.py's run inputs
        lo, hi = (-32768, 32768) if dtype == torch.int16 else (-(2**31), 2**31)
        tiles.append(tuple(torch.from_numpy(rng.integers(lo, hi, (16, 512))) for _ in range(2)))  # sums wrap
        for x, y in tiles:
            x, y = x.to(dtype).to(cuda), y.to(dtype).to(cuda)
            for op in i16_probe.OPS:
                before = i16_probe.i16_op.launches
                got = i16_probe.i16_op(x, y, op)
                torch.cuda.synchronize()
                assert i16_probe.i16_op.launches == before + 1
                assert torch.equal(got, i16_probe.i16_op_plain(x, y, op)), (op, dtype)
        cols = 1024 if dtype == torch.int16 else 512
        x = torch.from_numpy(rng.integers(0, 1000, (32, cols))).to(dtype).to(cuda)
        for y_lo, y_hi in ((-2, 1), (-3, 3000)):  # the rate inputs; int16 sums that wrap
            y = torch.from_numpy(rng.integers(y_lo, y_hi, (32, cols))).to(dtype).to(cuda)
            for op in i16_probe.CHAIN_OPS:
                for iters in (0, 1, 5):
                    before = i16_probe.i16_chain.launches
                    got = i16_probe.i16_chain(x, y, op, iters)
                    torch.cuda.synchronize()
                    assert i16_probe.i16_chain.launches == before + 1
                    assert torch.equal(got, i16_probe.i16_chain_plain(x, y, op, iters)), (op, dtype, iters)


def test_wave_lab_cases_cross_pass_boundaries_and_tails():
    """The K4 cases above run one pass and several at every height, with a
    last pass of fewer bands than G (the tail) at H = 16 and 64, and the
    139 KB stage (H = 64, G = 16)."""
    bands = {h: [-(-q // h) for q in (300, 1100, 4548)] for h in wave_lab.HEIGHTS}
    for h in wave_lab.HEIGHTS:
        scheds = [wave_lab.band_schedule(n, h, 32, 1) for n in bands[h]]
        assert max(s.passes for s in scheds) > 1
        if h in (16, 64):
            assert any(n % s.g for n, s in zip(bands[h], scheds) if s.passes > 1), h
    assert wave_lab.band_schedule(bands[64][-1], 64, 32, 1).stage_bytes == 139_520


@pytest.mark.parametrize("rows,cols", [(16, 512), (1, 1), (300, 1), (1, 1024), (300, 1024), (7, 3), (5, 30)])
def test_i16_tile_instances_match_plain_at_every_shape(cuda, rows, cols):
    """The ten tile instantiations at 1 and 1,024 words a row and 1 and 300
    rows (and odd word counts, whose rows are not 16-byte aligned), on
    inputs whose int16 and int32 sums wrap."""
    rng = np.random.default_rng(rows * 7 + cols)
    for op, dtype in i16_probe.TILE_INSTANCES:
        width = cols * (2 if dtype == torch.int16 else 1)
        lo, hi = (-32768, 32768) if dtype == torch.int16 else (-(2**31), 2**31)
        a, b = (torch.from_numpy(rng.integers(lo, hi, (rows, width))).to(dtype).to(cuda) for _ in range(2))
        before = i16_probe.i16_op.launches
        got = i16_probe.i16_op(a, b, op)
        torch.cuda.synchronize()
        assert i16_probe.i16_op.launches == before + 1
        assert torch.equal(got, i16_probe.i16_op_plain(a, b, op)), (op, dtype, rows, cols)
    a = torch.arange(3 * 6, dtype=torch.int32, device=cuda).reshape(3, 6)
    got = i16_probe.i16_op(a[1:], a[1:] * 3, "dp_row")  # an offset tile: 24 bytes in, not 16-byte aligned
    assert torch.equal(got, i16_probe.i16_op_plain(a[1:], a[1:] * 3, "dp_row"))


def test_stream_handle_is_the_current_stream(cuda):
    """Every launch's stream is read by _build.stream, torch's raw getter:
    it must be the handle of torch.cuda.current_stream, on the default
    stream and inside torch.cuda.stream(side)."""
    from swtpu_torch.ops import _build

    index = torch.cuda.current_device()
    assert _build.stream(index) == torch.cuda.current_stream(index).cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert _build.stream(index) == torch.cuda.current_stream(index).cuda_stream == side.cuda_stream
        assert _build.where(torch.device("cuda"))[1] == side.cuda_stream
    assert _build.stream(index) == torch.cuda.current_stream(index).cuda_stream != side.cuda_stream


def test_i16_tile_launches_on_the_callers_stream(cuda):
    """A tile launched inside torch.cuda.stream(side) runs there, after
    what was queued on it: the side stream waits on an event of the default
    stream, sleeps, then copies the tiles the launch reads.  Launched on
    another stream the kernel would read the copies' destinations before
    they are written."""
    rng = np.random.default_rng(11)
    a = torch.from_numpy(rng.integers(-32768, 32768, (64, 1024))).to(torch.int16).to(cuda)
    b = torch.from_numpy(rng.integers(-32768, 32768, (64, 1024))).to(torch.int16).to(cuda)
    for op in i16_probe.OPS:
        want = i16_probe.i16_op_plain(a, b, op)
        ready = torch.cuda.Event()
        ready.record()
        side = torch.cuda.Stream()
        with torch.cuda.stream(side):
            side.wait_event(ready)
            a2, b2 = torch.empty_like(a), torch.empty_like(b)
            torch.cuda._sleep(50_000_000)  # tens of milliseconds of the side stream
            a2.copy_(a)
            b2.copy_(b)
            got = i16_probe.i16_op(a2, b2, op)
            done = torch.cuda.Event()
            done.record()
        torch.cuda.current_stream().wait_event(done)
        assert torch.equal(got, want), op


@pytest.mark.parametrize(
    "qlen,C,B,L,pad",
    [(1, 1, 1, 8, 32), (20, 3, 77, 40, 32), (33, 2, 129, 1, 32), (100, 3, 333, 31, 32), (464, 1, 9, 4100, 32),
     (300, 3, 31, 6000, 32),
     # pass boundaries (34 16-row, 17 32-row bands; 38 and 19 unpadded), query tails that are no whole band,
     # B off the rows a block at ILP 2 (16) and 4 (32) and off v3's 16, and P01008's length at B = 23 (v3:
     # two 16-row blocks) and B = 1 (v2: one one-row block)
     (520, 2, 37, 96, 32), (600, 1, 50, 200, 1), (37, 3, 33, 64, 1), (530, 2, 17, 130, 8), (464, 2, 23, 64, 32),
     (464, 1, 1, 300, 32)],
)
@pytest.mark.parametrize("gap", [2, 120])
def test_rows_lab_kernels_match_plain(cuda, qlen, C, B, L, pad, gap):
    rng = np.random.default_rng(qlen + C + L)
    prof = make_profile(rng.integers(0, 25, qlen).astype(np.int8), blosum50_ref(), pad_rows_to=pad)
    stack = np.full((C, B, L), PAD_SUBJECT, dtype=np.int8)
    for c in range(C):
        for b in range(B - (c == C - 1)):  # the last row of the last chunk stays empty
            n = int(rng.integers(1, L + 1))
            stack[c, b, :n] = rng.integers(0, 25, n)
    prof, stack = torch.from_numpy(prof).to(cuda), torch.from_numpy(stack).to(cuda)
    want = rows_lab.rows_lab_plain(prof, stack, gap=gap)
    assert torch.equal(want, bucket_sw.sw_score_bucket_fused(rows_lab.pad_profile(prof, 32), stack, gap=gap))
    for v, s, ilp in rows_lab.INSTANCES:
        fn = rows_lab.WRAPPERS[v]
        before = fn.launches
        got = fn(prof, stack, gap=gap, strip=s, **({"ilp": ilp} if v == "v4" else {}))
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        assert got.shape == (C, B) and torch.equal(got, want), (v, s, ilp)
        # the kernel's launch is the schedule the wrapper sized its carry by
        sched = rows_lab.wave_schedule(v, prof.shape[0], s, ilp, B)
        card = rows_lab.card_schedule(v, prof.shape[0], s, ilp, B, cuda)
        assert card[:5] == (sched.g, sched.passes, sched.rows_per_block, sched.blocks, sched.stage_bytes)
        assert 1 <= card[5] <= sched.smem_blocks_per_sm


def test_cli_and_native_packed_streaming_on_card(cuda, tmp_path):
    """A FASTA file through ``python -m swtpu_torch`` on the card (native
    parse, resident wave pack) equals the CPU engine's scores; the streamed
    wavefront path (native host buckets) and K3 streamed (native row
    batches) equal the resident wave and K2 paths."""
    import subprocess
    import sys

    from swtpu_torch.alphabet import decode
    from swtpu_torch.io.fasta import write_fasta

    rng = np.random.default_rng(11)
    seqs = [decode(rng.integers(0, 25, int(n))) for n in rng.integers(0, 700, 400)]  # empty ones included
    path = tmp_path / "db.fasta"
    write_fasta(path, seqs)
    qpath = DATA / "queries" / "P02232.fasta"
    out = subprocess.run([sys.executable, "-m", "swtpu_torch", "--query", str(qpath), "--db", str(path)],
                         cwd=DATA.parent.parent, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    query, db = parse_query(qpath), parse_database(path)
    want = SearchEngine(SWConfig(), device="cpu").search(query, db).scores
    dump = [ln for ln in out.stdout.splitlines() if ":" in ln and ln.split(":")[0].isdigit()]
    assert dump == [f"{i}:{s}" for i, s in enumerate(want.tolist())]

    before = wave_sw.sw_wave.launches
    streamed = SearchEngine(SWConfig(device_resident=False), device=cuda).search_many([query], db)[0]
    assert wave_sw.sw_wave.launches > before and np.array_equal(streamed.scores, want)
    k2 = SearchEngine(SWConfig(use_wave=False), device=cuda)
    assert np.array_equal(k2.search(query, db).scores, want)
    before = bucket_sw.sw_score_bucket.launches
    k3 = SearchEngine(SWConfig(use_wave=False, device_resident=False), device=cuda)
    assert np.array_equal(k3.search(query, db).scores, want)
    assert bucket_sw.sw_score_bucket.launches - before == len(k3.plan(db).batches)


def _mesh_data():
    db = synth.synth_database(3000, seed=5)
    queries = [parse_query(DATA / "queries" / f"{q}.fasta") for q in ("P02232", "P01008", "P05013")]
    return queries, db


@pytest.mark.parametrize("n", [2, 3])
def test_lane_sharded_engine_on_card_matches_single(cuda, n):
    """cuda:0 x n: every shard's launches, the lane split and the merged
    top-K on the card equal one device: search, top-K with E-values,
    search_many, search_queued, streamed and affine."""
    queries, db = _mesh_data()
    mesh = [cuda] * n
    for extra in ({}, dict(gap_open=10, gap_extend=2)):
        single = SearchEngine(SWConfig(**extra), device=cuda)
        want = [single.search(q, db).scores for q in queries]
        eng = SearchEngine(SWConfig(mesh_shape=(n,), **extra), device=mesh)
        before = wave_sw.sw_wave.launches
        assert np.array_equal(eng.search(queries[1], db).scores, want[1])
        assert wave_sw.sw_wave.launches - before == n * len(eng._resident_packed(db).wave_groups)
        for results in (eng.search_many(queries, db), eng.search_queued(queries, db)):
            assert all(np.array_equal(r.scores, w) for r, w in zip(results, want))
        streamed = SearchEngine(SWConfig(mesh_shape=(n,), device_resident=False, **extra), device=mesh)
        assert np.array_equal(streamed.search(queries[2], db).scores, want[2])
        ref = SearchEngine(SWConfig(top_k=10, evalue=True, **extra), device=cuda)
        topk = SearchEngine(SWConfig(mesh_shape=(n,), top_k=10, evalue=True, **extra), device=mesh)
        for got, r in zip(topk.search_many(queries, db), ref.search_many(queries, db)):
            assert got.hits == r.hits and got.top_k_stats(10) == r.top_k_stats(10)


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_step_k3_on_card_matches_one_launch(cuda, n):
    """make_sharded_step(use_pallas=True) on cuda:0 x n: one K3 launch a
    shard, whose scores, top ids and top scores (a tie across shards
    included) equal one K3 launch over the whole batch and the int32 plain
    scorer, in (score desc, id asc) order."""
    from swtpu_torch.parallel import make_mesh, make_sharded_step

    rng = np.random.default_rng(40 + n)
    B, L, k = 64 * n, 256, 8
    subj = np.full((B, L), PAD_SUBJECT, np.int8)
    for i in range(B):
        m = int(rng.integers(5, L))
        subj[i, :m] = rng.integers(0, 25, m)
    subj[5] = subj[B - 3]  # the same subject in the first shard and the last
    prof = torch.from_numpy(make_profile(rng.integers(0, 25, 90).astype(np.int8), blosum50_ref(), pad_rows_to=32)).to(cuda)
    subj_d = torch.from_numpy(subj).to(cuda)
    step = make_sharded_step(make_mesh(devices=[cuda] * n), gap=2, strip=32, top_k=k, use_pallas=True)
    before = bucket_sw.sw_score_bucket.launches
    scores, top_ids, top_scores = step(prof, subj_d)
    assert bucket_sw.sw_score_bucket.launches - before == n
    whole = bucket_sw.sw_score_bucket(prof, subj_d, gap=2, strip=32).cpu().numpy()
    plain = row_sw.sw_score_bucket(prof.cpu(), torch.from_numpy(subj), gap=2, strip=32).numpy()
    assert np.array_equal(whole, plain) and np.array_equal(scores.cpu().numpy(), whole)
    order = sorted(range(B), key=lambda i: (-int(whole[i]), i))[:k]
    assert top_ids.cpu().tolist() == order and top_scores.cpu().tolist() == whole[order].tolist()
    assert whole[5] == whole[B - 3]


@pytest.mark.parametrize("gaps", [None, (10, 2)], ids=["linear", "affine"])
def test_query_sharded_engine_on_card_matches_single(cuda, gaps):
    """cuda:0 x 4: the band pipeline's hand-off launches on the card give
    the single-device scores."""
    queries, db = _mesh_data()
    extra = {} if gaps is None else dict(gap_open=gaps[0], gap_extend=gaps[1])
    single = SearchEngine(SWConfig(**extra), device=cuda)
    eng = SearchEngine(SWConfig(mesh_shape=(4,), query_shard=True, **extra), device=[cuda] * 4)
    before = wave_sw.sw_wave.carry_launches
    for q in queries:
        assert np.array_equal(eng.search(q, db).scores, single.search(q, db).scores)
    assert wave_sw.sw_wave.carry_launches > before


def test_mesh_of_distinct_cards_matches_single(cuda):
    """Where the machine has several cards: a mesh of all of them, lane and
    query sharded, equals one card, and the thread's current device is the
    one it was (every kernel entry point sets the device itself)."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    n = torch.cuda.device_count()
    queries, db = _mesh_data()
    single = SearchEngine(SWConfig(top_k=10, evalue=True), device="cuda:0")
    current = torch.cuda.current_device()
    for extra in ({}, dict(query_shard=True)):
        eng = SearchEngine(SWConfig(mesh_shape=(n,), top_k=10, evalue=True, **extra))
        assert eng.mesh.distinct == tuple(torch.device("cuda", i) for i in range(n))
        for got, want in zip(eng.search_queued(queries, db), single.search_queued(queries, db)):
            assert got.top_k(10) == want.hits
        assert torch.cuda.current_device() == current


@pytest.mark.parametrize("n", [3, 4])
def test_k2_row_shards_match_plain(cuda, n):
    """K2 at the row-shard shapes of an n-way split of a 32,768-row stack
    (2 chunks of 16,384 rows, rounded up to lcm(8, n) as the mesh's plan
    rounds them): the whole stack runs the band sweep (rows x C >=
    BAND_ROWS), each shard the warp wavefront.  Every shard's launch equals
    its plain version, and the shards gathered in mesh order the launch
    over the whole stack."""
    from math import gcd

    from swtpu_torch.parallel.mesh import make_mesh, shard_lanes

    mult = 8 * n // gcd(8, n)
    B = -(-16_384 // mult) * mult
    prof, stack = _row_stack(np.random.default_rng(n), 300, 2, B, 48)
    prof, stack = prof.to(cuda), stack.to(cuda)
    n_bands = prof.shape[0] // bucket_sw.W
    shards = shard_lanes(stack, make_mesh(devices=[cuda] * n))
    assert bucket_sw.rows_shape(n_bands, 2 * B)[0] == 1
    assert all(s.shape[1] == B // n and bucket_sw.rows_shape(n_bands, 2 * s.shape[1])[0] > 1 for s in shards)
    before = bucket_sw.sw_score_bucket_fused.launches
    got = [bucket_sw.sw_score_bucket_fused(prof, s, gap=2) for s in shards]
    whole = bucket_sw.sw_score_bucket_fused(prof, stack, gap=2)
    torch.cuda.synchronize()
    assert bucket_sw.sw_score_bucket_fused.launches - before == n + 1
    for s, g in zip(shards, got):
        assert torch.equal(g, row_sw.sw_score_stack(prof, s, gap=2, strip=32))
    assert torch.equal(torch.cat(got, dim=1), whole)


@pytest.mark.parametrize("n", [3, 4])
def test_row_path_mesh_on_card_matches_single(cuda, n):
    """cuda:0 x n on the row path: K2 on every row shard (groups x n
    launches) with PyTorch seg16, the int16 mode, the streamed K3 route on
    the primary, the prefilter (its exact engine on the mesh) and a streamed
    database under query_shard, each equal to one device."""
    queries, db = _mesh_data()
    mesh = [cuda] * n
    want = [SearchEngine(SWConfig(), device=cuda).search(q, db).scores for q in queries]
    eng = SearchEngine(SWConfig(mesh_shape=(n,), use_wave=False), device=mesh)
    packed = eng._resident_packed(db)
    before = bucket_sw.sw_score_bucket_fused.launches
    assert np.array_equal(eng.search(queries[1], db).scores, want[1])
    assert bucket_sw.sw_score_bucket_fused.launches - before == n * len(packed.groups) > 0
    for kw in (dict(score_dtype="int16"), dict(use_wave=False, device_resident=False),
               dict(query_shard=True, device_resident=False)):
        other = SearchEngine(SWConfig(mesh_shape=(n,), **kw), device=mesh)
        assert all(np.array_equal(r.scores, w) for r, w in zip(other.search_queued(queries, db), want))
    for wave in (None, False):
        pre = dict(prefilter=0.05, top_k=10, use_wave=wave)
        one = SearchEngine(SWConfig(**pre), device=cuda)
        got = SearchEngine(SWConfig(mesh_shape=(n,), **pre), device=mesh)
        assert [r.hits for r in got.search_many(queries, db)] == [r.hits for r in one.search_many(queries, db)]


def test_two_rank_gloo_fleet_on_one_card(cuda, tmp_path):
    """Two processes of the launcher with gloo on 127.0.0.1, both on cuda:0,
    print the same hits: the single-device engine's top-10."""
    import json
    import socket
    import subprocess
    import sys

    from swtpu_torch.alphabet import decode
    from swtpu_torch.io.fasta import write_fasta

    _, db = _mesh_data()
    path = tmp_path / "db.fasta"
    write_fasta(path, [decode(db.sequence(i)) for i in range(db.n)])
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    root = Path(__file__).resolve().parent.parent
    cmd = [sys.executable, "-m", "swtpu_torch.parallel.launch", "--query", str(DATA / "queries" / "P01008.fasta"),
           "--db", str(path), "--json", "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2"]
    procs = [subprocess.Popen(cmd + ["--process-id", str(p)], cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for p in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _, err in outs]
    got = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    query = parse_query(DATA / "queries" / "P01008.fasta")
    want = SearchEngine(SWConfig(top_k=10), device=cuda).search(query, parse_database(path))
    assert got[0]["hits"] == got[1]["hits"] == [list(h) for h in want.hits]
    assert [g["device"] for g in got] == ["cuda:0", "cuda:0"]
