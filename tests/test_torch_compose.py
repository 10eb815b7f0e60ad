"""The kernel's band-carry hand-off mode, and the fused engine on the cases
of swtpu's composed band-group dispatch, held to swtpu on the CPU.

On the CPU ``sw_wave`` runs its plain version.  Its hand-off (``top_in``,
``return_carry``) is held to swtpu's Pallas kernel in interpret mode, carry
and scores, with swtpu's ``(B/Bt, L2+w, Bt)`` carry (row = column + w)
mapped to the port's ``(n_segs * seg_cols, B)``, and chained in
``parallel.query_shard``'s band slices (``card_fuzz.band_split``), the
split the port runs it in.  The port has no composed dispatch (the CUDA
kernel takes any shape): the query lengths, gaps, chained lanes, serving
paths and warmup of tests/test_compose.py run on its fused engine, one
launch a bucket and no hand-off, held to swtpu's engine in interpret mode,
whose results are computed once per module.
Every comparison is exact, except E-values and bits against swtpu (rel
0.02, the tolerance of tests/test_evalue_modes.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.alphabet import encode_str as j_encode
from swtpu.config import SWConfig as JConfig
from swtpu.io.fasta import Query as JQuery
from swtpu.io.fasta import database_from_sequences as j_database_from_sequences
from swtpu.matrices import blosum50_ref
from swtpu.models.search import SearchEngine as JEngine
from swtpu.ops import wave_sw as jwave
from swtpu.ops import xla_sw
from swtpu_torch.alphabet import encode_str
from swtpu_torch.config import SWConfig
from swtpu_torch.io.fasta import Query, database_from_sequences
from swtpu_torch.models import search as tsearch
from swtpu_torch.models.search import SearchEngine
from swtpu_torch.ops import wave_sw
from swtpu_torch.parallel.mesh import make_mesh
from swtpu_torch.parallel.query_shard import band_slices
from swtpu_torch.tools.card_fuzz import band_split

ALPHABET = "ARNDCQEGHILKMFPSTWYV"
JWAVE = dict(use_wave=True, interpret=True)
W = wave_sw.W
MAT = blosum50_ref()
K = 5
LINEAR_QLENS = (20, 75, 170, 500)  # swtpu composes them as (1), (2, 1), (4, 2), (16)
MANY_QLENS = (40, 45, 90)  # search_many pieces (64, Q=2) and (96, Q=1)
NOVEL = 272  # 9 bands, a length warmup has not run


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: intra-op threads gain nothing here and contend with
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq(rng, n):
    return "".join(rng.choice(list(ALPHABET), size=int(n)))


def _both(seqs, qstrs):
    """The same database and queries for the port and for swtpu."""
    port = ([Query(f"q{len(s)}", encode_str(s), s) for s in qstrs], database_from_sequences(seqs))
    jax = ([JQuery(f"q{len(s)}", j_encode(s), s) for s in qstrs], j_database_from_sequences(seqs))
    return port, jax


@pytest.fixture(scope="module")
def linear():
    """One database, the linear queries, and swtpu's scores of each (one
    swtpu engine)."""
    rng = np.random.default_rng(31)
    seqs = [_seq(rng, n) for n in rng.integers(5, 700, 60)]
    lens = LINEAR_QLENS + MANY_QLENS + (NOVEL, 480)
    (queries, db), (jqueries, jdb) = _both(seqs, [_seq(rng, n) for n in lens])
    jeng = JEngine(JConfig(**JWAVE))
    ref = {q.length: jeng.search(jq, jdb).scores for q, jq in zip(queries, jqueries) if q.length != 480}
    return {q.length: q for q in queries}, db, ref, ({q.length: q for q in jqueries}, jdb)


def _engine(**kw):
    return SearchEngine(SWConfig(**kw), device="cpu")


# --- the band split of a hand-off chain -------------------------------------------------


def test_band_split_is_query_shards():
    """Where n divides the bands, query_shard's slices; else the first
    slices one band larger; never an empty slice."""
    prof = torch.arange(12 * W * 32, dtype=torch.int32).reshape(12 * W, 32)
    for n in (1, 2, 3, 4):
        sizes = band_split(12, n)
        assert sizes == (12 // n,) * n
        slices = band_slices(prof, make_mesh(devices=("cpu",) * n))
        assert [s.shape[0] // W for s in slices] == list(sizes) and torch.equal(torch.cat(slices), prof)
    assert band_split(143) == (36, 36, 36, 35)  # the longest suite query, 4,548 aa
    assert band_split(15) == (4, 4, 4, 3) and band_split(2) == (1, 1) and band_split(1) == (1,)
    for n_bands in range(1, 200):
        sizes = band_split(n_bands)
        assert sum(sizes) == n_bands and min(sizes) >= 1 and max(sizes) - min(sizes) <= 1
    with pytest.raises(ValueError):
        band_split(0)


# --- the kernel's hand-off mode (its plain version here) -------------------------------


def _bucket(rng, qlen, qpad, ws, S, B):
    prof = xla_sw.make_profile(rng.integers(0, 25, qlen).astype(np.int8), MAT, pad_rows_to=qpad)
    stack = np.full((S * ws + W, B), xla_sw.PAD_SUBJECT, dtype=np.int8)
    for k in range(B * S - 1):  # the last slot stays empty
        n = int(rng.integers(1, ws + 1))
        stack[(k % S) * ws : (k % S) * ws + n, k // S] = rng.integers(0, 25, n)
    return prof, stack


def _seeded_carry(rng, cols, B, affine):
    """A nonzero carry as a band bottom can hold it: H >= 0; F >= -open, or NEG."""
    h = rng.integers(0, 60, (cols, B)).astype(np.int32)
    if not affine:
        return h
    f = np.where(rng.random((cols, B)) < 0.2, wave_sw.NEG, rng.integers(-10, 50, (cols, B))).astype(np.int32)
    return np.stack([h, f], axis=-1)


def _to_swtpu_carry(carry, L2, Bt, affine):
    """The port's (cols, B[, 2]) carry as swtpu's (B/Bt, [2,] L2+w, Bt) with
    row = column + w; rows of no port column hold H = 0 and F = NEG."""
    cols, B = carry.shape[:2]
    planes = np.moveaxis(carry, -1, 0) if affine else carry[None]
    out = np.zeros((planes.shape[0], L2 + W, B), np.int32)
    if affine:
        out[1] = wave_sw.NEG
    out[:, W : W + cols] = planes
    out = out.reshape(planes.shape[0], L2 + W, B // Bt, Bt).transpose(2, 0, 1, 3)
    return out if affine else out[:, 0]


def _from_swtpu_carry(carry, cols, affine):
    c = np.asarray(carry)
    c = c if affine else c[:, None]
    tiles, n_planes, LT, Bt = c.shape
    planes = c.transpose(1, 2, 0, 3).reshape(n_planes, LT, tiles * Bt)[:, W : W + cols]
    return np.moveaxis(planes, 0, -1) if affine else planes[0]


AFFINE_GAPS = dict(gap_open=10, gap_extend=1)


@pytest.mark.parametrize("top", ["virgin", "seeded"])
@pytest.mark.parametrize(
    "gaps,qlen,qpad,ws,S,B,Lc",
    [
        ("linear", 40, 64, 96, 1, 16, 64),
        ("linear", 33, 64, 48, 2, 8, 32),
        ("affine", 40, 64, 96, 1, 16, 64),
        ("affine", 60, 96, 48, 2, 8, 32),
    ],
)
def test_hand_off_matches_swtpu_interpret(top, gaps, qlen, qpad, ws, S, B, Lc):
    """The scores equal swtpu's, from a virgin top or the same seeded one,
    and so does the returned carry, plane by plane, in every column but the
    last of each segment followed by another.  There swtpu's separator
    sweep cuts the vertical gap chain (h, and under affine gaps F, of row r
    reset before row r + 1 reads it), which no score can see: a value
    reached down the last column only feeds that column and the next
    segment, which starts from the boundary.  The port keeps the true
    recurrence there, never below swtpu's."""
    affine = gaps == "affine"
    kw = AFFINE_GAPS if affine else dict(gap=2)
    rng = np.random.default_rng(qlen + S + 7 * affine)
    prof, stack = _bucket(rng, qlen, qpad, ws, S, B)
    cols, L2 = S * ws, stack.shape[0]
    top_in = _seeded_carry(rng, cols, B, affine) if top == "seeded" else None
    j_top = None if top_in is None else jnp.asarray(_to_swtpu_carry(top_in, L2, 8, affine))
    j_scores, j_carry = jwave.sw_wave(
        jnp.asarray(jwave.build_lhs_banded(prof)), jnp.asarray(stack), j_top,
        Lc=Lc, Bt=8, n_segs=S, interpret=True, return_carry=True, **kw,
    )
    t_top = None if top_in is None else torch.from_numpy(top_in.copy())
    scores, carry = wave_sw.sw_wave(
        torch.from_numpy(prof), torch.from_numpy(stack), t_top, n_segs=S, return_carry=True, **kw
    )
    assert carry.dtype == torch.int32 and tuple(carry.shape) == ((cols, B, 2) if affine else (cols, B))
    assert t_top is None or carry is t_top  # overwritten in place
    assert np.array_equal(scores.numpy(), np.asarray(j_scores))
    got, want = carry.numpy(), _from_swtpu_carry(j_carry, cols, affine)
    sep = [(s + 1) * ws - 1 for s in range(S - 1)]
    rest = np.setdiff1d(np.arange(cols), sep)
    assert np.array_equal(got[rest], want[rest])
    assert (got[sep] >= want[sep]).all()


def _chain(prof, stack, S, kw, top_in):
    """Run a profile's bands slice by slice in ``band_split``'s slices;
    returns the running max of the scores, the final carry and the split."""
    groups = band_split(prof.shape[0] // W)
    carry = top_in.clone() if top_in is not None else wave_sw.virgin_carry(stack, "gap_open" in kw)
    best, band = None, 0
    for g in groups:
        scores, carry = wave_sw.sw_wave_plain(prof[band * W : (band + g) * W], stack, carry, n_segs=S, return_carry=True, **kw)
        best = scores if best is None else torch.maximum(best, scores)
        band += g
    return best, carry, groups


@pytest.mark.parametrize("top", ["virgin", "seeded"])
@pytest.mark.parametrize("gaps", ["linear", "affine"])
def test_rung_chain_equals_one_call(top, gaps):
    """15 bands as (4, 4, 4, 3): the chain's scores and carry are one call's."""
    affine = gaps == "affine"
    kw = dict(gap_open=10, gap_extend=2) if affine else dict(gap=2)
    rng = np.random.default_rng(15 + affine)
    prof, stack = _bucket(rng, 470, 480, 40, 3, 9)
    prof, stack = torch.from_numpy(prof), torch.from_numpy(stack)
    top_in = torch.from_numpy(_seeded_carry(rng, stack.shape[0] - W, 9, affine)) if top == "seeded" else None
    best, carry, groups = _chain(prof, stack, 3, kw, top_in)
    assert groups == (4, 4, 4, 3)
    one_scores, one_carry = wave_sw.sw_wave(prof, stack, None if top_in is None else top_in.clone(), n_segs=3, return_carry=True, **kw)
    assert torch.equal(best, one_scores) and torch.equal(carry, one_carry)
    if top_in is None:  # a virgin chain scores what the scorer without hand-off does
        assert torch.equal(best, wave_sw.sw_wave(prof, stack, n_segs=3, **kw))


@pytest.mark.parametrize(
    "case,match",
    [
        ("stack with top_in", "single query"),
        ("stack with return_carry", "single query"),
        ("shape", "top_in must be"),
        ("affine shape", "top_in must be"),
        ("dtype", "top_in must be"),
        ("device", "top_in on"),
        ("strided", "contiguous"),
    ],
)
def test_sw_wave_hand_off_rejects(case, match):
    prof = torch.zeros(32, 32, dtype=torch.int8)
    stack = torch.full((64 + W, 4), wave_sw.PAD_SUBJECT, dtype=torch.int8)
    good = torch.zeros(64, 4, dtype=torch.int32)
    args, kw = (prof, stack), dict(gap=2)
    if case == "stack with top_in":
        args = (prof[None].repeat(2, 1, 1), stack, good)
    elif case == "stack with return_carry":
        args, kw = (prof[None].repeat(2, 1, 1), stack), dict(gap=2, return_carry=True)
    elif case == "shape":
        args = (prof, stack, torch.zeros(96, 4, dtype=torch.int32))
    elif case == "affine shape":
        args, kw = (prof, stack, good), dict(gap_open=10, gap_extend=1)
    elif case == "dtype":
        args = (prof, stack, good.long())
    elif case == "device":
        args = (prof, stack, torch.zeros(64, 4, dtype=torch.int32, device="meta"))
    else:
        args = (prof, stack, torch.zeros(4, 64, dtype=torch.int32).T)
    for fn in (wave_sw.sw_wave, wave_sw.sw_wave_plain):
        with pytest.raises(ValueError, match=match):
            fn(*args, **kw)


def test_carry_bytes_and_virgin_carry():
    assert wave_sw.carry_bytes(1, 2, 48, 8) == 0  # one band, nothing handed on
    assert wave_sw.carry_bytes(1, 2, 48, 8, hand_off=True) == 4 * 96 * 8
    assert wave_sw.carry_bytes(1, 2, 48, 8, affine=True, hand_off=True) == 8 * 96 * 8
    assert wave_sw.carry_bytes(3, 2, 48, 8) == 0  # three bands, one pass: the carry stays on chip
    assert wave_sw.carry_bytes(17, 2, 48, 8) == 4 * 96 * 8  # a pass boundary: G is at most 16
    stack = torch.zeros(96 + W, 8, dtype=torch.int8)
    lin, aff = wave_sw.virgin_carry(stack), wave_sw.virgin_carry(stack, affine=True)
    assert lin.shape == (96, 8) and lin.dtype == torch.int32 and not lin.any()
    assert aff.shape == (96, 8, 2) and not aff[..., 0].any() and (aff[..., 1] == wave_sw.NEG).all()
    # a one-band rung reads and writes the carry: a nonzero top changes its scores and carry
    prof = torch.from_numpy(xla_sw.make_profile(np.arange(20, dtype=np.int8), MAT, pad_rows_to=32))
    stack[:50, :] = torch.from_numpy(np.random.default_rng(1).integers(0, 25, (50, 8)).astype(np.int8))
    s0, c0 = wave_sw.sw_wave(prof, stack, wave_sw.virgin_carry(stack), gap=2, return_carry=True)
    s1, c1 = wave_sw.sw_wave(prof, stack, torch.full((96, 8), 40, dtype=torch.int32), gap=2, return_carry=True)
    assert c0.any() and not torch.equal(c0, c1) and (s1 >= s0).all() and not torch.equal(s0, s1)
    # without return_carry, top_in still ends holding the new carry
    top = torch.full((96, 8), 40, dtype=torch.int32)
    assert torch.equal(wave_sw.sw_wave(prof, stack, top, gap=2), s1) and torch.equal(top, c1)


# --- the fused engine on swtpu's composed cases ---------------------------------------


class _Spy:
    """Records each sw_wave call: (profile rows, profile dims, queries, bucket
    columns, hand-off)."""

    def __init__(self, monkeypatch):
        real = wave_sw.sw_wave
        self.calls = []

        def spy(profile, subjT, top_in=None, **kw):
            hand_off = top_in is not None or kw.get("return_carry", False)
            n_q = profile.shape[0] if profile.dim() == 3 else 1
            self.calls.append((profile.shape[-2], profile.dim(), n_q, subjT.shape[0], hand_off))
            return real(profile, subjT, top_in, **kw)

        spy.launches = spy.multi_launches = spy.affine_launches = spy.carry_launches = 0
        monkeypatch.setattr(wave_sw, "sw_wave", spy)


@pytest.mark.parametrize("qlen", LINEAR_QLENS)
def test_fused_engine_one_launch_a_bucket_matches_swtpu(linear, qlen, monkeypatch):
    """A length swtpu composes as several rungs: one launch a bucket over
    every band, no hand-off, swtpu's scores."""
    queries, db, ref, _ = linear
    eng = _engine()
    packed = eng._resident_packed(db)
    spy = _Spy(monkeypatch)
    res = eng.search(queries[qlen], db)
    assert np.array_equal(res.scores, ref[qlen])
    rows = -(-qlen // W) * W
    assert spy.calls == [(rows, 2, 1, g.stack.shape[0], False) for g in packed.wave_groups]


def test_fused_engine_affine_matches_swtpu():
    rng = np.random.default_rng(7)
    seqs = [_seq(rng, n) for n in rng.integers(5, 300, 40)]
    (queries, db), (jqueries, jdb) = _both(seqs, [_seq(rng, 170)])  # 6 bands: swtpu's rungs (4, 2)
    gaps = dict(gap_open=10, gap_extend=2)
    want = JEngine(JConfig(**JWAVE, **gaps)).search(jqueries[0], jdb).scores
    assert np.array_equal(_engine(**gaps).search(queries[0], db).scores, want)


def test_fused_engine_chained_lanes_match_swtpu(monkeypatch):
    """A tiny chained plan (width 64, two subjects a lane) pinned in both
    packages: the segments of a lane stay apart over every band."""
    from swtpu.utils import bucketing as jbucketing

    def tiny_plan(db_, *a, **kw):
        ids = np.argsort(-db_.lengths, kind="stable").astype(np.int64)
        return [(64, ids, 128, 128, 2)]

    monkeypatch.setattr(jbucketing, "plan_wave_buckets", tiny_plan)
    monkeypatch.setattr(tsearch, "plan_wave_buckets", tiny_plan)
    rng = np.random.default_rng(11)
    seqs = [_seq(rng, n) for n in rng.integers(5, 30, 120)]
    (queries, db), (jqueries, jdb) = _both(seqs, [_seq(rng, 170)])
    eng = _engine()
    assert [g.n_segs for g in eng._resident_packed(db).wave_groups] == [2]
    want = JEngine(JConfig(**JWAVE)).search(jqueries[0], jdb).scores
    assert np.array_equal(eng.search(queries[0], db).scores, want)


def test_fused_topk_and_evalues_match_swtpu(linear):
    """The device top-K with E-values, through search and search_queued:
    the hits of the full array and swtpu's, the same fit on both paths."""
    queries, db, ref_scores, (jqueries, jdb) = linear
    q = queries[75]
    ref = JEngine(JConfig(**JWAVE, top_k=K, evalue=True)).search(jqueries[75], jdb)
    eng = _engine(top_k=K, evalue=True)
    full = tsearch.SearchResult(scores=ref_scores[75], metrics=None).top_k(K)
    got, queued = eng.search(q, db), eng.search_queued([q], db)[0]
    for res in (got, queued):
        assert res.scores is None and res.hits == full == ref.hits
    assert got.top_k_stats(K) == queued.top_k_stats(K)  # the same flat scores: the same fit
    for g, r in zip(got.top_k_stats(K), ref.top_k_stats(K)):
        assert (g.id, g.score) == (r.id, r.score)
        assert g.evalue == pytest.approx(r.evalue, rel=0.02) and g.bits == pytest.approx(r.bits, rel=0.02)


def test_search_queued_matches_swtpu(linear):
    queries, db, ref, _ = linear
    eng = _engine()
    for q, res in zip([queries[n] for n in LINEAR_QLENS], eng.search_queued([queries[n] for n in LINEAR_QLENS], db)):
        assert np.array_equal(res.scores, ref[q.length])
        assert res.metrics.attributed


def test_search_many_folds_swtpus_pieces_into_3d_launches(linear, monkeypatch):
    """search_many folds swtpu's ``_query_pieces`` shapes into one 3-D
    launch a piece and bucket from its first call on (no cold route, no
    hand-off), with swtpu's scores."""
    queries, db, ref, (jqueries, _) = linear
    qs = [queries[n] for n in MANY_QLENS]
    eng = _engine()
    n_buckets = len(eng._resident_packed(db).wave_groups)
    keys = [(qpad, len(p)) for qpad, p in JEngine(JConfig(**JWAVE))._query_pieces([jqueries[n] for n in MANY_QLENS])]
    assert keys == [(qpad, len(p)) for qpad, p in eng._query_pieces(qs)] == [(64, 2), (96, 1)]
    spy = _Spy(monkeypatch)
    for q, res in zip(qs, eng.search_many(qs, db)):
        assert np.array_equal(res.scores, ref[q.length])
    assert [(rows, dims, n_q, h) for rows, dims, n_q, _, h in spy.calls] == [
        (qpad, 3, n_q, False) for qpad, n_q in keys for _ in range(n_buckets)
    ]


def test_search_many_topk_matches_full_array(linear):
    queries, db, ref, _ = linear
    qs = [queries[n] for n in MANY_QLENS]
    res = _engine(top_k=K).search_many(qs, db)
    for q, r in zip(qs, res):
        assert r.scores is None
        assert r.hits == tsearch.SearchResult(scores=ref[q.length], metrics=r.metrics).top_k(K)


def test_warmup_then_novel_length(linear, monkeypatch):
    """warmup dispatches once a bucket for each distinct fused shape
    (``_fused_key``) of its queries; a length it did not run scores as
    swtpu's after it; a streamed database has nothing to warm."""
    queries, db, ref, _ = linear
    eng = _engine()
    n_buckets = len(eng._resident_packed(db).wave_groups)
    spy = _Spy(monkeypatch)
    batch = [queries[480], queries[480], queries[75], queries[90]]  # 480 and 96 rows, twice each
    assert eng.warmup(batch, db) >= 0.0
    assert {eng._fused_key(q) for q in batch} == {480, 96}
    assert sorted(c[0] for c in spy.calls) == sorted([96] * n_buckets + [480] * n_buckets)
    assert not any(c[4] for c in spy.calls)
    assert np.array_equal(eng.search(queries[NOVEL], db).scores, ref[NOVEL])
    assert _engine(device_resident=False).warmup([queries[20]], db) == 0.0  # a streamed database: nothing to warm
