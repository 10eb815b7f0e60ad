"""Composed band-group dispatch and the warmups of the port, and the
kernel's band-carry hand-off mode, held to swtpu on the CPU.

On the CPU ``sw_wave`` runs its plain version.  Its hand-off (``top_in``,
``return_carry``) is held to swtpu's Pallas kernel in interpret mode, carry
and scores, with swtpu's ``(B/Bt, L2+w, Bt)`` carry (row = column + w)
mapped to the port's ``(n_segs * seg_cols, B)``.  The composed engine is
held to swtpu's composed engine in interpret mode (the cases of
tests/test_compose.py), whose results are computed once per module, and to
the port's own fused path.  Every comparison is exact, except E-values and
bits against swtpu (rel 0.02, the tolerance of tests/test_evalue_modes.py).
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

ALPHABET = "ARNDCQEGHILKMFPSTWYV"
JWAVE = dict(use_wave=True, interpret=True, wave_compose=True)
W = wave_sw.W
MAT = blosum50_ref()
K = 5
LINEAR_QLENS = (20, 75, 170, 500)  # composed as (1), (2, 1), (4, 2), (16)
MANY_QLENS = (40, 45, 90)  # search_many pieces (64, Q=2) and (96, Q=1)
NOVEL = 272  # 9 bands: (8, 1), both rungs of a 480-residue query's (8, 4, 2, 1)


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
    """One database, the linear queries, and swtpu's composed scores of
    each (one swtpu engine, so each rung compiles once)."""
    rng = np.random.default_rng(31)
    seqs = [_seq(rng, n) for n in rng.integers(5, 700, 60)]
    lens = LINEAR_QLENS + MANY_QLENS + (NOVEL, 480)
    (queries, db), (jqueries, jdb) = _both(seqs, [_seq(rng, n) for n in lens])
    jeng = JEngine(JConfig(**JWAVE))
    ref = {q.length: jeng.search(jq, jdb).scores for q, jq in zip(queries, jqueries) if q.length != 480}
    return {q.length: q for q in queries}, db, ref, ({q.length: q for q in jqueries}, jdb)


def _engine(**kw):
    return SearchEngine(SWConfig(**kw), device="cpu")


# --- the band-group split -------------------------------------------------------------


def test_compose_groups_match_swtpu():
    assert SearchEngine.COMPOSE_MAX_RUNG == JEngine.COMPOSE_MAX_RUNG
    for n in range(1, 401):
        assert SearchEngine._compose_groups(n) == JEngine._compose_groups(n)
    assert SearchEngine._compose_groups(143) == (128, 8, 4, 2, 1)  # the longest suite query, 4,548 aa
    with pytest.raises(ValueError):
        SearchEngine._compose_groups(0)


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
    """Run a profile's bands rung by rung in the port's split; returns the
    running max of the scores and the final carry."""
    groups = SearchEngine._compose_groups(prof.shape[0] // W)
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
    """15 bands as (8, 4, 2, 1): the chain's scores and carry are one call's."""
    affine = gaps == "affine"
    kw = dict(gap_open=10, gap_extend=2) if affine else dict(gap=2)
    rng = np.random.default_rng(15 + affine)
    prof, stack = _bucket(rng, 470, 480, 40, 3, 9)
    prof, stack = torch.from_numpy(prof), torch.from_numpy(stack)
    top_in = torch.from_numpy(_seeded_carry(rng, stack.shape[0] - W, 9, affine)) if top == "seeded" else None
    best, carry, groups = _chain(prof, stack, 3, kw, top_in)
    assert groups == (8, 4, 2, 1)
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


# --- the engine against swtpu's composed engine ----------------------------------------


class _Spy:
    """Records each sw_wave call: (profile rows, profile dims, bucket columns, hand-off)."""

    def __init__(self, monkeypatch):
        real = wave_sw.sw_wave
        self.calls = []

        def spy(profile, subjT, top_in=None, **kw):
            self.calls.append((profile.shape[-2], profile.dim(), subjT.shape[0], top_in is not None or kw.get("return_carry", False)))
            return real(profile, subjT, top_in, **kw)

        spy.launches = spy.multi_launches = spy.affine_launches = spy.carry_launches = 0
        monkeypatch.setattr(wave_sw, "sw_wave", spy)


@pytest.mark.parametrize("qlen", LINEAR_QLENS)
def test_composed_scores_match_swtpu_and_fused(linear, qlen, monkeypatch):
    queries, db, ref, _ = linear
    eng = _engine(wave_compose=True)
    packed = eng._resident_packed(db)
    spy = _Spy(monkeypatch)
    res = eng.search(queries[qlen], db)
    assert np.array_equal(res.scores, ref[qlen])
    assert np.array_equal(res.scores, _engine().search(queries[qlen], db).scores)
    rungs = SearchEngine._compose_groups(-(-qlen // W))
    composed = [c for c in spy.calls if c[3]]
    assert len(composed) == len(rungs) * len(packed.wave_groups)  # rung-major, every bucket a rung
    assert [c[0] for c in composed] == [g * W for g in rungs for _ in packed.wave_groups]


def test_composed_affine_matches_swtpu():
    rng = np.random.default_rng(7)
    seqs = [_seq(rng, n) for n in rng.integers(5, 300, 40)]
    (queries, db), (jqueries, jdb) = _both(seqs, [_seq(rng, 170)])  # 6 bands: (4, 2)
    gaps = dict(gap_open=10, gap_extend=2)
    want = JEngine(JConfig(**JWAVE, **gaps)).search(jqueries[0], jdb).scores
    got = _engine(wave_compose=True, **gaps).search(queries[0], db).scores
    assert np.array_equal(got, want)
    assert np.array_equal(got, _engine(**gaps).search(queries[0], db).scores)


def test_composed_chained_lanes_match_swtpu(monkeypatch):
    """A tiny chained plan (width 64, two subjects a lane) pinned in both
    packages: the hand-off keeps segments apart across rungs."""
    from swtpu.utils import bucketing as jbucketing

    def tiny_plan(db_, *a, **kw):
        ids = np.argsort(-db_.lengths, kind="stable").astype(np.int64)
        return [(64, ids, 128, 128, 2)]

    monkeypatch.setattr(jbucketing, "plan_wave_buckets", tiny_plan)
    monkeypatch.setattr(tsearch, "plan_wave_buckets", tiny_plan)
    rng = np.random.default_rng(11)
    seqs = [_seq(rng, n) for n in rng.integers(5, 30, 120)]
    (queries, db), (jqueries, jdb) = _both(seqs, [_seq(rng, 170)])
    eng = _engine(wave_compose=True)
    assert [g.n_segs for g in eng._resident_packed(db).wave_groups] == [2]
    want = JEngine(JConfig(**JWAVE)).search(jqueries[0], jdb).scores
    got = eng.search(queries[0], db).scores
    assert np.array_equal(got, want)
    assert np.array_equal(got, _engine().search(queries[0], db).scores)


def test_composed_topk_and_evalues_match_swtpu_and_fused(linear):
    queries, db, _, (jqueries, jdb) = linear
    q = queries[75]
    ref = JEngine(JConfig(**JWAVE, top_k=K, evalue=True)).search(jqueries[75], jdb)
    eng = _engine(wave_compose=True, top_k=K, evalue=True)
    fused = _engine(top_k=K, evalue=True)
    for run in (lambda e: e.search(q, db), lambda e: e.search_queued([q], db)[0]):
        got, want = run(eng), run(fused)
        assert got.scores is None and got.hits == want.hits == ref.hits
        assert got.top_k_stats(K) == want.top_k_stats(K)  # the same flat scores: the same fit
        for g, r in zip(got.top_k_stats(K), ref.top_k_stats(K)):
            assert (g.id, g.score) == (r.id, r.score)
            assert g.evalue == pytest.approx(r.evalue, rel=0.02) and g.bits == pytest.approx(r.bits, rel=0.02)


def test_composed_search_queued_matches_swtpu(linear):
    queries, db, ref, _ = linear
    eng = _engine(wave_compose=True)
    for q, res in zip([queries[n] for n in LINEAR_QLENS], eng.search_queued([queries[n] for n in LINEAR_QLENS], db)):
        assert np.array_equal(res.scores, ref[q.length])
        assert res.metrics.attributed


def test_search_many_cold_route_then_hot_swap(linear, monkeypatch):
    """Cold pieces run the composed per-query chains (no profile stack
    reaches sw_wave); warmup_many_background runs the fused piece shapes
    swtpu's would, and search_many then folds them, with the same scores."""
    queries, db, ref, (jqueries, _) = linear
    qs = [queries[n] for n in MANY_QLENS]
    eng = _engine(wave_compose=True)
    spy = _Spy(monkeypatch)
    cold = eng.search_many(qs, db)
    assert spy.calls and all(dims == 2 and hand_off for _, dims, _, hand_off in spy.calls)
    for q, res in zip(qs, cold):
        assert np.array_equal(res.scores, ref[q.length])
    t = eng.warmup_many_background(qs, db)
    t.join(timeout=300)
    assert not t.is_alive() and eng._warmup_many_bg_error is None
    keys = {(qpad, len(p)) for qpad, p in JEngine(JConfig(**JWAVE))._query_pieces([jqueries[n] for n in MANY_QLENS])}
    assert eng._fused_many_warm == keys == {(64, 2), (96, 1)}
    spy.calls.clear()
    hot = eng.search_many(qs, db)
    assert any(dims == 3 for _, dims, _, _ in spy.calls) and not any(h for *_, h in spy.calls)
    for a, b in zip(cold, hot):
        assert np.array_equal(a.scores, b.scores)


def test_search_many_cold_route_topk(linear):
    queries, db, ref, _ = linear
    qs = [queries[n] for n in MANY_QLENS]
    res = _engine(wave_compose=True, top_k=K).search_many(qs, db)
    for q, r in zip(qs, res):
        assert r.scores is None
        assert r.hits == tsearch.SearchResult(scores=ref[q.length], metrics=r.metrics).top_k(K)


def test_warmup_background_hot_swap(linear):
    queries, db, ref, _ = linear
    eng = _engine(wave_compose=True)
    packed = eng._resident_packed(db)
    q = queries[75]
    assert eng._compose_for(q, packed)  # cold: composed
    before = eng.search(q, db)
    t = eng.warmup_background([q], db)
    t.join(timeout=300)
    assert not t.is_alive() and eng._warmup_bg_error is None
    assert eng._fused_warm == {96} and not eng._compose_for(q, packed)  # hot: fused
    assert np.array_equal(eng.search(q, db).scores, before.scores)
    assert np.array_equal(before.scores, ref[75])
    assert eng._compose_for(queries[170], packed)  # another length stays composed
    assert np.array_equal(eng.search(queries[170], db).scores, ref[170])


def test_warmup_then_novel_length(linear, monkeypatch):
    """warmup runs each rung of a 480-residue query once a bucket; a novel
    length composed of those rungs scores as swtpu's."""
    queries, db, ref, _ = linear
    eng = _engine(wave_compose=True)
    n_buckets = len(eng._resident_packed(db).wave_groups)
    spy = _Spy(monkeypatch)
    assert eng.warmup([queries[480], queries[480]], db) >= 0.0
    assert sorted(c[0] for c in spy.calls) == sorted(g * W for g in (8, 4, 2, 1) for _ in range(n_buckets))
    assert np.array_equal(eng.search(queries[NOVEL], db).scores, ref[NOVEL])
    assert _engine(device_resident=False).warmup([queries[20]], db) == 0.0  # a streamed database: nothing to warm


def test_warmer_failure_is_kept_and_serving_goes_on(linear, monkeypatch):
    queries, db, ref, _ = linear
    eng = _engine(wave_compose=True)

    def broken(*a, **kw):
        raise RuntimeError("boom")

    monkeypatch.setattr(eng, "_packed_step", broken)
    t = eng.warmup_background([queries[75]], db)
    t.join(timeout=300)
    assert isinstance(eng._warmup_bg_error, RuntimeError) and not eng._fused_warm
    assert np.array_equal(eng.search(queries[75], db).scores, ref[75])  # still composed


def test_composed_chain_over_the_scratch_share_raises(linear, monkeypatch):
    queries, db, _, _ = linear
    monkeypatch.setattr(tsearch, "scratch_budget_bytes", lambda device: 1)
    with pytest.raises(RuntimeError, match="out of memory"):
        _engine(wave_compose=True).search(queries[75], db)


# --- config and CLI ---------------------------------------------------------------------


def test_compose_config_validation():
    with pytest.raises(ValueError, match="query_shard"):
        SWConfig(wave_compose=True, query_shard=True)
    for kw in (dict(use_wave=False), dict(score_dtype="int16")):
        with pytest.raises(ValueError, match="wavefront"):
            SearchEngine(SWConfig(wave_compose=True, **kw), device="cpu")
    assert SWConfig(wave_compose=True).wave_compose


def test_cli_compose_prints_the_same_dump(tmp_path, capsys):
    from swtpu_torch.cli import main

    rng = np.random.default_rng(6)
    (tmp_path / "q.fasta").write_text(f">q\n{_seq(rng, 100)}\n")
    (tmp_path / "db.fasta").write_text("".join(f">s{i}\n{_seq(rng, n)}\n" for i, n in enumerate(rng.integers(5, 300, 50))))
    args = ["--query", str(tmp_path / "q.fasta"), "--db", str(tmp_path / "db.fasta"), "--device", "cpu"]
    dumps = []
    for extra in ([], ["--compose"]):
        assert main(args + extra) == 0
        dumps.append([ln for ln in capsys.readouterr().out.splitlines() if ln and ln.split(":")[0].isdigit()])
    assert len(dumps[0]) == 50 and dumps[0] == dumps[1]
