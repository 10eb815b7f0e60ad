"""Batched, queued and streaming serving, device top-K and E-values of the
port, held to swtpu and to the port's own single searches on the CPU.

swtpu runs its wavefront path in interpret mode
(``SWConfig(use_wave=True, interpret=True)``); its results are computed
once per module, since every interpret-mode shape compiles anew.  Scores
and hits are exact; E-values and bits agree with swtpu's full-array fit
within rel 0.02 (the tolerance of tests/test_evalue_modes.py) and with the
port's own full-array fit within rel 1e-9.
"""

import dataclasses

import numpy as np
import pytest
import torch

import swtpu.stats as jstats
from swtpu.alphabet import encode_str as j_encode
from swtpu.config import SWConfig as JConfig
from swtpu.io.fasta import Query as JQuery
from swtpu.io.fasta import database_from_sequences as j_database_from_sequences
from swtpu.models.search import SearchEngine as JEngine
from swtpu_torch import stats as tstats
from swtpu_torch.alphabet import encode_str
from swtpu_torch.config import SWConfig
from swtpu_torch.io.fasta import Query, database_from_sequences
from swtpu_torch.models import search as tsearch
from swtpu_torch.models.search import SearchEngine, SearchResult
from swtpu_torch.ops import wave_sw

ALPHABET = "ARNDCQEGHILKMFPSTWYV"
JWAVE = dict(use_wave=True, interpret=True)
QLENS = (20, 25, 28, 30, 31, 100)  # serving ladder: a piece of 4, a lone piece of 1, and a lone 128-row query
K = 7


def _seq(rng, n):
    return "".join(rng.choice(list(ALPHABET), size=int(n)))


@pytest.fixture(scope="module")
def workload():
    rng = np.random.default_rng(77)
    lens = rng.integers(10, 200, 40)
    lens[[3, 17]] = 0  # zero-length records score 0
    seqs = [_seq(rng, n) for n in lens]
    qstrs = [_seq(rng, n) for n in QLENS]
    seqs[5] = qstrs[0] + seqs[5][:30]  # a planted homolog
    port = ([Query(f"q{i}", encode_str(s), s) for i, s in enumerate(qstrs)], database_from_sequences(seqs))
    jax = ([JQuery(f"q{i}", j_encode(s), s) for i, s in enumerate(qstrs)], j_database_from_sequences(seqs))
    return port, jax


@pytest.fixture(scope="module")
def swtpu_full(workload):
    """swtpu's batched and queued full-array results, with E-value statistics."""
    _, (queries, db) = workload
    eng = JEngine(JConfig(evalue=True, **JWAVE))
    return eng.search_many(queries, db), eng.search_queued(queries, db)


@pytest.fixture(scope="module")
def swtpu_topk(workload):
    _, (queries, db) = workload
    return JEngine(JConfig(top_k=K, evalue=True, **JWAVE)).search_many(queries, db)


@pytest.fixture(scope="module")
def port_single(workload):
    (queries, db), _ = workload
    eng = SearchEngine(SWConfig(evalue=True), device="cpu")
    return [eng.search(q, db) for q in queries]


def _assert_close_stats(got, ref, rel):
    assert [(h.id, h.score) for h in got] == [(h.id, h.score) for h in ref]
    for g, r in zip(got, ref):
        assert g.evalue == pytest.approx(r.evalue, rel=rel)
        assert g.bits == pytest.approx(r.bits, rel=rel)


# --- padding and pieces -----------------------------------------------------------


@pytest.mark.parametrize("ladder", [None, True, False])
def test_query_pad_matches_swtpu(ladder):
    mine = SearchEngine(SWConfig(query_ladder=ladder), device="cpu")
    ref = JEngine(JConfig(query_ladder=ladder))
    for serving in (False, True):
        for quantum in (wave_sw.W, 64):
            for qlen in range(1, 6001):
                assert mine._query_pad(qlen, quantum, serving) == ref._query_pad(qlen, quantum, serving)


@pytest.mark.parametrize("ladder", [None, True, False])
def test_query_pieces_matches_swtpu(ladder):
    rng = np.random.default_rng(5)
    lengths = list(rng.integers(1, 6001, 60)) + [40] * 37 + [300] * 5 + [1, 6000]
    rng.shuffle(lengths)
    mine = SearchEngine(SWConfig(query_ladder=ladder), device="cpu")
    ref = JEngine(JConfig(query_ladder=ladder))
    qs = [Query("q", np.zeros(int(n), np.int8), "") for n in lengths]
    jqs = [JQuery("q", np.zeros(int(n), np.int8), "") for n in lengths]
    for serving in (False, True):
        pieces = mine._query_pieces(qs, serving=serving)
        assert pieces == ref._query_pieces(jqs, serving=serving)
        assert all(len(p) in (1, 2, 4, 8, 16) for _, p in pieces)


# --- batched and queued serving ---------------------------------------------------


def test_search_many_matches_swtpu_and_single(workload, swtpu_full, port_single):
    (queries, db), _ = workload
    eng = SearchEngine(SWConfig(), device="cpu")
    many = eng.search_many(queries, db)
    assert [len(p) for _, p in eng._query_pieces(queries)] == [4, 1, 1]
    for res, ref, single in zip(many, swtpu_full[0], port_single):
        assert np.array_equal(res.scores, ref.scores)
        assert np.array_equal(res.scores, single.scores)
        assert res.metrics.attributed and res.metrics.to_dict()["attributed"]
        assert res.metrics.device_seconds > 0
    assert (many[0].scores[[3, 17]] == 0).all()
    assert eng.search_many([], db) == []


def test_search_queued_matches_swtpu_and_single(workload, swtpu_full, port_single):
    (queries, db), _ = workload
    queued = SearchEngine(SWConfig(), device="cpu").search_queued(queries, db)
    for res, ref, single in zip(queued, swtpu_full[1], port_single):
        assert np.array_equal(res.scores, ref.scores)
        assert np.array_equal(res.scores, single.scores)
        assert res.metrics.attributed
    assert SearchEngine(SWConfig(), device="cpu").search_queued([], db) == []


def test_search_many_splits_a_piece_whose_carry_exceeds_the_budget(workload, port_single, monkeypatch):
    (queries, db), _ = workload
    calls = []
    real = wave_sw.sw_wave

    def spy(profile, subjT, **kw):
        calls.append(tuple(profile.shape))
        return real(profile, subjT, **kw)

    spy.launches = spy.multi_launches = 0
    monkeypatch.setattr(wave_sw, "sw_wave", spy)
    monkeypatch.setattr(tsearch, "scratch_budget_bytes", lambda device: 1)  # one query per launch
    # One band a pass, so a 4-band piece crosses pass boundaries and needs a carry a query
    # (the kernel's own shapes take 4 bands in one pass, with no carry).
    monkeypatch.setattr(wave_sw, "wave_shape", lambda n_bands, lanes, n_segs, affine=False: (1, wave_sw.W))
    many = SearchEngine(SWConfig(), device="cpu").search_many([queries[5]] * 3, db)  # 4 bands: a carry
    for res in many:
        assert np.array_equal(res.scores, port_single[5].scores)
    stacks = [shape for shape in calls if len(shape) == 3]
    assert stacks and all(shape[0] == 1 for shape in stacks)
    assert len(stacks) == 3 * len(SearchEngine(SWConfig(), device="cpu").pack_to_device(db).wave_groups)


@pytest.mark.parametrize("seqs", [[], ["", "", ""]], ids=["no records", "only empty records"])
@pytest.mark.parametrize("config", [dict(), dict(top_k=3, evalue=True), dict(device_resident=False)])
def test_serving_paths_on_databases_with_nothing_to_launch(seqs, config):
    q = Query("q", encode_str("ACDEFGHIK"), "ACDEFGHIK")
    db = database_from_sequences(seqs)
    eng = SearchEngine(SWConfig(**config), device="cpu")
    for res in [eng.search(q, db), *eng.search_many([q, q], db), *eng.search_queued([q], db)]:
        assert res.scores.tolist() == [0] * len(seqs)
        assert res.top_k(3) == [(i, 0) for i in range(len(seqs))]


# --- device top-K -------------------------------------------------------------------


@pytest.mark.parametrize("path", ["single", "many", "queued"])
def test_topk_hits_match_swtpu(workload, swtpu_topk, port_single, path):
    (queries, db), _ = workload
    eng = SearchEngine(SWConfig(top_k=K), device="cpu")
    res = {
        "single": lambda: [eng.search(q, db) for q in queries],
        "many": lambda: eng.search_many(queries, db),
        "queued": lambda: eng.search_queued(queries, db),
    }[path]()
    for r, ref, single in zip(res, swtpu_topk, port_single):
        assert r.scores is None  # hits only: the full array stayed on the device
        assert r.hits == ref.hits == single.top_k(K)
        assert r.null_stats is None


@pytest.mark.parametrize("path", ["single", "many", "queued"])
def test_topk_tie_heavy_database_falls_back_to_full_array(path):
    rng = np.random.default_rng(10)
    base = _seq(rng, 40)
    seqs = [base] * 150 + [_seq(rng, n) for n in rng.integers(40, 80, 30)]
    q = Query("q", encode_str(base), base)
    expect = JEngine(JConfig(top_k=5)).search(JQuery("q", j_encode(base), base), j_database_from_sequences(seqs))
    db = database_from_sequences(seqs)
    eng = SearchEngine(SWConfig(top_k=5), device="cpu")
    res = {"single": lambda: eng.search(q, db), "many": lambda: eng.search_many([q], db)[0],
           "queued": lambda: eng.search_queued([q], db)[0]}[path]()
    assert res.scores is not None, "boundary ties must send the query to the full array"
    assert res.top_k(5) == expect.top_k(5) == [(i, int(res.scores[0])) for i in range(5)]


def test_device_topk_orders_ties_by_id():
    """The (score, id) keys give one order, (score desc, id asc), whatever
    the bucket layout; the hits resolve from it and stop at ties that run
    past the candidate set."""

    class Db:
        lengths = np.array([5] * 10)

    flat = torch.tensor([[3, 7, 9, 7, 0, 7, 5, 5, 3, 1]], dtype=torch.int32)  # flat position = slot
    ids = np.array([4, 8, 0, 2, -1, 1, 6, 5, 3, 7])  # slot -> file id, -1 = pad
    low = torch.from_numpy(np.where(ids >= 0, tsearch._ID_MASK - ids, 0))
    vals, got, _ = SearchEngine._topk_reduce(flat, (10, 6, low, None, None))
    assert vals.tolist() == [[9, 7, 7, 7, 5, 5]] and got.tolist() == [[0, 1, 2, 8, 5, 6]]
    vals, got = vals[0].numpy(), got[0].numpy()
    assert SearchEngine._resolve_topk_hits(vals, got, 4, 6, 10, Db) == [(0, 9), (1, 7), (2, 7), (8, 7)]
    assert SearchEngine._resolve_topk_hits(vals, got, 5, 6, 10, Db) is None  # the 5th ties the last fetched


# --- E-values ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["single_topk", "many_topk", "queued_topk", "many_full", "queued_full", "streamed"])
def test_evalues_match_full_array_fits(workload, swtpu_full, port_single, path):
    (queries, db), _ = workload
    topk = SearchEngine(SWConfig(top_k=K, evalue=True), device="cpu")
    full = SearchEngine(SWConfig(evalue=True), device="cpu")
    res = {
        "single_topk": lambda: [topk.search(q, db) for q in queries],
        "many_topk": lambda: topk.search_many(queries, db),
        "queued_topk": lambda: topk.search_queued(queries, db),
        "many_full": lambda: full.search_many(queries, db),
        "queued_full": lambda: full.search_queued(queries, db),
        "streamed": lambda: SearchEngine(SWConfig(evalue=True, device_resident=False), device="cpu").search_many(queries, db),
    }[path]()
    for r, single, ref in zip(res, port_single, swtpu_full[0]):
        assert r.null_stats is not None
        got = r.top_k_stats(K)
        _assert_close_stats(got, single.top_k_stats(K), rel=1e-9)
        _assert_close_stats(got, ref.top_k_stats(K), rel=0.02)
    assert res[0].top_k_stats(1)[0].id == 5 and res[0].top_k_stats(1)[0].evalue < 1e-3  # the planted homolog


def test_evalue_trim_above_coverage_raises(workload):
    (queries, _), _ = workload
    rng = np.random.default_rng(3)
    db = database_from_sequences([_seq(rng, n) for n in rng.integers(20, 60, 300)])
    res = SearchEngine(SWConfig(top_k=5, evalue=True), device="cpu").search(queries[0], db)
    with pytest.raises(ValueError, match="trim"):
        res.top_k_stats(5, trim=0.9)
    assert res.top_k_stats(5)
    no_null = SearchEngine(SWConfig(top_k=5), device="cpu").search(queries[0], db)
    with pytest.raises(ValueError, match="full score array"):
        no_null.top_k_stats(5)


@pytest.mark.parametrize("shape", [(257,), (3, 1000)])
def test_null_moments_exact_against_numpy_int64(shape):
    rng = np.random.default_rng(sum(shape))
    nb = 12
    flat = rng.integers(0, 40000, shape).astype(np.int32)
    flat[..., ::7] = 0
    bins = rng.integers(0, nb + 1, shape[-1]).astype(np.int64)  # nb = the pad slots' overflow bin
    got = tsearch._null_moments(torch.from_numpy(flat), torch.from_numpy(bins), nb).numpy()
    f = flat.astype(np.int64).reshape(-1, shape[-1])
    want = []
    for row in f:
        nz = row > 0
        per = [np.array([row[(bins == b) & nz].size if kind == 0 else (row[bins == b] ** kind).sum()
                         for b in range(nb)]) for kind in (0, 1, 2)]
        want.append(np.concatenate([[nz.sum(), row.sum(), (row * row).sum()], *per]))
    assert got.dtype == np.int64
    assert np.array_equal(got.reshape(-1, 3 + 3 * nb), np.array(want, dtype=np.int64))


def test_stats_copy_matches_swtpu():
    rng = np.random.default_rng(8)
    scores = rng.gumbel(30, 5, 5000).clip(0).astype(np.int32)
    lengths = rng.integers(0, 900, 5000)
    hits = [(int(i), int(scores[i])) for i in np.argsort(-scores)[:10]]
    args = dict(n_subjects=5000, query_length=120, mean_subject_length=float(lengths.mean()), lengths=lengths)
    mine_null, ref_null = tstats.null_stats_from_scores(scores, **args), jstats.null_stats_from_scores(scores, **args)
    # The copy orders tied top scores by index (swtpu leaves it to argpartition):
    # the top values and the pooled fit are swtpu's exactly, and the top bins
    # follow (score desc, index asc).
    assert np.array_equal(mine_null.top_vals, ref_null.top_vals)
    assert dataclasses.astuple(mine_null.fit()) == dataclasses.astuple(ref_null.fit())
    nz = scores > 0
    order = np.lexsort((np.arange(nz.sum()), -scores[nz]))[: mine_null.top_vals.size]
    bins = tstats.length_bin_ids(lengths[nz], tstats.length_bin_edges(lengths))
    assert np.array_equal(mine_null.top_bins, bins[order])
    mine = tstats.hit_significance(mine_null, hits)
    ref = jstats.hit_significance(ref_null, hits)
    for m, r in zip(mine, ref):
        assert (m.id, m.score) == (r.id, r.score)
        assert m.evalue == pytest.approx(r.evalue, rel=0.02) and m.bits == pytest.approx(r.bits, rel=0.02)
    pooled = dict(args, lengths=None)
    assert tstats.hit_significance(tstats.null_stats_from_scores(scores, **pooled), hits) == [
        tstats.HitStat(h.id, h.score, h.evalue, h.bits)
        for h in jstats.hit_significance(jstats.null_stats_from_scores(scores, **pooled), hits)
    ]
    assert tstats.DEFAULT_TRIM == jstats.DEFAULT_TRIM
    assert np.array_equal(tstats.length_bin_edges(lengths), jstats.length_bin_edges(lengths))


# --- streaming ---------------------------------------------------------------------------


@pytest.mark.parametrize("config", [dict(device_resident=False), dict(device_resident_cells=1000)])
def test_streaming_equals_resident(workload, port_single, config):
    (queries, db), _ = workload
    eng = SearchEngine(SWConfig(**config), device="cpu")
    for res, single in zip(eng.search_many(queries, db), port_single):
        assert np.array_equal(res.scores, single.scores)
        assert res.metrics.attributed
    for res, single in zip(eng.search_queued(queries[:2], db), port_single):
        assert np.array_equal(res.scores, single.scores)
    assert np.array_equal(eng.search(queries[5], db).scores, port_single[5].scores)
    assert eng._resident is None  # nothing was packed resident


def test_streaming_keeps_at_most_two_buckets_in_flight(workload, port_single, monkeypatch):
    (queries, db), _ = workload
    from swtpu_torch.utils import bucketing

    orig_plan = bucketing.plan_wave_buckets

    def split_plan(db_, *a, **kw):  # many small buckets: the bound needs at least three
        return [(width, ids[s : s + 4], bt, bpad, n_segs)
                for width, ids, bt, bpad, n_segs in orig_plan(db_, *a, **kw) for s in range(0, len(ids), 4)]

    monkeypatch.setattr(bucketing, "plan_wave_buckets", split_plan)
    eng = SearchEngine(SWConfig(device_resident=False), device="cpu")
    live = {"now": 0, "max": 0, "issued": 0}
    stream, drain = eng._stream_bucket, eng._drain_streamed

    def counted_stream(*a):
        live["now"] += 1
        live["issued"] += 1
        live["max"] = max(live["max"], live["now"])
        return stream(*a)

    def counted_drain(*a):
        live["now"] -= 1
        return drain(*a)

    monkeypatch.setattr(eng, "_stream_bucket", counted_stream)
    monkeypatch.setattr(eng, "_drain_streamed", counted_drain)
    res = eng.search_many(queries, db)
    assert live["issued"] >= 3 and live["max"] == 2 and live["now"] == 0
    for r, single in zip(res, port_single):
        assert np.array_equal(r.scores, single.scores)


# --- CLI ---------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_files(tmp_path_factory):
    rng = np.random.default_rng(6)
    d = tmp_path_factory.mktemp("cli")
    qs = _seq(rng, 40)
    (d / "q.fasta").write_text(f">q\n{qs}\n")
    recs = [f">s{i}\n" + _seq(rng, 60) for i in range(80)] + [">hom\n" + qs]
    (d / "db.fasta").write_text("\n".join(recs) + "\n")
    return ["--query", str(d / "q.fasta"), "--db", str(d / "db.fasta")]


def _hit_lines(out):
    return [ln for ln in out.splitlines() if ln and ln.split(":")[0].isdigit()]


@pytest.mark.parametrize("flags", [["--top-k", "5"], ["--top-k", "5", "--evalue"], ["--top-k", "5", "--evalue", "--max-evalue", "1e-3"]])
def test_cli_topk_evalue_match_swtpu_cli(cli_files, capsys, flags):
    from swtpu.cli import main as jmain
    from swtpu_torch.cli import main as tmain

    assert jmain(cli_files + flags) == 0
    ref = _hit_lines(capsys.readouterr().out)
    assert tmain(cli_files + flags + ["--device", "cpu"]) == 0
    mine = _hit_lines(capsys.readouterr().out)
    assert len(mine) == len(ref) == (1 if "--max-evalue" in flags else 5)
    assert mine[0].startswith("80:")  # the homolog
    for m, r in zip(mine, ref):
        m_f, r_f = m.split("\t"), r.split("\t")
        assert m_f[0] == r_f[0]  # id:score
        if "--evalue" in flags:
            assert float(m_f[1][2:]) == pytest.approx(float(r_f[1][2:]), rel=0.02)
            assert float(m_f[2][5:]) == pytest.approx(float(r_f[2][5:]), abs=0.1)


@pytest.mark.parametrize("flags", [["--evalue"], ["--top-k", "5", "--max-evalue", "1.0"], ["--top-k", "0"]])
def test_cli_flag_errors_exit_2(cli_files, capsys, flags):
    from swtpu_torch.cli import main as tmain

    assert tmain(cli_files + flags + ["--device", "cpu"]) == 2
    assert "error" in capsys.readouterr().err


def test_result_top_k_from_hits():
    from swtpu_torch.utils.metrics import SearchMetrics

    m = SearchMetrics(10, 3, 30, 32, 0, 1.0, 1.0)
    res = SearchResult(scores=None, metrics=m, hits=[(2, 9), (0, 4), (1, 4)])
    assert res.top_k(2) == [(2, 9), (0, 4)]
    assert res.top_k(5) == res.hits  # the database has only 3 sequences
    short = SearchResult(scores=None, metrics=SearchMetrics(10, 50, 30, 32, 0, 1.0, 1.0), hits=[(2, 9)])
    with pytest.raises(ValueError, match="top_k"):
        short.top_k(2)
