"""swtpu_torch's k-mer prefilter against swtpu's, on the CPU.

The same seeded inputs (numpy) go through ``swtpu.ops.prefilter`` and
``swtpu_torch.ops.prefilter``: signatures, counts, raw-ranked ids, the
candidate merges and the device bucket are held exactly equal.  The z-score
is held within rtol 1e-6: XLA's and torch's float32 ``rsqrt`` each miss the
correctly rounded value by up to 1 ulp, on different inputs, so z-ranked ids
may differ only where z lies within that band of the n_cand-th z.  The
engines (swtpu at ``use_wave=False``; the port on both paths) give equal hits
and E-values on the bundled subset, where the two candidate sets are equal,
and a single search answers as a one-query ``search_many``, launches
included.  The plain versions of the int8 kernels and the K8 chain are held to numpy.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.config import SWConfig as JConfig
from swtpu.io.fasta import Database as JDatabase
from swtpu.io.fasta import parse_database as j_parse_database
from swtpu.io.fasta import parse_query as j_parse_query
from swtpu.models.search import SearchEngine as JEngine
from swtpu.ops import prefilter as jpf
from swtpu_torch.config import SWConfig
from swtpu_torch.io.fasta import Database, Query, database_from_sequences, parse_database, parse_query
from swtpu_torch.models.search import SearchEngine
from swtpu_torch.ops import int8_mma, vpu_chain
from swtpu_torch.ops import prefilter as pf
from swtpu_torch.utils.bucketing import pack_wave_group, upload_residues

DATA = "tests/data"
SUBSET = f"{DATA}/uniprot_subset.fasta"
QUERIES = ("P02232", "P01008", "P05013")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: intra-op threads only contend with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _db(seed, n=60, hi=90):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, hi, n)
    lens[::17] = 0  # empty records
    lens[1::19] = 2  # shorter than K
    off = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=off[1:])
    res = rng.integers(0, 25, int(off[-1])).astype(np.int8)
    return Database(residues=res, offsets=off), JDatabase(residues=res, offsets=off)


# --- host signatures ---------------------------------------------------------------------


@pytest.mark.parametrize("dim", [64, 1024, 2048])
def test_signatures_equal_swtpu(dim):
    db, jdb = _db(dim)
    for i in range(db.n):
        r = db.sequence(i)
        assert np.array_equal(pf.kmer_hashes(r, dim), jpf.kmer_hashes(r, dim))
        assert np.array_equal(pf.signature(r, dim), jpf.signature(r, dim))
    mine = pf.database_signatures_plain(db, dim, chunk=101)  # a small chunk crosses record boundaries
    assert mine.dtype == np.int8 and mine.shape == (db.n, dim)
    assert np.array_equal(mine, jpf.database_signatures(jdb, dim))
    assert np.array_equal(mine, np.stack([pf.signature(db.sequence(i), dim) for i in range(db.n)]))


# --- the coarse pass ---------------------------------------------------------------------------


def _coarse_inputs(seed=8, n=400, n_q=3, dim=pf.DIM):
    """tests/test_prefilter.py's coarse-candidate data, with Q queries."""
    rng = np.random.default_rng(seed)
    sig = (rng.random((n, dim)) < 0.15).astype(np.int8)
    qsigs = (rng.random((n_q, dim)) < 0.2).astype(np.int8)
    return sig, qsigs, sig.sum(axis=1, dtype=np.int32)


def test_coarse_scores_and_zscores_match_swtpu():
    sig, qsigs, pop = _coarse_inputs()
    for q in qsigs:
        got = pf.coarse_scores(torch.from_numpy(sig), torch.from_numpy(q))
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(jpf.coarse_scores(jnp.asarray(sig), jnp.asarray(q))))
        z = pf.coarse_zscores(torch.from_numpy(sig), torch.from_numpy(pop), torch.from_numpy(q))
        jz = np.asarray(jpf.coarse_zscores(jnp.asarray(sig), jnp.asarray(pop), jnp.asarray(q)))
        assert z.dtype == torch.float32
        np.testing.assert_allclose(z.numpy(), jz, rtol=1e-6, atol=0)


def _assert_candidates_match(got, want, z_ref, n_cand):
    """Raw-ranked ids and the max exactly; z-ranked ids outside the rtol
    1e-6 band around the n_cand-th z exactly, in order."""
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
    kth = np.sort(z_ref)[::-1][n_cand - 1]
    band = set(np.nonzero(np.abs(z_ref - kth) <= 1e-6 * abs(kth))[0].tolist())
    assert [i for i in got[0].tolist() if i not in band] == [i for i in want[0].tolist() if i not in band]


def _coarse(sig, pop, qsigs, n_cand):
    """The port's coarse pass as the engine runs it (``_coarse_rank``): K7's
    counts, then ``candidates_from_counts``."""
    q = qsigs.to(torch.int8).contiguous()
    return pf.candidates_from_counts(int8_mma.coarse_counts(q, sig), pop, q, n_cand)


@pytest.mark.parametrize("n_cand", [1, 37, 400])
def test_coarse_candidates_match_swtpu(n_cand):
    sig, qsigs, pop = _coarse_inputs()
    tsig, tpop = torch.from_numpy(sig), torch.from_numpy(pop)
    many = _coarse(tsig, tpop, torch.from_numpy(qsigs), n_cand).numpy()
    jmany = np.asarray(jpf.coarse_candidates_many(jnp.asarray(sig), jnp.asarray(pop), jnp.asarray(qsigs), n_cand=n_cand))
    assert many.shape == jmany.shape == (len(qsigs), 3, n_cand)
    for row, q in enumerate(qsigs):
        one = _coarse(tsig, tpop, torch.from_numpy(q)[None], n_cand)[0].numpy()
        assert np.array_equal(one, many[row])
        jone = np.asarray(jpf.coarse_candidates(jnp.asarray(sig), jnp.asarray(pop), jnp.asarray(q), n_cand=n_cand))
        z_ref = np.asarray(jpf.coarse_zscores(jnp.asarray(sig), jnp.asarray(pop), jnp.asarray(q)))
        _assert_candidates_match(one, jone, z_ref, n_cand)
        _assert_candidates_match(many[row], jmany[row], z_ref, n_cand)
        # the host selection's lowest-id tie-break, as swtpu's own test holds it
        raw = pf.coarse_scores(tsig, torch.from_numpy(q)).numpy()
        z = pf.coarse_zscores(tsig, tpop, torch.from_numpy(q)).numpy()
        assert np.array_equal(pf.merge_candidates(one[0], one[1], n_cand), pf.select_candidates([z, raw], n_cand))


def test_top_ids_break_ties_by_lowest_id():
    x = torch.tensor([[5, 9, 5, 9, 1, 5]], dtype=torch.int32)
    assert pf._top_ids(x, 4).tolist() == [[1, 3, 0, 2]]
    z = torch.tensor([0.5, -1.0, 0.5, 2.0, 0.5], dtype=torch.float32)
    assert pf._top_ids(z, 3).tolist() == [3, 0, 2]


def test_merge_and_select_candidates_match_swtpu():
    rng = np.random.default_rng(3)
    for n, n_cand in ((50, 7), (30, 30), (200, 64)):
        a = rng.integers(0, 5, n).astype(np.float64)
        b = rng.integers(0, 9, n).astype(np.int32)
        assert np.array_equal(pf.select_candidates([a, b], n_cand), jpf.select_candidates([a, b], n_cand))
        assert np.array_equal(pf.select_candidates(b, n_cand), jpf.select_candidates(b, n_cand))
        za = np.lexsort((np.arange(n), -a))[:n_cand]
        rb = np.lexsort((np.arange(n), -b))[:n_cand]
        assert np.array_equal(pf.merge_candidates(za, rb, n_cand), jpf.merge_candidates(za, rb, n_cand))


# --- the candidate bucket and the sub-database ---------------------------------------------


@pytest.mark.parametrize("width,bpad", [(64, 8), (96, 256), (992, 16)])
def test_gather_stack_equals_pack_wave_group(width, bpad):
    db, _ = _db(9, n=40, hi=min(width, 90))
    cand = np.array([3, 0, 17, 39, 5, 1], dtype=np.int64)  # 0 and 17 are empty records
    cand_pad = np.full(bpad, -1, dtype=np.int64)
    cand_pad[: cand.shape[0]] = cand
    flat = upload_residues(db, "cpu")
    got = pf.gather_stack(flat, torch.from_numpy(db.offsets), torch.from_numpy(cand_pad), width)
    want = pack_wave_group(db, width, cand, bt=128, bpad=bpad).stack
    assert got.dtype == torch.int8 and got.shape == (width + 32, bpad)
    assert torch.equal(got, want)


def test_database_take_matches_swtpu():
    seqs = [b"MKVL", b"", b"CCDE", b"AAAA", b"WY"]
    db = database_from_sequences(seqs)
    jdb = j_parse_database(SUBSET)
    for ids in (np.array([3, 0, 4]), np.array([], dtype=np.int64), np.array([1, 1, 2])):
        sub = db.take(ids)
        assert sub.n == ids.shape[0]
        assert [bytes(sub.sequence(i)) for i in range(sub.n)] == [bytes(db.sequence(int(i))) for i in ids]
    ids = np.array([110, 3, 57, 0, 57])
    mine, ref = parse_database(SUBSET).take(ids), jdb.take(ids)
    assert np.array_equal(mine.residues, ref.residues) and np.array_equal(mine.offsets, ref.offsets)


# --- the engines --------------------------------------------------------------------------------


def _candidates(sig, pop, qres, n_cand, package):
    """A query's merged candidate set through one package's coarse pass."""
    if package == "swtpu":
        packed = np.asarray(jpf.coarse_candidates(jnp.asarray(sig), jnp.asarray(pop), jnp.asarray(jpf.signature(qres)), n_cand=n_cand))
    else:
        packed = _coarse(torch.from_numpy(sig), torch.from_numpy(pop), torch.from_numpy(pf.signature(qres))[None], n_cand)[0].numpy()
    return pf.merge_candidates(packed[0], packed[1], n_cand)


# With E-values the 2,048-id calibration sample covers the whole subset, so
# every candidate set is exhaustive: one query shows the sampled null.
@pytest.mark.parametrize("evalue,names", [(False, QUERIES), (True, ("P05013",))], ids=["hits", "evalue"])
def test_engine_prefilter_matches_swtpu(evalue, names):
    db, jdb = parse_database(SUBSET), j_parse_database(SUBSET)
    queries = [parse_query(f"{DATA}/queries/{n}.fasta") for n in names]
    jqueries = [j_parse_query(f"{DATA}/queries/{n}.fasta") for n in names]
    knobs = dict(prefilter=0.2, top_k=5, prefilter_min_candidates=1, evalue=evalue)
    sig = pf.database_signatures(db)
    pop = sig.sum(axis=1, dtype=np.int32)
    n_cand = 23  # ceil(0.2 * 111): a real cut of the 111 sequences
    for q in queries:  # the premise of equal hits: equal candidate sets at these inputs
        assert np.array_equal(_candidates(sig, pop, q.residues, n_cand, "port"), _candidates(sig, pop, q.residues, n_cand, "swtpu"))
    jeng = JEngine(JConfig(**knobs, use_wave=False))
    ref = [jeng.search(q, jdb) for q in jqueries]
    assert [r.hits for r in jeng.search_many(jqueries, jdb)] == [r.hits for r in ref]
    for use_wave in (False, None):  # the row path, and the wavefront path (the port's default)
        eng = SearchEngine(SWConfig(**knobs, use_wave=use_wave), device="cpu")
        long_hits = 0
        for path in ("search", "search_many"):
            results = [eng.search(q, db) for q in queries] if path == "search" else eng.search_many(queries, db)
            for got, want in zip(results, ref):
                assert got.scores is None and got.hits == want.hits
                assert got.metrics.n_subjects == db.n and got.metrics.packed_cells > 0
                if evalue:
                    for g, w in zip(got.top_k_stats(5), want.top_k_stats(5)):
                        assert (g.id, g.score) == (w.id, w.score)
                        assert g.evalue == pytest.approx(w.evalue, rel=1e-9) and g.bits == pytest.approx(w.bits, rel=1e-9)
            # The subset's one record past 992 residues (1,165 aa) is a candidate of
            # every query: the wavefront path scores it on the long route, and it is
            # a top-5 hit of P01008 and P05013, so its score (and with E-values, the
            # null it enters) is held to swtpu's.  With E-values both entry points
            # keep all 111 ids and run the exhaustive engine.  The row path has no
            # long route.
            routed = use_wave is None and not evalue
            assert [r.metrics.long_candidates for r in results] == [int(routed)] * len(queries)
            long_hits += sum(int(db.lengths[i] > 992) for r in results for i, _ in r.hits)
        assert long_hits == (4 if len(queries) == 3 else 2)  # P01008 and P05013, or P05013 alone, on both paths
        if use_wave is False:  # the row path's exact engine packs swtpu's cells
            assert [r.metrics.packed_cells for r in results] == [r.metrics.packed_cells for r in ref]


def test_wave_exact_phase_packs_pinned_widths():
    """The exact phase: candidates of at most 992 residues in one wavefront
    bucket of width 992, lanes a power of two from 256, its padded cells
    counted; the longer ones in one launch of the long route, longest first,
    their 32-row bands times the query's length counted; ids and scores
    those of the exhaustive search, and long_candidates the longer ones."""
    rng = np.random.default_rng(4)
    lens = np.concatenate([rng.integers(20, 900, 300), rng.integers(1000, 1500, 40), [3000]])
    seqs = [rng.integers(0, 20, int(n)).astype(np.int8) for n in lens]
    from swtpu_torch.synth import database_from_arrays
    from swtpu_torch.utils.metrics import PhaseTimer

    db = database_from_arrays(seqs)
    q = Query("q", seqs[5][:40].copy(), "")
    eng = SearchEngine(SWConfig(prefilter=0.3, top_k=3, prefilter_min_candidates=1), device="cpu")
    cand = np.union1d(np.arange(0, db.n, 3), [db.n - 1]).astype(np.int64)  # the longest is the last
    flat, jobs, cells, _ = eng._prefilter_exact_enqueue(q, db, cand, PhaseTimer())
    assert [route for _, _, route in jobs] == ["wave", "long"]
    (short, bpad, _), (long_ids, n_long, _) = jobs
    assert np.array_equal(short, cand[lens[cand] <= 992]) and bpad == 256  # 101 lanes padded to 256
    assert n_long == long_ids.shape[0] == (lens[cand] > 992).sum() and long_ids[0] == db.n - 1
    assert np.all(np.diff(lens[long_ids]) <= 0)  # longest first
    long_cells = int(sum(-(-lens[i] // 32) * 32 for i in long_ids)) * 40
    assert cells == 64 * 256 * (992 + 32) + long_cells  # qpad 64 for 40 residues
    assert flat.shape[0] == 256 + n_long
    ids, scores = eng._prefilter_exact_scores(flat, jobs)
    assert np.array_equal(np.sort(ids), cand)
    exhaustive = SearchEngine(SWConfig(), device="cpu").search(q, db).scores
    assert np.array_equal(scores, exhaustive[ids])
    assert eng._long_candidates(jobs) == n_long
    # a search's counter: the long route's share of its candidates; none
    # when every candidate is at most 992 residues long
    for database in (db, database_from_arrays([x for x in seqs if x.shape[0] <= 992])):
        seen = []
        enqueue = eng._prefilter_exact_enqueue
        eng._prefilter_exact_enqueue = lambda *a: seen.append(enqueue(*a)) or seen[-1]
        res = eng.search(q, database)
        del eng._prefilter_exact_enqueue
        assert res.metrics.long_candidates == eng._long_candidates(seen[0][1])
        assert res.metrics.long_candidates > 0 if database is db else res.metrics.long_candidates == 0


def test_prefilter_fallbacks_match_exhaustive():
    """A query shorter than K, and subjects that share no bucket with the
    query, fall back to exhaustive candidates, on both packages."""
    from swtpu.alphabet import encode_str as j_encode
    from swtpu.io.fasta import Query as JQuery
    from swtpu.io.fasta import database_from_sequences as j_from_sequences
    from swtpu_torch.alphabet import encode_str

    cases = [
        ([b"MKVLAT", b"CCCCCC", b"MKV"], "MK"),  # degenerate query
        ([b"CC"] * 30 + [b"MK"] + [b"CC"] * 9, "MKVLATWWYY"),  # no shared bucket: the best hit is id 30
    ]
    for seqs, qs in cases:
        db = database_from_sequences(seqs)
        q = Query("q", encode_str(qs), qs)
        exact = SearchEngine(SWConfig(), device="cpu").search(q, db).top_k(1)
        ref = JEngine(JConfig(prefilter=0.01, top_k=1, prefilter_min_candidates=1)).search(
            JQuery("q", j_encode(qs), qs), j_from_sequences(seqs))
        eng = SearchEngine(SWConfig(prefilter=0.01, top_k=1, prefilter_min_candidates=1), device="cpu")
        assert eng.search(q, db).hits == exact == ref.hits
        assert [r.hits for r in eng.search_many([q, q], db)] == [exact, exact]
    # search_many with one degenerate query in the batch: the rest share the coarse launch
    db = parse_database(SUBSET)
    full = SearchEngine(SWConfig(), device="cpu")
    eng = SearchEngine(SWConfig(prefilter=0.5, top_k=2, prefilter_min_candidates=1), device="cpu")
    batch = [Query("short", encode_str("AR"), "AR"), parse_query(f"{DATA}/queries/P02232.fasta")]
    got = eng.search_many(batch, db)
    assert got[0].hits == full.search(batch[0], db).top_k(2)
    assert got[1].hits == eng.search(batch[1], db).hits and got[1].metrics.attributed


def _counted(fn):
    """``fn`` counting its calls in ``launches``, as a kernel wrapper counts
    its launches on the card (on the CPU the wrappers run their plain
    versions and count none)."""

    def wrapper(*a, **kw):
        wrapper.launches += 1
        return fn(*a, **kw)

    wrapper.launches = 0
    return wrapper


@pytest.mark.parametrize("gaps", [{}, dict(gap_open=10, gap_extend=2)], ids=["linear", "affine"])
def test_single_prefiltered_search_is_a_batch_of_one(gaps, monkeypatch):
    """A prefiltered ``search`` is a one-query ``search_many`` through the
    same body: the same hits, null statistics, candidate counts and launches
    (one coarse, one K1 and one long-route launch), on a database whose
    candidates reach past 992 residues; only ``attributed`` tells them apart."""
    from swtpu_torch.ops import long_sw, wave_sw
    from swtpu_torch.synth import database_from_arrays

    for mod, name in ((int8_mma, "coarse_counts"), (wave_sw, "sw_wave"), (long_sw, "sw_long")):
        monkeypatch.setattr(mod, name, _counted(getattr(mod, name)))
    rng = np.random.default_rng(9 + len(gaps))
    lens = np.concatenate([rng.integers(20, 90, 2200), rng.integers(993, 1300, 12)])
    seqs = [rng.integers(0, 20, int(n)).astype(np.int8) for n in lens]
    db = database_from_arrays(seqs)
    q = Query("q", seqs[-1][500:540].copy(), "")  # a piece of a long subject
    eng = SearchEngine(SWConfig(prefilter=1e-6, prefilter_min_candidates=64, top_k=5, evalue=True, **gaps),
                       device="cpu")
    single, (many,) = eng.search(q, db), eng.search_many([q], db)
    assert not single.metrics.attributed and many.metrics.attributed
    assert single.hits == many.hits and single.hits[0][0] == db.n - 1
    for m in (single.metrics, many.metrics):
        assert (m.kernel_launches, m.long_candidates) == (3, 12) and 2048 < m.prefilter_candidates < db.n
    assert single.metrics.prefilter_candidates == many.metrics.prefilter_candidates
    for f in dataclasses.fields(single.null_stats):
        a, b = getattr(single.null_stats, f.name), getattr(many.null_stats, f.name)
        assert np.array_equal(a, b) if isinstance(a, np.ndarray) else a == b, f.name
    assert single.top_k_stats(5) == many.top_k_stats(5)


def test_prefilter_config_checks():
    with pytest.raises(ValueError, match="prefilter requires top_k"):
        SWConfig(prefilter=0.1)
    for frac in (1.5, 0.0, -0.1):
        with pytest.raises(ValueError, match="fraction"):
            SWConfig(prefilter=frac, top_k=5)
    with pytest.raises(ValueError, match="prefilter_min_candidates"):
        SWConfig(prefilter=0.1, top_k=5, prefilter_min_candidates=0)
    cfg = SWConfig(prefilter=0.02, top_k=5, prefilter_min_candidates=3)
    assert (cfg.prefilter, cfg.prefilter_min_candidates) == (0.02, 3)
    assert SWConfig(prefilter_min_candidates=7).prefilter is None  # ignored without prefilter, as in swtpu


def test_cli_prefilter_matches_swtpu_cli(capsys):
    from swtpu.cli import main as jmain
    from swtpu_torch.cli import main as tmain

    args = ["--query", f"{DATA}/queries/P01008.fasta", "--db", SUBSET, "--prefilter", "0.45", "--top-k", "5"]
    assert jmain(args) == 0
    ref = [ln for ln in capsys.readouterr().out.splitlines() if ln[:1].isdigit()]
    assert tmain(args + ["--device", "cpu"]) == 0
    mine = [ln for ln in capsys.readouterr().out.splitlines() if ln[:1].isdigit()]
    assert mine == ref and len(mine) == 5
    assert tmain(args[:-2] + ["--device", "cpu"]) == 2  # --prefilter without --top-k
    assert "prefilter requires top_k" in capsys.readouterr().err


# --- the plain versions of the kernels, against numpy ------------------------------------------


@pytest.mark.parametrize("n,n_q,dim", [(1, 1, 64), (15, 2, 1024), (17, 17, 2048), (33, 8, 96)])
def test_coarse_counts_plain_matches_numpy(n, n_q, dim):
    rng = np.random.default_rng(n + dim)
    db = rng.integers(0, 2, (n, dim)).astype(np.int8)
    qs = rng.integers(0, 2, (n_q, dim)).astype(np.int8)
    db[0, :5], qs[0, 2:6] = 5, -5  # signed entries
    want = qs.astype(np.int64) @ db.astype(np.int64).T
    before = int8_mma.coarse_counts.launches
    got = int8_mma.coarse_counts(torch.from_numpy(qs), torch.from_numpy(db))
    assert int8_mma.coarse_counts.launches == before  # the CPU runs the plain version
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(int8_mma.coarse_counts_plain(torch.from_numpy(qs), torch.from_numpy(db), rows=4).numpy(), want)


def test_mma_probe_plain_matches_numpy():
    rng = np.random.default_rng(7)
    a = rng.integers(-5, 5, (16, 64)).astype(np.int8)
    b = rng.integers(0, 2, (64, 32)).astype(np.int8)
    for iters, unroll in ((0, 4), (1, 1), (2, 3), (3, 300)):  # the last wraps int8(i + j) past 255
        want = np.zeros((16, 32), np.int64)
        for i in range(iters):
            for j in range(unroll):
                x = np.array((i + j) & 0xFF, dtype=np.uint8).view(np.int8)
                want = np.maximum(want, (a ^ x).astype(np.int64) @ b.astype(np.int64))
        got = int8_mma.mma_probe(torch.from_numpy(a), torch.from_numpy(b), iters, unroll)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("y_lo", [0, -3], ids=["acc_wins", "x_wins_some"])
def test_vpu_chain_plain_matches_numpy(y_lo):
    rng = np.random.default_rng(2)
    x = rng.integers(0, 1000, (32, 64)).astype(np.int32)
    y = rng.integers(y_lo, 3, (32, 64)).astype(np.int32)
    x_won = False
    for iters in (0, 1, 6):
        acc = x.copy()
        for _ in range(iters * vpu_chain.UNROLL):
            x_won |= bool((acc + y < x).any())
            acc = np.maximum(acc + y, x)
        got = vpu_chain.vpu_chain(torch.from_numpy(x), torch.from_numpy(y), iters)
        assert np.array_equal(got.numpy(), acc)
    assert x_won == (y_lo < 0)  # negative y makes the max pick x on some links


def test_kernel_wrappers_check_their_inputs():
    with pytest.raises(ValueError, match="widths differ"):
        int8_mma.coarse_counts(torch.zeros(1, 64, dtype=torch.int8), torch.zeros(3, 32, dtype=torch.int8))
    with pytest.raises(ValueError, match="int8"):
        int8_mma.coarse_counts(torch.zeros(1, 64, dtype=torch.int32), torch.zeros(3, 64, dtype=torch.int8))
    with pytest.raises(ValueError, match="int8"):
        int8_mma.mma_probe(torch.zeros(16, 64, dtype=torch.int8), torch.zeros(32, 64, dtype=torch.int8), 1)
    with pytest.raises(ValueError, match="int32"):
        vpu_chain.vpu_chain(torch.zeros(32, 8, dtype=torch.int64), torch.zeros(32, 8, dtype=torch.int64), 1)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        int8_mma.coarse_counts(torch.zeros(1, 64, dtype=torch.int8, device="meta"), torch.zeros(3, 64, dtype=torch.int8, device="meta"))
