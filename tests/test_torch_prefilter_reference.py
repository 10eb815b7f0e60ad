"""The prefiltered search against the benchmark's plain reference of its
heuristic, and the per-database values that the search caches.

* ``benchmark/reference/prefilter.py``, loaded by path, works the k-mer
  prefilter out again plainly (signatures, counts, z-scores, the two
  rankings, their merge, the calibration sample, exact scores, the sampled
  null).  On seeded random databases larger than the 2,048-id sample, with
  planted homologs, the port's ``search`` and ``search_many`` score exactly
  the reference's candidate sets (``SearchMetrics.prefilter_candidates``
  counts them), and return its hits (id, score) with E-values and bits
  within 1e-9: linear and affine gaps, E-values on and off, the candidate
  count set by ``prefilter_min_candidates`` and by the fraction.
* ``Database``'s cached ``lengths``, ``largest_length`` and
  ``padded_length_sum`` equal the uncached arithmetic, and the lengths
  are read-only; the null statistics from cached population bins
  (``stats.population_bins``, the engine's ``_population_bins``) are
  bit-identical to those derived from the lengths on every call.
"""

import dataclasses
import importlib
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from swtpu_torch import stats
from swtpu_torch.config import SWConfig
from swtpu_torch.io.fasta import Database, Query
from swtpu_torch.models.search import SearchEngine

REFERENCE = Path(__file__).resolve().parent.parent / "benchmark" / "reference"
GAPS = {"linear": ({"gap": 2}, dict(gap_penalty=2)),
        "affine": ({"gap_open": 10, "gap_extend": 2}, dict(gap_open=10, gap_extend=2))}
# (prefilter, prefilter_min_candidates): 300 candidates at 2,600 subjects (MMseqs2's --max-seqs), or 5% = 130
KNOBS = {"min_candidates": (1e-6, 300), "fraction": (0.05, 8)}
N, TOP_K = 2600, 10


def _reference():
    """The benchmark's ``reference`` package, loaded from its files under a
    name of its own: (prefilter, scoring)."""
    name = "bench_reference"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, REFERENCE / "__init__.py",
                                                      submodule_search_locations=[str(REFERENCE)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.prefilter"), importlib.import_module(f"{name}.scoring")


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _workload(seed: int, n_long: int = 0):
    """(database, queries): N subjects of 20-90 residues, four queries of
    33-140 residues each planted as an exact copy and two 30% mutants, and
    one query with no 3-mer.  With ``n_long``, that many other subjects are
    993-2,000 residues long (past the wavefront bucket's 992: the exact
    phase's long route), and the longest query is planted once more inside
    the first of them."""
    rng = np.random.default_rng(seed)
    qlens = [33, 61, 96, 140]
    queries = [rng.integers(0, 25, L).astype(np.int8) for L in qlens]
    lengths = rng.integers(20, 91, N)
    ids = rng.choice(N, 3 * len(queries), replace=False).reshape(len(queries), 3)
    for q, row in zip(queries, ids):
        lengths[row] = q.size
    if n_long:
        long_ids = rng.choice(np.setdiff1d(np.arange(N), ids.ravel()), n_long, replace=False)
        lengths[long_ids] = rng.integers(993, 2001, n_long)
    offsets = np.zeros(N + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    residues = rng.integers(0, 25, int(offsets[-1])).astype(np.int8)
    for q, row in zip(queries, ids):
        for k, i in enumerate(row):
            copy = q.copy()
            if k:
                hit = rng.random(q.size) < 0.3
                copy[hit] = (copy[hit] + rng.integers(1, 25, int(hit.sum()))) % 25
            residues[offsets[i] : offsets[i + 1]] = copy
    if n_long:
        at = offsets[long_ids[0]] + 400
        residues[at : at + queries[-1].size] = queries[-1]
    queries.append(np.array([3, 7], dtype=np.int8))  # shorter than a 3-mer: no signal, every subject a candidate
    return Database(residues=residues, offsets=offsets), queries


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("evalue", [True, False])
@pytest.mark.parametrize("gaps", list(GAPS))
def test_prefiltered_search_answers_as_the_plain_reference(gaps, evalue, knob, monkeypatch):
    db, qres = _workload(seed=11 + len(gaps) + 2 * evalue + 4 * (knob == "fraction"))
    _assert_answers_as_the_reference(db, qres, gaps, evalue, knob, monkeypatch)


@pytest.mark.parametrize("gaps", list(GAPS))
def test_prefiltered_search_with_long_candidates_answers_as_the_plain_reference(gaps, monkeypatch):
    """Subjects past 992 residues among the candidates: the long route scores
    them (``long_candidates``), and hits and E-values stay the reference's,
    the copy planted inside a long subject among them."""
    db, qres = _workload(seed=21 + len(gaps), n_long=24)
    for results in _assert_answers_as_the_reference(db, qres, gaps, True, "min_candidates", monkeypatch).values():
        assert all(r.metrics.long_candidates > 0 for r in results[:-1])
        assert any(db.lengths[i] > 992 for i, _ in results[3].top_k(TOP_K))  # the 140-aa query's copy


def _assert_answers_as_the_reference(db, qres, gaps, evalue, knob, monkeypatch):
    """The port's ``search`` and ``search_many`` score the reference's
    candidate sets and return its answers; {path: results}."""
    ref_pf, scoring = _reference()
    ref_gaps, engine_gaps = GAPS[gaps]
    fraction, floor = KNOBS[knob]
    engine = SearchEngine(SWConfig(matrix="blosum50_ref", top_k=TOP_K, evalue=evalue, prefilter=fraction,
                                   prefilter_min_candidates=floor, **engine_gaps), device="cpu")
    scored = []
    enqueue = SearchEngine._prefilter_exact_enqueue

    def record(self, query, db_, cand, timer):
        scored.append(np.asarray(cand).copy())
        return enqueue(self, query, db_, cand, timer)

    monkeypatch.setattr(SearchEngine, "_prefilter_exact_enqueue", record)
    n_cand = ref_pf.n_candidates(N, fraction, floor, TOP_K)
    assert n_cand == {"min_candidates": 300, "fraction": 130}[knob]
    residues = torch.from_numpy(db.residues)
    cands = ref_pf.candidates(qres, residues, db.offsets, n_cand, evalue, "cpu")
    assert cands[-1].size == N and all(c.size < N for c in cands[:-1])
    want = ref_pf.answers(qres, cands, residues, db.offsets, scoring.matrix("blosum50_ref"), ref_gaps, TOP_K, evalue,
                          "cpu")
    queries = [Query(name=str(i), residues=r, raw="") for i, r in enumerate(qres)]
    out = {}
    for path in ("search", "search_many"):
        scored.clear()
        results = [engine.search(q, db) for q in queries] if path == "search" else engine.search_many(queries, db)
        out[path] = results
        # every query with a signal went through the exact phase once, on the reference's candidates
        assert len(scored) == len(queries) - 1
        for got_ids, ref_ids in zip(scored, cands[:-1]):
            assert np.array_equal(np.sort(got_ids), ref_ids)
        for r, c, w in zip(results, cands, want):
            assert r.metrics.prefilter_candidates == c.size
            if evalue:
                got = [(h.id, h.score, h.evalue, h.bits) for h in r.top_k_stats(TOP_K)]
                assert [g[:2] for g in got] == [x[:2] for x in w]
                np.testing.assert_allclose(np.array([g[2:] for g in got]), np.array([x[2:] for x in w]), rtol=1e-9,
                                           atol=0)
            else:
                assert r.top_k(TOP_K) == [x[:2] for x in w]
    return out


def test_database_caches_what_it_derives_from_its_offsets():
    db, _ = _workload(seed=3)
    fresh = np.diff(db.offsets).astype(np.int64)
    assert db.lengths is db.lengths and np.array_equal(db.lengths, fresh) and db.lengths.dtype == np.int64
    with pytest.raises(ValueError):
        db.lengths[0] = 1  # shared by every caller: read-only
    assert db.largest_length == int(fresh.max())
    for quantum in (1, 8, 32):
        assert db.padded_length_sum(quantum) == int((-(-fresh // quantum) * quantum).sum())
    empty = Database(residues=np.zeros(0, np.int8), offsets=np.zeros(1, np.int64))
    assert empty.lengths.size == 0 and empty.largest_length == 0 and empty.padded_length_sum(8) == 0
    # a new object derives its own: nothing is shared across databases
    other = dataclasses.replace(db, offsets=db.offsets[:11].copy())
    assert other.lengths.size == 10 and other.padded_length_sum(8) != db.padded_length_sum(8)


def _same(a: stats.NullStats, b: stats.NullStats) -> bool:
    for f in dataclasses.fields(stats.NullStats):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if x is None or y is None:
            if not (x is None and y is None):
                return False
        elif not np.array_equal(np.asarray(x), np.asarray(y)):
            return False
        elif np.asarray(x).dtype != np.asarray(y).dtype:
            return False
    return True


@pytest.mark.parametrize("sampled", [True, False])
def test_cached_population_bins_give_bit_identical_null_stats(sampled):
    db, _ = _workload(seed=5)
    rng = np.random.default_rng(9)
    population = np.diff(db.offsets).astype(np.int64)  # uncached
    ids = np.sort(rng.choice(N, 2048, replace=False)) if sampled else np.arange(N)
    scores = rng.integers(0, 60, ids.size)
    kw = dict(n_subjects=N, query_length=77, mean_subject_length=db.length_sum / N, trim=0.02)
    if sampled:
        plain = stats.null_stats_from_scores(scores, lengths=population[ids], population_lengths=population, **kw)
    else:
        plain = stats.null_stats_from_scores(scores, lengths=population, **kw)
    bins = stats.population_bins(db.lengths)
    cached = stats.null_stats_from_scores(scores, lengths=db.lengths[ids], population_lengths=db.lengths, bins=bins, **kw)
    assert _same(plain, cached)
    engine = SearchEngine(SWConfig(top_k=TOP_K, evalue=True, prefilter=1e-6, prefilter_min_candidates=300), device="cpu")
    got = engine._population_bins(db)
    assert got is engine._population_bins(db) and all(np.array_equal(a, b) for a, b in zip(got, bins))
    if sampled:  # the engine's sampled null: the calibration sample's scores among the rescored ids
        sample = engine._evalue_sample(db)
        full = rng.integers(0, 60, N)
        want = stats.null_stats_from_scores(full[sample], lengths=population[sample], population_lengths=population,
                                            n_subjects=N, query_length=77, mean_subject_length=db.length_sum / N,
                                            trim=engine._top_trim)
        q = Query(name="q", residues=np.zeros(77, np.int8), raw="")
        assert _same(engine._null_from_sample(q, db, np.arange(N)[::-1].copy(), full[::-1].copy()), want)


@pytest.mark.parametrize("evalue", [True, False])
def test_the_cli_json_counts_the_ids_scored_exactly(evalue, capsys):
    import json

    from swtpu_torch.cli import main

    data = Path(__file__).resolve().parent / "data"
    args = ["--query", f"{data}/queries/P01008.fasta", "--db", f"{data}/uniprot_subset.fasta", "--prefilter", "0.45",
            "--top-k", "5", "--json", "--device", "cpu"] + (["--evalue"] if evalue else [])
    assert main(args) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    # 111 subjects, fewer than the default floor of 256 candidates (and than the calibration sample): all of them
    assert out["prefilter_candidates"] == 111
    assert out["long_candidates"] == 0  # all of them: the exhaustive engine, not the exact phase's routes
    assert {"prefilter_coarse", "prefilter_rank", "prefilter_merge"} <= set(out["phases"])
