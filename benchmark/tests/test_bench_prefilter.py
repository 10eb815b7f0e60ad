"""The prefilter's plain reference (``reference/prefilter.py``) against the
program, and the check that holds a prefiltered search to it
(``checks/prefilter.py``).

* The reference heuristic's hits and E-values equal the program's
  ``search`` and ``search_many`` under the prefilter, on a seeded database
  larger than the calibration sample: linear and affine gaps, E-values on
  and off, the candidate count set by the fraction, by
  ``prefilter_min_candidates`` and by 4 * top_k, and a query too short for
  a k-mer (no signal: every subject a candidate).
* A whole run of the program on a prefilter configuration (the affine
  top-10 configuration with the heuristic switched on and the check named,
  cut to test size) is correct; its control is not.
* Broken programs are not correct: one candidate short, hits from an
  exhaustive scan, E-values from the exhaustive null, and the answer of
  the search before (whose planted homologs are the ones missed).
* On the card (``gpu``): the same at SwissProt's size, the prefilter
  keeping 300 candidates a query, under the unchanged ``single`` mix.

Run with ``python -m pytest benchmark/tests -q`` from the checkout's root.
"""

import copy
import json

import numpy as np
import pytest
import torch

from tiny import SEED, small

import run  # noqa: E402
from reference import prefilter as ref_pf  # noqa: E402
from reference import scoring  # noqa: E402
from swbench import data, spec  # noqa: E402

BENCHMARK = spec.load()
CELL = "swissprot-b50-affine-top10.single"
GAPS = {"linear": ({"gap": 2}, dict(gap_penalty=2)),
        "affine": ({"gap_open": 10, "gap_extend": 2}, dict(gap_open=10, gap_extend=2))}
# (prefilter, prefilter_min_candidates) at 3,000 subjects and top-10: 90, 64 and 40 candidates
KNOBS = {"fraction": (0.03, 8), "min_candidates": (1e-6, 64), "four_top_k": (1e-6, 8)}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def prefilter_cell(cfg: dict, fraction: float, min_candidates: int, evalue: bool = True, gaps: str = "affine",
                   planted_missed: int = 0) -> dict:
    """``cfg`` with the prefilter switched on in its engine and its check
    named: a copy."""
    cfg = copy.deepcopy(cfg)
    scoring_gaps, engine_gaps = GAPS[gaps]
    cfg["check"] = "prefilter"
    cfg["scoring"]["gaps"] = scoring_gaps
    cfg["returns"] = dict(top_k=10, evalue=evalue)
    cfg["engine"]["config"] = dict(matrix=cfg["scoring"]["matrix"], top_k=10, evalue=evalue, prefilter=fraction,
                                   prefilter_min_candidates=min_candidates, **engine_gaps)
    cfg["limits"]["planted_missed"] = planted_missed
    return cfg


def tiny_cell(fraction=1e-6, min_candidates=8, evalue=True, gaps="affine", count=6, units=6):
    """(config, mix) at test size: 3,000 subjects of at most 80 residues,
    so that the calibration sample (2,048) is a part of the database."""
    cfg, mix = small(BENCHMARK, CELL, n=3000, count=count)
    cfg["database"]["max_length"] = 80
    mix["queries"][0]["max_length"] = 160
    mix["check"]["units"] = units
    return prefilter_cell(cfg, fraction, min_candidates, evalue, gaps), mix


@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("evalue", [True, False])
@pytest.mark.parametrize("gaps", list(GAPS))
def test_the_reference_heuristic_answers_as_the_program(gaps, evalue, knob):
    from swtpu_torch.config import SWConfig
    from swtpu_torch.io.fasta import Database, Query
    from swtpu_torch.models.search import SearchEngine

    cfg, mix = tiny_cell(*KNOBS[knob], evalue=evalue, gaps=gaps, count=4)
    qs = data.queries(mix, SEED)
    res, off, _ = data.database(cfg["database"], qs, SEED)
    qs.append(dict(name="short", residues=np.array([3, 7], dtype=np.int8)))  # no 3-mer: no signal
    engine = SearchEngine(SWConfig(**cfg["engine"]["config"]), device="cpu")
    db = Database(residues=res, offsets=off)
    queries = [Query(name=q["name"], residues=q["residues"], raw="") for q in qs]
    n = off.size - 1
    n_cand = ref_pf.n_candidates(n, *KNOBS[knob], 10)
    assert n_cand == {"fraction": 90, "min_candidates": 64, "four_top_k": 40}[knob]
    cands = ref_pf.candidates([q["residues"] for q in qs], torch.from_numpy(res), off, n_cand, evalue, "cpu")
    assert cands[-1].size == n and all(c.size < n for c in cands[:-1])
    matrix = scoring.matrix(cfg["scoring"]["matrix"])
    want = ref_pf.answers([q["residues"] for q in qs], cands, torch.from_numpy(res), off, matrix, cfg["scoring"]["gaps"],
                          10, evalue, "cpu")
    for results in ([engine.search(q, db) for q in queries], engine.search_many(queries, db)):
        for r, w in zip(results, want):
            if evalue:
                got = [(h.id, h.score, h.evalue, h.bits) for h in r.top_k_stats(10)]
                assert [g[:2] for g in got] == [x[:2] for x in w]
                np.testing.assert_allclose(np.array([g[2:] for g in got]), np.array([x[2:] for x in w]), rtol=1e-9, atol=0)
            else:
                assert r.top_k(10) == [x[:2] for x in w]


def test_the_check_passes_the_program_and_fails_its_control():
    cfg, mix = tiny_cell()
    out = run.run_cell(BENCHMARK, CELL, SEED, 0.5, False, "cpu", cfg=cfg, mix=mix)
    assert out["correct"] is True, out["check"]
    assert set(out["check"]) == {"answers_missing", "hit_mismatches", "evalue_rel_err", "planted_missed"}
    assert out["check_detail"]["n_cand"] == 40 and out["check_detail"]["planted"] == 5 * out["check_detail"]["units"]
    ctl = run.run_cell(BENCHMARK, CELL, SEED, 0.5, False, "cpu", control=True, cfg=cfg, mix=mix)
    failing = {k for k, v in ctl["check"].items() if v["value"] > v["limit"]}
    assert ctl["correct"] is False and "evalue_rel_err" in failing and "answers_missing" not in failing, ctl["check"]


def _one_candidate_short(monkeypatch, cls):
    n_cand = cls._n_cand
    monkeypatch.setattr(cls, "_n_cand", lambda self, n: n_cand(self, n) - 1)


def _hits_from_an_exhaustive_scan(monkeypatch, cls):
    monkeypatch.setattr(cls, "_n_cand", lambda self, n: n)


def _evalues_from_the_exhaustive_null(monkeypatch, cls):
    from swtpu_torch import stats

    def null(self, q, db, ids, scores):
        full = self._exact_engine().search(q, db).scores
        return stats.null_stats_from_scores(full, n_subjects=db.n, query_length=q.length,
                                            mean_subject_length=db.length_sum / db.n, lengths=db.lengths,
                                            trim=self._top_trim)

    monkeypatch.setattr(cls, "_null_from_sample", null)


def _stale(monkeypatch, cls):
    search, last = cls.search, {}

    def stale(self, query, db, plan=None):
        res = search(self, query, db, plan)
        prev, last["res"] = last.get("res"), res
        return res if prev is None else prev

    monkeypatch.setattr(cls, "search", stale)


MUTANTS = {"one_candidate_short": (_one_candidate_short, False, "hit_mismatches"),
           "hits_from_an_exhaustive_scan": (_hits_from_an_exhaustive_scan, False, "hit_mismatches"),
           "evalues_from_the_exhaustive_null": (_evalues_from_the_exhaustive_null, True, "evalue_rel_err"),
           "the_answer_before": (_stale, False, "planted_missed")}


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_a_broken_prefilter_is_not_correct(mutant, monkeypatch):
    from swtpu_torch.models.search import SearchEngine

    plant, evalue, number = MUTANTS[mutant]
    plant(monkeypatch, SearchEngine)
    cfg, mix = tiny_cell(evalue=evalue, count=8, units=12)
    out = run.run_cell(BENCHMARK, CELL, SEED, 0.5, False, "cpu", cfg=cfg, mix=mix)
    assert out["correct"] is False and out["check"][number]["value"] > out["check"][number]["limit"], out["check"]


# On the card: SwissProt's size, the prefilter keeping 300 candidates a query (MMseqs2's --max-seqs 300),
# affine gaps 10/2, top-10 with E-values, under the unchanged ``single`` mix.  Sound runs miss 0 to 4
# planted homologs of some 325 (30% mutants of the longest and shortest queries); the answer of the
# search before misses nearly all of them.
CARD_SEEDS = (SEED + 101, SEED + 102, SEED + 103)
CARD_SECONDS = 10.0
CARD_PLANTED_MISSED = 16


def card_config() -> dict:
    cfg = spec.config(BENCHMARK, "swissprot-b50-affine-top10")
    return prefilter_cell(cfg, 1e-6, 300, planted_missed=CARD_PLANTED_MISSED)


@pytest.mark.gpu
@pytest.mark.parametrize("control", [0, 1])
@pytest.mark.parametrize("seed", CARD_SEEDS)
def test_on_the_card_the_prefilter_check_passes_the_program_and_fails_its_control(seed, control):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run.run_cell(BENCHMARK, CELL, seed, CARD_SECONDS, False, "cuda", bool(control), cfg=card_config())
    print(json.dumps(dict(seed=seed, control=control, correct=out["correct"], attempted=out["attempted"],
                          check=out["check"], reference_s=out["reference_s"], detail=out["check_detail"],
                          peak=out["device"]["memory_peak_bytes"], kind=out["device"]["kind"])))
    assert out["correct"] is (not control), out["check"]
