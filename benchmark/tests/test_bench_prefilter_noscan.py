"""The UniRef50-quarter cell and its check, ``checks/prefilter_noscan.py``
(``checks/prefilter.py``'s comparison without the full scans), and the
per-layer metrics that read the prefiltered search.

* On the CPU, the cell cut to test size (3,000 subjects, so that the
  2,048-id calibration sample is a part of the database) is correct; its
  control (int16 scores, float32 E-values) and a search that returns the
  answer of the search before are not, and the check scans nothing whole.
* ``coarse_roofline`` reads the byte floor of the window's
  ``coarse_counts_kernel`` launches over their union on a synthetic trace;
  ``prefilter_host_ms`` reads the prefilter's host spans of a traced CPU
  run, and nothing from a program without them.
* On the card (``gpu``): the cell at its own size, short windows: the
  program is correct, its control and the stale answer are not; each run
  prints its numbers (the readings ``planted_missed``'s limit comes from).

Run with ``python -m pytest benchmark/tests -q`` from the checkout's root.
"""

import json

import pytest
import torch

from tiny import SEED, small

import run  # noqa: E402
from swbench import spec  # noqa: E402
from swbench.trace import Trace  # noqa: E402

BENCHMARK = spec.load()
CELL = "uniref50-shard4-b50-affine-kmer300-top10.single"


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _stale(monkeypatch):
    from swtpu_torch.models.search import SearchEngine

    search, last = SearchEngine.search, {}

    def stale(self, query, db, plan=None):
        res = search(self, query, db, plan)
        prev, last["res"] = last.get("res"), res
        return res if prev is None else prev

    monkeypatch.setattr(SearchEngine, "search", stale)


def tiny_cell(count=6, units=8):
    """(config, mix) at test size: 3,000 subjects of at most 80 residues."""
    cfg, mix = small(BENCHMARK, CELL, n=3000, count=count)
    cfg["database"]["max_length"] = 80
    mix["queries"][0]["max_length"] = 160
    mix["check"]["units"] = units
    return cfg, mix


def test_the_cell_names_the_check_and_the_heuristic():
    cfg = spec.config(BENCHMARK, spec.cell(BENCHMARK, CELL)["config"])
    engine = cfg["engine"]["config"]
    assert cfg["check"] == "prefilter_noscan" and cfg["database"]["sequences"] == 16_000_000
    assert (engine["prefilter"], engine["prefilter_min_candidates"], engine["top_k"]) == (1e-6, 300, 10)
    assert set(cfg["limits"]) == {"answers_missing", "hit_mismatches", "evalue_rel_err", "planted_missed"}


@pytest.mark.parametrize("variant", ["program", "control", "stale"])
def test_the_check_passes_the_program_and_fails_the_control_and_a_stale_answer(variant, monkeypatch):
    cfg, mix = tiny_cell(count=8 if variant == "stale" else 6, units=12 if variant == "stale" else 8)
    if variant == "stale":
        _stale(monkeypatch)
    out = run.run_cell(BENCHMARK, CELL, SEED, 0.5, False, "cpu", variant == "control", cfg=cfg, mix=mix)
    detail = out["check_detail"]
    assert "exhaustive_overlap" not in detail and detail["n_cand"] == 300 and detail["units"] >= 1
    assert set(out["check"]) == {"answers_missing", "hit_mismatches", "evalue_rel_err", "planted_missed"}
    failing = {k for k, v in out["check"].items() if v["value"] > v["limit"]}
    want = {"program": set(), "control": {"evalue_rel_err"}, "stale": {"hit_mismatches"}}[variant]
    assert out["correct"] is (variant == "program") and want <= failing and "answers_missing" not in failing, out["check"]


def _event(name, ts, dur, cat="kernel", tid=1):
    return dict(ph="X", name=name, ts=ts, dur=dur, cat=cat, tid=tid, pid=1)


def test_coarse_roofline_is_the_byte_floor_over_the_coarse_launches():
    n = 1_000_000
    events = [_event("bench.window", 0.0, 10_000.0, "user_annotation"),
              _event("void (anonymous namespace)::coarse_counts_kernel(CUtensorMap, CUtensorMap, int*, int, int, int)",
                     100.0, 400.0),
              _event("void (anonymous namespace)::coarse_counts_kernel(CUtensorMap, CUtensorMap, int*, int, int, int)",
                     2_000.0, 400.0),
              _event("void at::native::radixSortKVInPlace<float>(...)", 500.0, 900.0),
              _event("void (anonymous namespace)::coarse_counts_kernel(...)", 9_900.0, 200.0)]  # past the window
    read = spec.reader("coarse_roofline")
    floor_s = 2 * (n * 1024 + 1024 + 4 * n) / 3.35e12
    assert read(dict(trace=Trace(events), n_subjects=n)) == pytest.approx(100.0 * floor_s / 800e-6)
    assert read(dict(trace=Trace(events[:1] + events[3:4]), n_subjects=n)) is None
    assert read(dict(trace=None, n_subjects=n)) is None


def test_prefilter_host_ms_reads_the_prefilter_spans_and_nothing_without_them():
    cfg, mix = tiny_cell()
    out = run.run_cell(BENCHMARK, CELL, SEED, 0.5, True, "cpu", cfg=cfg, mix=mix)
    assert out["correct"] is True, out["check"]
    assert out["metrics"]["prefilter_host_ms"]["value"] > 0 and "search_idle_ms" in out["metrics"]
    assert "coarse_roofline" not in out["metrics"]  # no kernel runs on the CPU: left out, not 0
    events = [_event("bench.window", 0.0, 100.0, "user_annotation"), _event("swtpu.search", 1.0, 50.0, "user_annotation"),
              _event("swtpu.prefilter_pack", 2.0, 5.0, "user_annotation"), _event("swtpu.evalues", 40.0, 5.0, "user_annotation")]
    read = spec.reader("prefilter_host_ms")
    assert read(dict(trace=Trace(events))) is None  # a program before the prefilter's spans
    events.append(_event("swtpu.prefilter_merge", 10.0, 2.0, "user_annotation"))
    assert read(dict(trace=Trace(events))) == pytest.approx(12.0 * 1e-3)


# On the card: the cell at its own size (16,000,000 subjects), 10-s windows.
CARD_SEEDS = (SEED + 201, SEED + 202)
CARD_SECONDS = 10.0


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["program", "control", "stale"])
@pytest.mark.parametrize("seed", CARD_SEEDS)
def test_on_the_card_the_cell_is_correct_and_its_faults_are_not(seed, variant, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if variant == "stale":
        _stale(monkeypatch)
    out = run.run_cell(BENCHMARK, CELL, seed, CARD_SECONDS, False, "cuda", variant == "control")
    print(json.dumps(dict(seed=seed, variant=variant, correct=out["correct"], attempted=out["attempted"],
                          check=out["check"], reference_s=out["reference_s"], detail=out["check_detail"],
                          peak=out["device"]["memory_peak_bytes"], kind=out["device"]["kind"],
                          setup_s=out["metrics"]["setup_s"]["value"])))
    assert out["correct"] is (variant == "program"), out["check"]
