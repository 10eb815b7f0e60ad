"""The engine's spans: ``swtpu.<phase>`` ranges in a ``torch.profiler``
Chrome trace, on the device events' clock.

Under the profiler, on the CPU engine and the 111-sequence subset, a
search (the full array), a top-K search with E-values and its
``top_k_stats``, a top-K search whose candidates tie at the boundary (its
full-array fallback), and a ``search_many`` (full arrays and top-K) each
leave their spans nested under their root (``swtpu.search``,
``swtpu.evalues``, ``swtpu.search_many`` and its ``swtpu.piece`` spans),
and a result's ``SearchMetrics.phases`` has one key for each span under its
search.  The CLI's ``--profile`` block is the span ``swtpu.profile``
around the search.  With no profiler recording, ``record_function`` is
never entered.
"""

import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from swtpu_torch.config import SWConfig
from swtpu_torch.io.fasta import parse_database, parse_query
from swtpu_torch.models.search import SearchEngine
from swtpu_torch.utils import profiling
from swtpu_torch.utils.metrics import PhaseTimer

DATA = Path(__file__).resolve().parent / "data"
QUERIES = ("P02232", "P01008", "P05013")
SINGLE = ("plan", "enqueue", "transfer", "reduce", "metrics")
TOPK = ("plan", "enqueue", "transfer", "metrics", "resolve", "null")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def db():
    return parse_database(DATA / "uniprot_subset.fasta")


@pytest.fixture(scope="module")
def queries():
    return [parse_query(DATA / "queries" / f"{name}.fasta") for name in QUERIES]


def _engine(config, db, queries):
    eng = SearchEngine(config, device="cpu")
    eng.search(queries[0], db)  # packs the database: set-up, outside the traces below
    return eng


def _traced(fn, tmp_path):
    """``fn()``'s result and the ``swtpu.`` spans of its Chrome trace as
    sorted (start, end, name)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e["name"].startswith("swtpu."))
    return out, spans


def _inside(spans, root):
    """The spans strictly nested in ``root`` (start, end, name)."""
    return [s for s in spans if s != root and root[0] <= s[0] and s[1] <= root[1]]


def _names(spans):
    return {name.removeprefix("swtpu.") for _, _, name in spans}


def _roots(spans, name):
    return [s for s in spans if s[2] == name]


@pytest.mark.parametrize("config, phases", [(dict(), SINGLE), (dict(top_k=5, evalue=True), TOPK)],
                         ids=["full array", "top-K with E-values"])
def test_a_search_nests_its_phases_under_its_root(config, phases, db, queries, tmp_path):
    eng = _engine(SWConfig(**config), db, queries)

    def run():
        res = eng.search(queries[1], db)
        return res, (res.top_k_stats(5) if config else None)

    (res, stats), spans = _traced(run, tmp_path)
    (root,) = _roots(spans, "swtpu.search")
    under = _inside(spans, root)
    assert _names(under) == set(phases) == set(res.metrics.phases)
    assert [name for _, _, name in under] == [f"swtpu.{p}" for p in phases]  # each once, in this order
    assert res.metrics.transfer_seconds == res.metrics.phases["transfer"] > 0
    if config:
        (fit,) = _roots(spans, "swtpu.evalues")
        assert fit[0] >= root[1] and not _inside(spans, fit) and len(stats) == 5
    assert len(spans) == 1 + len(phases) + bool(config)


def test_a_tie_fallback_nests_a_full_array_search(db, queries, tmp_path, monkeypatch):
    eng = _engine(SWConfig(top_k=5, evalue=True), db, queries)
    want = SearchEngine(SWConfig(), device="cpu").search(queries[1], db).top_k(5)
    monkeypatch.setattr(SearchEngine, "_resolve_topk_hits", staticmethod(lambda *a: None))
    res, spans = _traced(lambda: eng.search(queries[1], db), tmp_path)
    assert res.top_k(5) == want and res.scores is not None
    (root,) = _roots(spans, "swtpu.search")
    (fallback,) = _roots(spans, "swtpu.fallback")
    nested = _inside(spans, fallback)
    assert [name for _, _, name in nested] == [f"swtpu.{p}" for p in SINGLE]
    assert _names(_inside(spans, root)) == {*TOPK, "fallback", "reduce"} - {"null"} == set(res.metrics.phases)
    assert all(root[0] <= s[0] and s[1] <= root[1] for s in spans)


@pytest.mark.parametrize("config, own", [(dict(), ("metrics", "reduce")), (dict(top_k=5, evalue=True), ("metrics", "resolve", "null"))],
                         ids=["full arrays", "top-K with E-values"])
def test_search_many_nests_pieces_and_phases_under_its_root(config, own, db, queries, tmp_path):
    eng = _engine(SWConfig(**config), db, queries)
    results, spans = _traced(lambda: eng.search_many(queries, db), tmp_path)
    (root,) = _roots(spans, "swtpu.search_many")
    pieces = _roots(spans, "swtpu.piece")
    assert pieces and all(root[0] <= p[0] and p[1] <= root[1] for p in pieces)
    assert sum(len(_inside(spans, p)) for p in pieces) == len(spans) - 1 - len(pieces)  # every phase in a piece
    for p in pieces:
        names = [name for _, _, name in _inside(spans, p)]
        n_queries = names.count("swtpu.metrics")
        assert names[:3] == ["swtpu.plan", "swtpu.enqueue", "swtpu.transfer"]
        assert names[3:] == [f"swtpu.{o}" for o in own] * n_queries
    assert sum(len(_inside(spans, p)) - 3 for p in pieces) == len(own) * len(queries)
    for r in results:
        assert set(r.metrics.phases) == {"plan", "enqueue", "transfer", *own}
        assert r.metrics.attributed and r.metrics.transfer_seconds == r.metrics.phases["transfer"]


def test_the_profile_block_is_a_span_around_the_search(db, queries, tmp_path):
    eng = _engine(SWConfig(), db, queries)
    with profiling.trace(tmp_path, "cpu") as path:
        eng.search(queries[0], db)
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"] if e.get("ph") == "X"]
    (block,) = [e for e in events if e["name"] == profiling.PROFILE_SPAN]
    (search,) = [e for e in events if e["name"] == "swtpu.search"]
    assert block["ts"] <= search["ts"] and search["ts"] + search["dur"] <= block["ts"] + block["dur"]
    s = profiling.trace_summary(path)
    assert s["window_ms"] == pytest.approx(block["dur"] / 1e3) and s["busy_share"] is None


def test_with_the_profiler_off_no_span_is_recorded(db, queries, monkeypatch):
    engines = [_engine(SWConfig(**c), db, queries) for c in (dict(), dict(top_k=5, evalue=True))]

    def broken(*args, **kw):
        raise AssertionError("record_function entered with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", broken)
    assert profiling.span("swtpu.x") is profiling.span("swtpu.y")
    timer = PhaseTimer()
    with timer.phase("plan"):
        pass
    assert timer.counts == {"plan": 1}
    for eng in engines:
        res = eng.search(queries[1], db)
        eng.search_many(queries, db)
        if eng.config.top_k:
            assert len(res.top_k_stats(5)) == 5
