"""The readers of the program's spans (``swbench.spans`` and the metrics
``search_idle_ms``, ``reduce_ms``, ``topk_host_ms`` and ``batch_idle_ms``)
on hand-made Chrome traces: unions of nested spans, the device time
clipped inside them, a tie fallback's nested spans counted once, nothing
read (None, not 0) from a trace without ``swtpu.`` spans; and a traced
run of each cell on the CPU, which reports them in exactly the cells
``BENCHMARK.json`` lists.

Run with ``python -m pytest benchmark/tests -q`` from the checkout's root.
"""

import json

import pytest
import torch

from tiny import SEED, small

import run  # noqa: E402
from swbench import spans, spec  # noqa: E402
from swbench.trace import Trace  # noqa: E402

BENCHMARK = spec.load()
NEW = ("search_idle_ms", "reduce_ms", "topk_host_ms", "batch_idle_ms")


def X(name, ts, dur, cat="user_annotation", tid=1):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, tid=tid)


def K(ts, dur):
    return X("void sw_band_kernel<true, false, 32>(int const*)", ts, dur, cat="kernel", tid=7)


def _phases(start, names, step=10):
    return [X(f"swtpu.{n}", start + k * step, step) for k, n in enumerate(names)]


def _single_events():
    """Two top-K searches of one window of 1,000 us.  The first one's
    candidates tie at the boundary: its ``fallback`` holds a full-array
    search's phases, nested.  Kernels 40-180, 255-290 and 530-690."""
    return [
        X("bench.window", 0, 1000), X("bench.request", 0, 500), X("bench.request", 500, 500),
        X("swtpu.search", 10, 390),
        X("swtpu.plan", 10, 20), X("swtpu.enqueue", 30, 30), X("swtpu.transfer", 60, 140),
        X("swtpu.metrics", 200, 20), X("swtpu.resolve", 220, 20),
        X("swtpu.fallback", 240, 150), *_phases(245, ("plan", "enqueue", "transfer")),
        X("swtpu.reduce", 300, 50), X("swtpu.metrics", 350, 30),
        X("swtpu.evalues", 410, 70),
        X("swtpu.search", 510, 390),
        X("swtpu.plan", 510, 10), X("swtpu.enqueue", 520, 20), X("swtpu.transfer", 540, 160),
        X("swtpu.metrics", 700, 20), X("swtpu.resolve", 720, 20), X("swtpu.null", 740, 20),
        X("swtpu.evalues", 910, 80),
        X("cudaStreamSynchronize", 60, 130, cat="cuda_runtime"),
        K(40, 140), K(255, 35), K(530, 160),
    ]


def _batch_events():
    """Two search_many calls in a window of 1,000 us; the first has two
    pieces, and a query of its second piece falls back to a full-array
    search.  Kernels 30-200, 260-400 and 620-900."""
    return [
        X("bench.window", 0, 1000), X("bench.request", 0, 500), X("bench.request", 500, 500),
        X("swtpu.search_many", 10, 480),
        X("swtpu.piece", 10, 230), *_phases(10, ("plan", "enqueue", "transfer")), X("swtpu.reduce", 210, 20),
        X("swtpu.piece", 240, 240), *_phases(240, ("plan", "enqueue", "transfer")),
        X("swtpu.resolve", 400, 10), X("swtpu.fallback", 410, 60), *_phases(410, ("plan", "enqueue", "transfer")),
        X("swtpu.reduce", 440, 30),
        X("swtpu.search_many", 510, 480),
        X("swtpu.piece", 510, 470), *_phases(510, ("plan", "enqueue", "transfer")),
        K(30, 170), K(260, 140), K(620, 280),
    ]


def _read(events, call="search"):
    run_rec = dict(trace=Trace(events), call=call, search_lengths=[100, 200])
    return {name: spec.reader(name)(run_rec) for name in NEW}


def test_single_searches_count_unions_and_clip_the_device():
    got = _read(_single_events())
    # search + evalues: 390 + 70 + 390 + 80 us, less the kernels inside (140 + 35 + 160); two searches
    assert got["search_idle_ms"] == pytest.approx((930 - 335) * 1e-3 / 2)
    # the fallback's nested reduce once; its nested phases add no search
    assert got["reduce_ms"] == pytest.approx(50 * 1e-3 / 2)
    assert got["topk_host_ms"] == pytest.approx((20 + 70 + 20 + 20 + 80) * 1e-3 / 2)
    assert got["batch_idle_ms"] is None  # no search_many: nothing to read


def test_batches_count_their_idle_time_once():
    got = _read(_batch_events(), call="search_many")
    # 480 us each, less the kernels inside: 170 + 140, then 280
    assert got["batch_idle_ms"] == pytest.approx(((480 - 310) + (480 - 280)) * 1e-3 / 2)
    assert got["search_idle_ms"] is None and got["reduce_ms"] is None and got["topk_host_ms"] is None


def test_nested_spans_count_once_and_nested_searches_are_not_searches():
    nested = [X("swtpu.search", 20, 300), X("swtpu.search", 40, 200), X("swtpu.reduce", 60, 100),
              X("swtpu.reduce", 80, 50), X("swtpu.evalues", 250, 100)]
    ivs = [(float(e["ts"]), float(e["ts"] + e["dur"])) for e in nested]
    assert spans.roots(ivs[:2]) == [(20, 320)]
    assert spans.held_us(ivs[2:4]) == 100 and spans.held_us([ivs[0], ivs[4]]) == 330
    got = _read([X("bench.window", 0, 1000), X("bench.request", 0, 1000), *nested, K(100, 50), K(300, 200)])
    assert got["search_idle_ms"] == pytest.approx((330 - 50 - 50) * 1e-3)
    assert got["reduce_ms"] == pytest.approx(0.1) and got["topk_host_ms"] == pytest.approx(0.1)


@pytest.mark.parametrize("events", [_single_events, _batch_events])
def test_no_program_span_reads_nothing(events):
    bare = [e for e in events() if not e["name"].startswith("swtpu.")]
    assert _read(bare) == dict.fromkeys(NEW)
    assert all(spec.reader(name)(dict(trace=None, call="search", search_lengths=[])) is None for name in NEW)


def test_spans_outside_the_window_are_clipped_or_left_out():
    events = [X("bench.window", 100, 800), X("bench.request", 100, 800),
              X("swtpu.search", 0, 50), X("swtpu.search", 50, 200), X("swtpu.search", 850, 200)]
    t = Trace(events)
    assert spans.window_spans(t, "search") == [(100, 250), (850, 900)]


@pytest.fixture
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCHMARK["workloads"]])
def test_a_traced_cpu_run_reports_them_in_exactly_their_cells(cell, _few_threads):
    cfg, mix = small(BENCHMARK, cell)
    out = run.run_cell(BENCHMARK, cell, SEED, 0.5, True, "cpu", cfg=cfg, mix=mix)
    assert out["correct"] is True
    listed = {m["name"] for m in BENCHMARK["per_layer"] if m["name"] in NEW and cell in m["workloads"]}
    assert listed and {name for name in NEW if name in out["metrics"]} == listed
    for name in listed:
        assert out["metrics"][name]["value"] > 0 and out["metrics"][name]["unit"] == "ms"


def test_self_times_give_each_stretch_to_its_innermost_span():
    got = spans.self_times(Trace(_single_events()))
    want = {  # [wall, idle] in us, worked by hand from _single_events
        "swtpu.transfer": [310, 30], "swtpu.fallback": [40, 25], "swtpu.enqueue": [60, 20],
        "swtpu.search": [150, 150], "swtpu.evalues": [150, 150], "swtpu.reduce": [50, 50],
        "(request, no span)": [70, 70], "swtpu.plan": [40, 40], "swtpu.metrics": [70, 70],
        "swtpu.resolve": [40, 40], "swtpu.null": [20, 20],
    }
    assert set(got) == set(want)
    for label, (wall, idle) in want.items():
        assert got[label] == pytest.approx([wall * 1e-3, idle * 1e-3]), label
    assert sum(w for w, _ in got.values()) == pytest.approx(1.0)  # the whole window, once
    assert sum(i for _, i in got.values()) == pytest.approx((1000 - 335) * 1e-3)
    assert spans.self_times(Trace([e for e in _single_events() if not e["name"].startswith("swtpu.")])) is None


def test_span_breakdown_prints_the_self_times_of_a_traced_run(monkeypatch, capsys, _few_threads):
    import span_breakdown

    cell = "swissprot-b50-linear.single"
    cfg, mix = small(BENCHMARK, cell)

    def cpu_main(argv):
        assert argv[-2:] == ["--trace", "1"]
        run.run_cell(BENCHMARK, cell, SEED, 0.5, True, "cpu", cfg=cfg, mix=mix)
        return 0

    monkeypatch.setattr(run, "main", cpu_main)
    traced = run._traced
    assert span_breakdown.main(["--workload", cell]) == 0 and run._traced is traced
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["requests"] >= 1 and out["span_counts"]["swtpu.search"] == out["requests"]
    assert {"swtpu.reduce", "swtpu.metrics", "swtpu.enqueue"} <= set(out["self_ms"])
