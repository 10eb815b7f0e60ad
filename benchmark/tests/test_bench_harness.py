"""The harness on the CPU: BENCHMARK.json's shape, discovery by name, seeded
inputs, the trace arithmetic, the last line's schema, a sound run, and what
the harness and the reference import.

Run with ``python -m pytest benchmark/tests -q`` from the checkout's root.
"""

import ast
import json
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tiny import BENCH, SEED, small

import run  # noqa: E402
from swbench import check, data, peaks, spec  # noqa: E402
from swbench.drive import Record  # noqa: E402
from swbench.trace import Trace, merged  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCHMARK = spec.load()
CELLS = [w["name"] for w in BENCHMARK["workloads"]]


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_benchmark_json_keeps_its_schema():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and c["file"].startswith("benchmark/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert w["name"] == f"{w['config']}.{w['traffic']}" and len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(b["workloads"])
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        for cell in m.get("workloads", CELLS):
            assert cell in e2e[m["moves"]].get("workloads", CELLS)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for cell in CELLS:  # setup_s, another end-to-end metric and a per-layer metric in every cell
        got = [m["name"] for m in spec.metrics(b, cell, False)]
        assert "setup_s" in got and len(got) >= 2 and spec.metrics(b, cell, True)
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_part_of_a_cell_is_found_by_name(cell):
    w = spec.cell(BENCHMARK, cell)
    cfg = spec.config(BENCHMARK, w["config"])
    mix = spec.traffic(w["traffic"])
    assert cfg["name"] == w["config"] and cfg["chips"] == w["chips"]
    pieces = [("databases", cfg["database"]["recipe"]), ("engines", cfg["engine"]["name"]), ("calls", mix["call"]),
              ("orders", mix["order"]["name"]), ("loops", mix["loop"])] + [("sources", g["source"]) for g in mix["queries"]]
    pieces += [("checks", cfg["check"])] if "check" in cfg else []
    for kind, piece in pieces:
        assert spec.plugin(kind, piece) is spec.plugin(kind, piece)
    with pytest.raises(KeyError):
        spec.plugin("orders", "no_such_order")
    for traced in (False, True):
        for m in spec.metrics(BENCHMARK, cell, traced):
            assert callable(spec.reader(m["name"]))
    with pytest.raises(KeyError):
        spec.reader("no_such_metric")


def test_inputs_repeat_for_a_seed_and_keep_their_sizes_across_seeds():
    cfg, mix = small(BENCHMARK, "swissprot-b50-linear.single")
    runs = {}
    for seed in (SEED, SEED, 7):
        qs = data.queries(mix, seed)
        res, off, planted = data.database(cfg["database"], qs, seed)
        reqs = data.requests(mix, qs, seed)
        runs.setdefault(seed, []).append((qs, res, off, planted, [next(reqs) for _ in range(20)]))
    (a, b), (c,) = runs[SEED], runs[7]
    assert all(np.array_equal(x["residues"], y["residues"]) for x, y in zip(a[0], b[0]))
    assert np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2]) and a[4] == b[4]
    assert all(np.array_equal(x, y) for x, y in zip(a[3], b[3]))
    assert not np.array_equal(a[1][: c[1].size], c[1][: a[1].size]) and a[4] != c[4]
    assert [q["residues"].size for q in a[0]] == [q["residues"].size for q in c[0]]
    # the same multiset of lengths but the planted ones
    la, lc = np.diff(a[2]), np.diff(c[2])
    keep_a = np.setdiff1d(np.arange(la.size), np.concatenate(a[3]))
    keep_c = np.setdiff1d(np.arange(lc.size), np.concatenate(c[3]))
    base = data.lognormal_lengths(cfg["database"], cfg["database"]["sequences"])
    assert np.isin(la[keep_a], base).all() and np.isin(lc[keep_c], base).all()
    # the long query takes its fixed requests; the others come a pass at a time, a stratum a block
    names = [q["name"] for q in a[0]]
    periodic = [names.index(p["query"]) for p in mix["order"]["periodic"]]
    firsts = [r[0] for r in a[4]]
    for i, p in zip(periodic, mix["order"]["periodic"]):
        assert [j for j, x in enumerate(firsts) if x == i] == list(range(p["first"], 20, p["every"]))
    pool = [x for x in firsts if x not in periodic]
    n = len(a[0]) - len(periodic)
    assert sorted(pool[:n]) == sorted(set(range(len(a[0]))) - set(periodic))


def test_planted_homologs_are_the_query_and_its_mutants():
    cfg, mix = small(BENCHMARK, "swissprot-b50-affine-top10.suite17")
    qs = data.queries(mix, SEED)
    res, off, planted = data.database(cfg["database"], qs, SEED)
    p = cfg["database"]["planted"]
    for q, ids in zip(qs, planted):
        seqs = [res[off[i] : off[i + 1]] for i in ids]
        assert np.array_equal(seqs[0], q["residues"]) and len(ids) == p["exact"] + p["mutants"]
        for s in seqs[p["exact"]:]:
            share = float((s != q["residues"]).mean())
            assert abs(share - p["substitution"]) < 0.12


def test_suite_queries_are_the_vendored_files():
    w = spec.cell(BENCHMARK, "swissprot-b50-linear.suite17")
    mix = spec.traffic(w["traffic"])
    qs = data.queries(mix, SEED)
    assert len(qs) == 17 and sum(q["residues"].size for q in qs) == 29122
    assert qs[-1]["name"] == "P08519" and mix["check"]["always"] == ["P08519"]


@pytest.mark.parametrize("top_k", [None, 10])
def test_the_sample_keeps_few_answers_and_repeats_for_a_seed(top_k):
    """The check's sample, taken as answers arrive: a reservoir of fixed size
    and every answer of the ``always`` queries; a full array keeps only its
    scores at the planted and seeded ids; the same seed keeps the same."""
    n, plan = 50, dict(units=4, subjects=6, full_scans=2, always=["b"], no_full_scan=["b"])
    qs = [dict(name="a"), dict(name="b")]
    planted = [np.array([1, 2]), np.array([3, 4])]

    def fill(seed):
        smp = check.Sample(plan, qs, n, top_k, planted, seed)
        for r in range(40):
            answer = np.arange(n) * (r + 1) if top_k is None else [(i, 100 - i, 1e-3, 9.0) for i in range(top_k)]
            smp.offer_request(r, Record(0.0, 1.0, [r % 2], None), [answer if r != 5 else None])
        return smp

    smp = fill(SEED)
    assert smp.missing == 1
    always = [u for u, (q, _) in smp.kept.items() if q == 1]
    assert len(always) == 19 and len(smp.kept) <= 19 + plan["units"] + plan["full_scans"]
    assert len(smp.units("units")) == 19 + sum(1 for u in smp.pools["units"] if smp.kept[u][0] == 0)
    if top_k is None:
        assert smp.pools["scans"] == []
        for (r, _), (q, (ids, got)) in smp.kept.items():
            assert ids.size == 2 + plan["subjects"] and np.array_equal(ids[:2], planted[q])
            assert np.array_equal(got, ids * (r + 1))
    else:
        assert len(smp.pools["scans"]) == 2 and all(smp.kept[u][0] == 0 for u in smp.pools["scans"])
    again = fill(SEED)
    assert smp.pools == again.pools and sorted(smp.kept) == sorted(again.kept)
    assert fill(SEED + 1).pools != smp.pools


def _events():
    """A synthetic trace: a window of 1,000 us, two requests, three kernels
    (one overlapping another), a copy, and the host's ops."""
    X = lambda name, cat, ts, dur, tid=1: dict(ph="X", name=name, cat=cat, ts=ts, dur=dur, tid=tid)  # noqa: E731
    return [
        X("bench.window", "user_annotation", 0, 1000),
        X("bench.request", "user_annotation", 0, 500),
        X("bench.request", "user_annotation", 500, 500),
        X("aten::topk", "cpu_op", 50, 100),
        X("cudaStreamSynchronize", "cuda_runtime", 300, 150),
        X("void sw_band_kernel<true, false, 64>(int const*)", "kernel", 100, 200, 7),
        X("void sw_wave_kernel<true, false, 16>(int const*)", "kernel", 250, 100, 7),
        X("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 400, 50, 7),
        X("void at::topk_kernel(float)", "kernel", 600, 100, 7),
        X("aten::copy_", "cpu_op", 700, 250),
    ]


def test_trace_arithmetic_on_a_synthetic_trace():
    t = Trace(_events())
    lo, hi = t.window()
    assert (lo, hi) == (0, 1000)
    assert t.busy(lo, hi) == 200 + 50 + 50 + 100  # kernels 100-350, copy 400-450, kernel 600-700
    assert t.busy(lo, hi, kernels_only=True) == 350
    assert t.busy(320, 620) == 30 + 50 + 20
    assert merged([(5, 7), (1, 3), (2, 4)]) == [(1, 4), (5, 7)]
    assert t.request_host_ms() == [(500 - 300) * 1e-3, (500 - 100) * 1e-3]
    ops = dict(t.device_ops(lo, hi))
    assert ops["sw_band_kernel<true, false, 64>"] == pytest.approx(200e-6)
    gaps = dict(t.idle_gaps(lo, hi))
    assert sum(gaps.values()) == pytest.approx(600e-6)
    assert gaps["aten::topk"] == pytest.approx(100e-6)  # 0-100: inside a request, in aten::topk
    assert gaps["aten::copy_"] == pytest.approx(300e-6)  # 700-1000: in aten::copy_
    run_rec = dict(trace=t, search_lengths=[100, 200], db_residues=10**9, n_subjects=10**6, gap_model="affine", call="search")
    least = sum(peaks.least_seconds(q, 10**9, 10**6, "affine") for q in (100, 200))
    assert least == pytest.approx(11 * 300 * 1e9 / peaks.INT_OPS_PER_S)
    assert spec.reader("kernel_roofline")(run_rec) == pytest.approx(100 * least / 350e-6)
    assert spec.reader("device_idle_share")(run_rec) == pytest.approx(60.0)
    assert spec.reader("kernel_launches")(run_rec) == pytest.approx(1.5)
    assert spec.reader("engine_host_ms")(run_rec) == pytest.approx(0.3)


def test_peaks_are_the_packed_integer_rate():
    assert peaks.INT_OPS_PER_S == pytest.approx(6.69e13, rel=1e-3)
    # the byte bound of a search is far below its operations
    assert peaks.least_seconds(290, 196_472_195, 559_228, "linear") == pytest.approx(6 * 290 * 196_472_195 / peaks.INT_OPS_PER_S)


@pytest.mark.parametrize("cell", ["swissprot-b50-linear.suite17", "swissprot-b50-affine-top10.single"])
def test_a_sound_run_is_correct_and_its_last_line_keeps_the_schema(cell):
    cfg, mix = small(BENCHMARK, cell)
    out = run.run_cell(BENCHMARK, cell, SEED, 0.5, False, "cpu", cfg=cfg, mix=mix)
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(out)[-1] == "check"
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    want = {m["name"] for m in spec.metrics(BENCHMARK, cell, False)}
    assert set(out["metrics"]) == want
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for v in out["check"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    json.loads(json.dumps(out, default=str))


def test_a_traced_run_reports_its_per_layer_metrics():
    cell = "swissprot-b50-linear.single"
    cfg, mix = small(BENCHMARK, cell)
    out = run.run_cell(BENCHMARK, cell, SEED, 0.5, True, "cpu", cfg=cfg, mix=mix)
    assert out["correct"] is True and {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU no kernel runs on a device: the shares of a roofline are left out, not 0
    assert "kernel_roofline.single" not in out["metrics"] and "engine_host_ms" in out["metrics"]


def test_no_card_means_no_result():
    proc = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload", CELLS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=BENCH.parent,
                          env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    base = set(run.forbidden_modules())
    monkeypatch.setitem(sys.modules, "swtpu_torch_fake.sub", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_fake", sys)
    assert set(run.forbidden_modules()) == base
    monkeypatch.setitem(sys.modules, "flax.linen", sys)
    monkeypatch.setitem(sys.modules, "swtpu.models.fake", sys)
    assert set(run.forbidden_modules()) == base | {"flax", "swtpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program_and_the_harness_no_jax():
    forbidden = {"jax", "jaxlib", "flax", "swtpu"}
    for path in sorted((BENCH / "reference").glob("*.py")):
        tops = {m.partition(".")[0] for m in _imports(path)}
        assert not tops & (forbidden | {"swtpu_torch", "swbench"}), path
    for path in sorted(p for p in BENCH.rglob("*.py") if p.parent.name not in ("reference", "tests")):
        assert not {m.partition(".")[0] for m in _imports(path)} & forbidden, path


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A subprocess (this test process may hold JAX already): importing the
    reference alone loads nothing of the program; a whole CPU run of a cell
    loads neither JAX nor swtpu."""
    code = f"""
import sys
sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}]
from reference import hits, scoring, sw
assert not any(m.partition(".")[0] == "swtpu_torch" for m in sys.modules), "the reference loaded the program"
import torch
torch.set_num_threads(2)
sys.path.insert(0, {str(BENCH / 'tests')!r})
from tiny import small, SEED
import run
from swbench import spec
b = spec.load()
cfg, mix = small(b, "swissprot-b50-affine-top10.suite17")
out = run.run_cell(b, "swissprot-b50-affine-top10.suite17", SEED, 0.3, False, "cpu", cfg=cfg, mix=mix)
assert out["correct"], out
tops = {{m.partition(".")[0] for m in sys.modules}}
assert not tops & {{"jax", "jaxlib", "flax", "swtpu"}}, sorted(tops & {{"jax", "jaxlib", "flax", "swtpu"}})
assert "swtpu_torch" in tops
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=BENCH.parent)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
