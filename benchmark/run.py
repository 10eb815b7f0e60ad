#!/usr/bin/env python3
"""Run one cell of the benchmark of ``swtpu_torch`` on this machine's card.

    python3 benchmark/run.py --workload <config>.<traffic> --seed <n> --seconds <s> --trace <0|1>

A run is one process: it makes the cell's database and queries from the
seed, loads the program and packs the database on the card, warms up every
call shape the traffic makes (all of that is ``setup_s``), then sends
requests in a closed loop for ``--seconds``.  Once the window has closed it
frees the program, checks a seeded sample of the answers against the plain
reference (``benchmark/reference``; by the check the configuration names,
``benchmark/checks/<name>.py``, else by ``swbench/check.py``) and prints
one JSON line last on standard output: ``correct``, ``attempted``,
``failed``, the metrics (end-to-end untraced; per-layer with ``--trace
1``, read from a ``torch.profiler`` trace of the window), ``device``, with a trace
``breakdown``, and last ``check``: each number compared beside its limit,
as the last lines of standard error also give them.

It exits non-zero and prints no result without a CUDA card (it never falls
back to the CPU), and when JAX, flax or the JAX package is loaded.
``--control 1`` puts the reference at the next precision down in the
program's place; the check must then fail.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PYCACHE = ROOT / ".benchmark_cache" / "pycache"

if __name__ == "__main__":
    # Python's bytecode cache, at a fixed path inside the checkout: torch ships
    # no .pyc files, so a process that may not write them compiles some 2,000
    # of torch's modules again (about 3 s of a 8-s import on the card's host)
    # and its set-up swings with the host's load.  Only a checkout's first run
    # compiles them; later imports read them back.
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(PYCACHE)
for _p in (str(ROOT), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import numpy as np  # noqa: E402

from swbench import check, data, drive, spec  # noqa: E402
from swbench.trace import Trace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "swtpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (compared whole: ``swtpu_torch`` is not ``swtpu``)."""
    return sorted({name.partition(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def _traced(loop, seconds, go, reqs, done, device):
    """The window under ``torch.profiler``, and the trace read back from a
    temporary file."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
    with profile(activities=acts) as prof:
        window = loop.run(go, reqs, seconds, span=record_function, done=done)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        return window, Trace.from_file(path)


def run_cell(bench: dict, name: str, seed: int, seconds: float, traced: bool, device="cuda",
             control: bool = False, t0: float = None, cfg: dict = None, mix: dict = None,
             marks: list = None) -> dict:
    """One run of the cell ``name``; ``cfg`` and ``mix`` replace the files
    the cell names (the CPU tests shrink them).  ``marks`` holds set-up's
    (label, time) marks so far, ``t0`` its start."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    marks = list(marks or [])
    from swtpu_torch.io.fasta import Database, Query

    marks.append(("program import", time.perf_counter()))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.empty(1, device=device)
    marks.append(("card context", time.perf_counter()))
    cell = spec.cell(bench, name)
    cfg = cfg or spec.config(bench, cell["config"])
    mix = mix or spec.traffic(cell["traffic"])
    qs = data.queries(mix, seed)
    residues, offsets, planted = data.database(cfg["database"], qs, seed, device)
    db = Database(residues=residues, offsets=offsets)
    qobjs = [Query(name=q["name"], residues=q["residues"], raw="") for q in qs]
    marks.append(("data", time.perf_counter()))

    engine = spec.plugin("engines", cfg["engine"]["name"]).build(cfg["engine"], device)
    go = drive.caller(engine, db, qobjs, mix["call"], cfg["returns"])
    for idx in data.warmup(mix, qs):  # packs the database on the card, builds and loads the kernels
        go(idx)
    if cuda:
        torch.cuda.synchronize()
    marks.append(("engine and warm-up", time.perf_counter()))
    gc.collect()
    gc.freeze()  # what set-up made stays out of the window's collections
    setup_s = time.perf_counter() - t0
    marks.append(("collect", time.perf_counter()))

    sample = check.Sample(mix["check"], qs, offsets.size - 1, cfg["returns"].get("top_k"), planted, seed)
    reqs = data.requests(mix, qs, seed)
    loop = spec.plugin("loops", mix["loop"])
    if traced:
        window, trace = _traced(loop, seconds, go, reqs, sample.offer_request, device)
    else:
        window, trace = loop.run(go, reqs, seconds, done=sample.offer_request), None
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    loaded = forbidden_modules()
    del engine, go
    gc.unfreeze()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    records = window["records"]
    checker = spec.plugin("checks", cfg["check"]) if "check" in cfg else check
    numbers = checker.check(cfg, qs, residues, offsets, planted, sample, device, control)
    ref_s, detail = numbers.pop("reference_seconds"), numbers.pop("_detail")
    failed = numbers["answers_missing"]["value"]
    correct = all(v["value"] <= v["limit"] for v in numbers.values())

    gaps = cfg["scoring"]["gaps"]
    run = dict(
        setup_s=setup_s, window_s=window["end"] - window["start"], records=records, call=mix["call"],
        search_lengths=[qs[i]["residues"].size for r in records if r.error is None for i in r.idx],
        db_residues=int(offsets[-1]), n_subjects=int(offsets.size - 1),
        gap_model="affine" if "gap_open" in gaps else "linear", trace=trace,
    )
    metrics = {}
    for m in spec.metrics(bench, name, traced):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name() if cuda else "cpu",
               count=1, memory_peak_bytes=peak)
    out = dict(correct=correct, attempted=sum(len(r.idx) for r in records), failed=failed, metrics=metrics, device=dev)
    if trace is not None:
        lo, hi = trace.window()
        dev.update(busy_s=trace.busy(lo, hi) * 1e-6, window_s=(hi - lo) * 1e-6)
        out["breakdown"] = dict(device_ops=trace.device_ops(lo, hi), idle_gaps=trace.idle_gaps(lo, hi))
    # diagnostics: set-up's pieces, the program's CUDA-event seconds of the window and of its slowest
    # requests (a slow device or a stalled host), the reference's time
    out["setup_parts_s"] = {label: b - a for (_, a), (label, b) in zip([("start", t0)] + marks, marks)}
    out["window_device_s"] = sum(r.device_s for r in records)
    out["slowest_requests"] = [[r.t1 - r.t0, r.device_s, len(r.idx)]
                               for r in sorted(records, key=lambda r: r.t0 - r.t1)[:3]]
    out["reference_s"] = ref_s
    out["check_detail"] = detail
    out["errors"] = sorted({r.error[-2000:] for r in records if r.error})[:3]
    out["forbidden_loaded"] = loaded
    out["check"] = numbers
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    import torch

    marks = [("python, harness and torch imports", time.perf_counter())]

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: the cell needs {cell['chips']} CUDA card(s), this machine has {have}; no result", file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # one process with one CPU thread a chip: the host is shared
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", bool(args.control), T0, marks=marks)
    loaded = sorted(set(out.pop("forbidden_loaded")) | set(forbidden_modules()))
    if loaded:
        print(f"run.py: modules of JAX or the JAX package are loaded: {loaded}; no result", file=sys.stderr)
        return 3
    for k, v in out["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out, default=lambda o: o.item() if isinstance(o, np.generic) else str(o)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
