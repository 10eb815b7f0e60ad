"""On-card check of swtpu_torch: build, compare, search at SwissProt scale.

Run from the repository root on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero with no result line):
  1. card     name, power limit, torch and CUDA versions
  2. build    nvcc of every kernel source at once; seconds, registers, spills
  3. kernel   each kernel against its plain PyTorch version on seeded random
              buckets (chain factors 1/2/3/8, odd lane counts, one and many
              bands, widths 32 to 4100): exact equality
  4. goldens  the committed subset, 10k-scale and saturation goldens through
              SearchEngine(device="cuda"): exact equality
  5. scale    a SwissProt-shaped database of 559,228 sequences (bench.py's
              recipe, seed 0) packed on the card and searched with P01008
              through the user entry points; kernel launch counts are zeroed
              just before the first search and read just after; three timed
              searches; every score against the plain version on the card
  6. kernels  one JSON line per kernel: launches on the main path, error,
              time, plain time and the card's lower bound for the same work
The last line is {"ok": true, "device": {...}} and appears only if all passed.
"""

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Lower-bound rates of an H100 SXM at 700 W.  Memory: 3.35 TB/s (data sheet).
# int32 ALU: 132 SMs x 64 int32 lanes x 1.98 GHz boost = 16.7e12 operations/s.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
OPS_PER_CELL = 6  # add, max, subtract, max, clamp at 0, running-best max
N_SEQS = 559_228
MAIN_QUERY = "P01008"


def say(phase, **kw):
    print(f"{phase}: " + json.dumps(kw, sort_keys=False), flush=True)


def events_ms(fn, reps=1):
    """Mean device milliseconds of fn() over reps (CUDA events)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = None
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def phase_card():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("card", name=torch.cuda.get_device_name(0), nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def phase_build():
    import re

    from swtpu_torch.ops import _build

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    for name in names:  # build from the sources every run, never from a stale library
        _build.library_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    built = _build.build(*names)
    for name in names:
        log = built[name]["log"]
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
        say("build", source=f"swtpu_torch/csrc/{name}.cu", seconds=round(time.perf_counter() - t0, 3),
            registers=[int(r) for r in regs], spill_bytes=[int(a) + int(b) for a, b in spills])
        if not log:
            raise RuntimeError(f"{name}: no nvcc log: the library was not built by this run")


def random_bucket(rng, qlen, ws, n_segs, lanes):
    """Seeded random profile and chained bucket; all but the last flat slot hold a subject."""
    import numpy as np
    import torch

    from swtpu_torch.matrices import blosum50_ref
    from swtpu_torch.ops.profile import PAD_SUBJECT, make_profile

    prof = make_profile(rng.integers(0, 25, qlen).astype(np.int8), blosum50_ref(), pad_rows_to=32)
    stack = np.full((n_segs * ws + 32, lanes), PAD_SUBJECT, dtype=np.int8)
    lens = rng.integers(1, ws + 1, lanes * n_segs - 1)
    for k, n in enumerate(lens):
        stack[(k % n_segs) * ws : (k % n_segs) * ws + n, k // n_segs] = rng.integers(0, 25, n)
    return torch.from_numpy(prof).cuda(), torch.from_numpy(stack).cuda()


def phase_kernel():
    import numpy as np
    import torch

    from swtpu_torch.ops import wave_sw

    rng = np.random.default_rng(0)
    cases = [  # (query length, segment width, n_segs, lanes)
        (20, 32, 1, 64), (33, 48, 2, 77), (100, 96, 3, 130), (464, 40, 8, 1001),
        (464, 736, 1, 3000), (147, 2208, 6, 333), (464, 4100, 1, 129), (1000, 160, 4, 515),
    ]
    worst = 0
    for qlen, ws, n_segs, lanes in cases:
        prof, stack = random_bucket(rng, qlen, ws, n_segs, lanes)
        got = wave_sw.sw_wave(prof, stack, gap=2, n_segs=n_segs)
        want = wave_sw.sw_wave_plain(prof, stack, gap=2, n_segs=n_segs)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        if err or not torch.equal(got, want):
            raise AssertionError(f"kernel != plain at qlen={qlen} ws={ws} n_segs={n_segs} lanes={lanes}: max err {err}")
    say("kernel", cases=len(cases), max_abs_err=worst, tolerance="exact")
    return worst


def phase_goldens():
    import numpy as np

    from swtpu_torch import synth
    from swtpu_torch.config import SWConfig
    from swtpu_torch.io.fasta import Query, parse_database, parse_query
    from swtpu_torch.models.search import SearchEngine

    data = ROOT / "tests" / "data"
    checked = []

    def check(name, scores, golden_file):
        golden = np.loadtxt(data / golden_file, dtype=np.int64)
        if not np.array_equal(scores, golden):
            bad = int((scores != golden).sum())
            raise AssertionError(f"golden {name}: {bad} of {golden.size} scores differ")
        checked.append(name)

    subset = parse_database(data / "uniprot_subset.fasta")
    eng = SearchEngine(SWConfig(), device="cuda")
    for q in ("P02232", "P01008", "P05013"):
        check(q, eng.search(parse_query(data / "queries" / f"{q}.fasta"), subset).scores, f"golden_{q}_subset.txt")
    q = parse_query(data / "queries" / "P02232.fasta")
    res = SearchEngine(device="cuda").search(q, synth.database_from_arrays(synth.synth_scale_db(q.residues)))
    check("scale10k", res.scores, "golden_P02232_scale10k.txt")
    query, seqs = synth.synth_sat_case()
    res = SearchEngine(device="cuda").search(Query("sat", query, ""), synth.database_from_arrays(seqs))
    check("saturation", res.scores, "golden_sat_case.txt")
    say("goldens", checked=checked, tolerance="exact")


def phase_scale():
    import numpy as np
    import torch

    from swtpu_torch import synth
    from swtpu_torch.config import SWConfig
    from swtpu_torch.io.fasta import parse_query
    from swtpu_torch.models.search import SearchEngine
    from swtpu_torch.ops import wave_sw
    from swtpu_torch.ops.profile import make_profile

    t0 = time.perf_counter()
    db = synth.synth_database(N_SEQS, seed=0)
    query = parse_query(ROOT / "tests" / "data" / "queries" / f"{MAIN_QUERY}.fasta")
    say("scale.data", sequences=db.n, residues=db.length_sum, longest=int(db.lengths.max()),
        query=MAIN_QUERY, query_length=query.length, seconds=round(time.perf_counter() - t0, 3))

    torch.cuda.reset_peak_memory_stats()
    engine = SearchEngine(SWConfig(), device="cuda")
    # --- the main path: user entry points, counts zeroed just before, read just after
    wave_sw.sw_wave.launches = 0
    t0 = time.perf_counter()
    first = engine.search(query, db)  # packs the database on the card, then scores
    first_wall = time.perf_counter() - t0
    launches = {"sw_wave": wave_sw.sw_wave.launches}
    packed = engine._resident_packed(db)
    groups = packed.wave_groups
    if launches["sw_wave"] != len(groups) or launches["sw_wave"] == 0:
        raise AssertionError(f"main path launched sw_wave {launches['sw_wave']} times for {len(groups)} buckets")

    runs = []
    for _ in range(3):
        res = engine.search(query, db)
        if res.metrics.kernel_launches != len(groups) or not np.array_equal(res.scores, first.scores):
            raise AssertionError("timed search differs from the first one")
        runs.append(res.metrics)
    dev_s = [m.device_seconds for m in runs]
    resident = sum(g.stack.numel() for g in groups)
    say("scale.search", first_search_wall_s=first_wall, device_seconds=dev_s,
        gcups_device=[m.gcups_device for m in runs], gcups_device_padded=[m.gcups_device_padded for m in runs],
        wall_seconds=[m.wall_seconds for m in runs], transfer_seconds=[m.transfer_seconds for m in runs],
        host_phases_seconds=[m.phases for m in runs], buckets=len(groups), launches_per_search=runs[-1].kernel_launches, resident_bytes=resident,
        max_memory_allocated=torch.cuda.max_memory_allocated())

    # --- the kernel alone, per search and per bucket, and its plain version
    gap = engine.config.gap_penalty
    profile = torch.from_numpy(make_profile(query.residues, engine.matrix, pad_rows_to=wave_sw.W)).cuda()
    kernel_all = lambda: [wave_sw.sw_wave(profile, g.stack, gap=gap, n_segs=g.n_segs) for g in groups]  # noqa: E731
    events_ms(kernel_all)  # warm
    kernel_ms, _ = events_ms(kernel_all, reps=3)
    per_bucket = []
    for g in groups:
        ms, _ = events_ms(lambda g=g: wave_sw.sw_wave(profile, g.stack, gap=gap, n_segs=g.n_segs))
        per_bucket.append((g.width, g.n_segs, g.lanes, g.lanes * g.n_segs, g.cells * profile.shape[0], round(ms, 4)))
    plain_ms, plain = events_ms(lambda: [wave_sw.sw_wave_plain(profile, g.stack, gap=gap, n_segs=g.n_segs) for g in groups])
    plain_scores = engine._reduce_flat(torch.cat(plain).cpu().numpy(), packed)
    err = int(np.abs(plain_scores.astype(np.int64) - first.scores.astype(np.int64)).max())
    if err or not np.array_equal(plain_scores, first.scores):
        raise AssertionError(f"full-scale scores differ from the plain version: max err {err}")

    qpad = profile.shape[0]
    cells = sum(qpad * g.n_segs * g.seg_cols * g.lanes for g in groups)
    nbytes = sum(g.stack.numel() + qpad * 32 + 4 * g.rows for g in groups)
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * OPS_PER_CELL * cells / INT32_OPS_PER_S
    bound_ms = max(bytes_ms, ops_ms)
    say("scale.kernel", kernel_ms_per_search=kernel_ms, kernel_ms_per_launch=kernel_ms / len(groups),
        plain_ms_per_search=plain_ms, bound_ms=bound_ms, bound_share=bound_ms / kernel_ms,
        cells_per_search=cells, true_cells=query.length * db.length_sum, max_abs_err_vs_plain=err)
    say("scale.buckets", columns=["width", "n_segs", "lanes", "threads", "cells", "ms"], rows=per_bucket)
    return {
        "name": "sw_wave", "route": "cuda", "source": "swtpu_torch/csrc/sw_wave.cu",
        "replaces": "swtpu/ops/wave_sw.py:815", "launches": launches["sw_wave"], "max_abs_err": err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None,
    }


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not installed: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import swtpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: swtpu_torch not found beside this script: {e}", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    try:
        smi = phase_card()
        phase_build()
        kernel_err = phase_kernel()
        phase_goldens()
        entry = phase_scale()
    except Exception:  # every phase failure ends the run without a result
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    entry["max_abs_err"] = max(entry["max_abs_err"], kernel_err)
    print(json.dumps({"kernels": [entry]}))
    print(smi)
    say("done", seconds=round(time.perf_counter() - t0, 3))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
