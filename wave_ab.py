"""A/B timing of versions of swtpu_torch/csrc/sw_wave.cu (and of int8_mma.cu's coarse pass) on one card.

Run from the repository root on a machine with one NVIDIA GPU and nvcc,
with a parent commit's sources in the gitignored build directory:

    git show 4969e45:swtpu_torch/csrc/sw_wave.cu > swtpu_torch/build/parent_sw_wave.cu
    git show 4969e45:swtpu_torch/csrc/int8_mma.cu > swtpu_torch/build/parent_int8_mma.cu
    python3 wave_ab.py --batch parent=swtpu_torch/build/parent_sw_wave.cu:2 new=swtpu_torch/csrc/sw_wave.cu:2:auto \\
        coarse:parent=swtpu_torch/build/parent_int8_mma.cu coarse:new=swtpu_torch/csrc/int8_mma.cu:grid
    python3 wave_ab.py --batch --buckets band=swtpu_torch/csrc/sw_wave.cu:2:0 \\
        wave=swtpu_torch/csrc/sw_wave.cu:2:1000000000

Each argument is NAME=PATH:FLAGS[:SHAPE].  FLAGS is the number of int
flags the version's C entry points take between the gaps and the device (0
before the band-carry hand-off, 2 since: has_top_in and put_last).  SHAPE,
for versions whose entry points take (G, H) after the flags (the band-
parallel wavefront), is "auto" (``wave_sw.wave_shape`` per launch, as the
package launches it) or a number N: ``wave_shape`` with the band sweep from
N (lane, segment) pairs instead of ``wave_sw.BAND_THREADS`` (0: the band
sweep on every bucket; a number above every bucket's pairs: the wavefront
on every launch of more than one band).  With --buckets each mode also
prints every bucket's time under every version, beside its (lane, segment)
pairs: where the band sweep and the wavefront cross.

Every version is compiled with the package's nvcc flags and timed in turns
(versions in order, then in reverse) on P01008's launches against the
SwissProt-shaped database of chip_smoke.py: the 27 fused launches, linear
(gap 2) and affine (10, 2); and with ``--batch`` the 17-query Performance suite's batch as chip_smoke.py's
serving phase launches it (351 multi-query launches, 13 pieces x 27
buckets, linear).  Prints each version's registers and, for each mode,
milliseconds a run (CUDA events around the run) and the narrow, mid and
full sums of per-launch events (swtpu_torch/tools/buckets.py's groups),
and checks that every version's scores equal the first version's.
Versions are compared within one run only.  With --json=PATH the table,
per-bucket times included, also goes to PATH.

With --dtypes (and no versions) it compares the package's own K1
routes instead, through the wrapper: ``wave_sw.sw_wave`` (the int16x2
kernel and its int32 rescore, as every cell runs it) against the int32
kernel (``wave_sw._sw_wave_route(..., int32=True)``), in turns (int32,
int16x2, int16x2, int32), linear (gap 2) and affine (10, 2), on P01008's
27 fused launches, the suite's batch (351 multi-query launches) and one
query at the middle of each sixteenth of SwissProt's length law (the
``single`` cells' 16 strata, 27 launches each), checking that both give
the same scores.  Add --buckets for each bucket's time under both, and
each of P01008's buckets timed at the band sweep (affine: at H = 32 and
64) and at the wavefront forced through ``shape=`` under both routes,
beside its (lane, segment) pairs: where the two schedules cross
(``wave_sw.BAND_THREADS``).

Arguments coarse:NAME=PATH[:grid] name versions of
swtpu_torch/csrc/int8_mma.cu instead (":grid" for entry points that take
their grid, ``int8_mma.coarse_grid``, before the device): each one's
coarse_counts entry point is timed in turns on a 559,228 x 1024 int8
signature matrix (the prefilter's at SwissProt scale, seeded 0/1 entries)
at Q = 1 and Q = 17, beside the package's own wrapper
``int8_mma.coarse_counts`` and torch._int_mm on the same product, each
with the host microseconds a call takes to return, and its counts checked
against the first version's.
"""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SUITE = ("P02232", "P05013", "P14942", "P07327", "P01008", "P42357", "P03435", "P21177", "Q38941",
         "P27895", "P07756", "P19096", "P28167", "P0C6B8", "P20930", "Q7TMA5", "P08519")
REPS = {"fused": 5, "batch": 1}


def parse(arg):
    """(name, path, n_flags, shape): shape None (no shape ints), "auto", or
    the band-sweep threshold in (lane, segment) pairs, an int."""
    name, spec = arg.split("=", 1)
    parts = spec.split(":")
    path, flags = Path(parts[0]), int(parts[1])
    shape = parts[2] if len(parts) > 2 else None
    return name, path, flags, shape if shape in (None, "auto") else int(shape)


def main(argv) -> int:
    import torch

    batch, by_bucket = "--batch" in argv, "--buckets" in argv
    json_path = next((a.split("=", 1)[1] for a in argv if a.startswith("--json=")), None)
    if "--dtypes" in argv:
        if not torch.cuda.is_available():
            print(__doc__, file=sys.stderr)
            return 1
        sys.path.insert(0, str(ROOT))
        return finish(dtype_ab(by_bucket), [], {}, json_path)
    coarse = dict(a[len("coarse:"):].split("=", 1) for a in argv if a.startswith("coarse:"))
    argv = [a for a in argv if a not in ("--batch", "--buckets") and not a.startswith(("coarse:", "--json="))]
    if not torch.cuda.is_available() or not (argv or coarse):
        print(__doc__, file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from swtpu_torch import synth
    from swtpu_torch.config import SWConfig
    from swtpu_torch.io.fasta import parse_query
    from swtpu_torch.models.search import SearchEngine
    from swtpu_torch.ops import _build, wave_sw
    from swtpu_torch.tools.buckets import GROUPS, group_of

    out_dir = _build.BUILD / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    versions = {name: (path, flags, shape) for name, path, flags, shape in map(parse, argv)}
    procs = {}
    for name, spec in coarse.items():
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"libcoarse_{name}.so"), spec.split(":")[0]]
        procs["coarse:" + name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, (path, _, shape) in versions.items():
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"), str(path)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        if name.startswith("coarse:"):
            continue
        print(name, "registers", [int(w.split()[0]) for w in log.split("Used ")[1:]], "spill bytes",
              sum(int(v) for v in re.findall(r"(\d+) bytes spill (?:stores|loads)", log)), flush=True)
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        n_ints = versions[name][1] + (2 if versions[name][2] is not None else 0)
        lib.sw_wave_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (7 + n_ints) + [ctypes.c_void_p]
        lib.sw_wave_affine_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (8 + n_ints) + [ctypes.c_void_p]
        libs[name] = lib

    table = {}
    if coarse:
        table.update(coarse_ab(coarse, out_dir))
    if not versions:
        return finish(table, [], {}, json_path)
    db = synth.synth_database(559_228, seed=0)
    engine = SearchEngine(SWConfig(), device="cuda")
    groups = engine._resident_packed(db).wave_groups
    kinds = [group_of(g) for g in groups]
    qdir = ROOT / "tests" / "data" / "queries"
    profile = engine._profile(parse_query(qdir / "P01008.fasta"))
    n_bands = profile.shape[0] // 32
    where = (torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    pieces = []
    if batch:
        queries = [parse_query(qdir / f"{q}.fasta") for q in SUITE]
        pieces = [engine._piece_profiles(queries, qpad, p) for qpad, p in engine._query_pieces(queries)]
    max_q = max([1] + [p.shape[0] for p in pieces])
    # A carry a bucket, sized for the affine mode's two planes or the batch's largest piece.
    carries = [torch.zeros(max(2, max_q) * (g.stack.shape[0] - 32) * g.lanes, dtype=torch.int32, device="cuda")
               for g in groups]
    outs = {name: [torch.zeros(max_q * g.lanes * g.n_segs, dtype=torch.int32, device="cuda") for g in groups]
            for name in versions}

    def shape_of(name, nb, g, affine):
        shape = versions[name][2]
        if shape is None:
            return ()
        if shape == "auto":
            return wave_sw.wave_shape(nb, g.lanes, g.n_segs, affine)
        return wave_sw.wave_shape(nb, g.lanes, g.n_segs, affine, band_threads=shape)

    def launches(name, mode, affine):
        """[(bucket index, launch thunk)] of one run of a mode."""
        lib, n_flags = libs[name], versions[name][1]
        calls = []
        if mode == "batch":
            for prof in pieces:
                for k, g in enumerate(groups):
                    calls.append((k, prof, prof.shape[0], prof.shape[1] // 32, g, (0,) * n_flags))
        else:
            for k, g in enumerate(groups):
                calls.append((k, profile, 1, n_bands, g, (0,) * n_flags))
        out = []
        for k, prof, n_q, nb, g, flags in calls:
            args = (prof.data_ptr(), g.stack.data_ptr(), carries[k].data_ptr(), outs[name][k].data_ptr(), n_q, nb,
                    g.lanes, g.n_segs, g.seg_cols)
            tail = (*flags, *shape_of(name, nb, g, affine), *where)

            def call(args=args, tail=tail):
                rc = (lib.sw_wave_affine_launch(*args, 10, 2, *tail) if affine else lib.sw_wave_launch(*args, 2, *tail))
                if rc:
                    raise RuntimeError(f"{name}: launch failed ({rc})")
            out.append((k, call))
        return out

    def run(calls):
        """(ms of the run, {group: ms of its launches})."""
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in calls]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for (k, call), (a, b) in zip(calls, ev):
            a.record()
            call()
            b.record()
        end.record()
        end.synchronize()
        sums = dict.fromkeys(GROUPS, 0.0)
        per_bucket = [0.0] * len(groups)
        for (k, _), (a, b) in zip(calls, ev):
            sums[kinds[k]] += a.elapsed_time(b)
            per_bucket[k] += a.elapsed_time(b)
        return start.elapsed_time(end), sums, per_bucket

    modes = [("fused", False), ("fused", True)]
    if batch:
        modes.append(("batch", False))
    order = list(versions) + list(reversed(versions))
    first = next(iter(versions))
    for mode, affine in modes:
        key = f"{mode} {'affine 10/2' if affine else 'linear 2'}"
        calls = {name: launches(name, mode, affine) for name in versions}
        scores = {}
        for name in order:
            for k, call in calls[name]:  # warm, and the scores this version gives
                call()
            torch.cuda.synchronize()
            scores[name] = [o.clone() for o in outs[name]]
            for _ in range(REPS[mode]):
                ms, sums, per_bucket = run(calls[name])
                table.setdefault(key, {}).setdefault(name, []).append({"ms": ms, **sums, "buckets": per_bucket})
        for name in versions:
            if name != first:
                if not all(torch.equal(a, b) for a, b in zip(scores[name], scores[first])):
                    raise AssertionError(f"{key}: {name}'s scores differ from {first}'s")
        for name, runs in table[key].items():
            mean = {f: sum(r[f] for r in runs) / len(runs) for f in ("ms", *GROUPS)}
            print(key, name, "ms:", round(mean["ms"], 3), "narrow/mid/full:",
                  [round(mean[gr], 3) for gr in GROUPS], "runs:", [round(r["ms"], 3) for r in runs], flush=True)
        if by_bucket:
            for k in sorted(range(len(groups)), key=lambda k: groups[k].lanes * groups[k].n_segs):
                g = groups[k]
                ms = {name: sum(r["buckets"][k] for r in runs) / len(runs) for name, runs in table[key].items()}
                print(key, f"bucket {k} {g.width}x{g.n_segs} lanes {g.lanes} pairs {g.lanes * g.n_segs} {kinds[k]}:",
                      " ".join(f"{name} {v:.4f}" for name, v in ms.items()), flush=True)
    buckets = [dict(width=g.width, n_segs=g.n_segs, lanes=g.lanes, group=kind) for g, kind in zip(groups, kinds)]
    return finish(table, buckets, versions, json_path)


def dtype_ab(by_bucket):
    """{mode: {route: [{"ms", "buckets"}, ...]}} of the int16x2 and int32
    routes of sw_wave, and with ``by_bucket`` {"crossover ...": {route and
    schedule: [ms a bucket]}} (module docstring)."""
    import math
    from statistics import NormalDist

    import numpy as np
    import torch

    from swtpu_torch import synth
    from swtpu_torch.config import SWConfig
    from swtpu_torch.io.fasta import Query, parse_query
    from swtpu_torch.models.search import SearchEngine
    from swtpu_torch.ops import wave_sw

    db = synth.synth_database(559_228, seed=0)
    engine = SearchEngine(SWConfig(), device="cuda")
    groups = engine._resident_packed(db).wave_groups
    qdir = ROOT / "tests" / "data" / "queries"
    suite = [parse_query(qdir / f"{q}.fasta") for q in SUITE]
    rng = np.random.default_rng(0)
    lengths = [min(8000, max(20, round(math.exp(5.67 + 0.62 * NormalDist().inv_cdf((k + 0.5) / 16)))))
               for k in range(16)]
    strata = [Query(name=f"len{n}", residues=rng.integers(0, 25, n).astype(np.int8), raw="") for n in lengths]
    modes = {
        "P01008": [engine._profile(parse_query(qdir / "P01008.fasta"))],
        "suite17": [engine._piece_profiles(suite, qpad, p) for qpad, p in engine._query_pieces(suite)],
        "single16": [engine._profile(q) for q in strata],
    }
    print("single16 lengths", lengths, flush=True)
    routes = {
        "int32": lambda prof, g, kw, shape=None: wave_sw._sw_wave_route(
            prof, g.stack, n_segs=g.n_segs, shape=shape, int32=True, **kw),
        "int16x2": lambda prof, g, kw, shape=None: wave_sw.sw_wave(prof, g.stack, n_segs=g.n_segs, shape=shape, **kw),
    }
    gap_modes = {"linear 2": dict(gap=2), "affine 10/2": dict(gap_open=10, gap_extend=2)}

    def timed(calls):
        """(ms of the run, [ms a call], [scores a call])."""
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in calls]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        outs = []
        start.record()
        for call, (a, b) in zip(calls, ev):
            a.record()
            outs.append(call())
            b.record()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), [a.elapsed_time(b) for a, b in ev], outs

    table = {}
    for mode, profiles in modes.items():
        for gname, kw in gap_modes.items():
            key = f"{mode} {gname}"
            scores = {}
            for route in ("int32", "int16x2", "int16x2", "int32"):
                fn = routes[route]
                calls = [lambda prof=prof, g=g: fn(prof, g, kw) for prof in profiles for g in groups]
                if route not in scores:
                    scores[route] = [o.clone() for o in timed(calls)[2]]  # warm, and the scores
                ms, per_call, _ = timed(calls)
                per_bucket = [sum(per_call[i] for i in range(k, len(calls), len(groups))) for k in range(len(groups))]
                table.setdefault(key, {}).setdefault(route, []).append({"ms": ms, "buckets": per_bucket})
            if not all(torch.equal(a, b) for a, b in zip(scores["int32"], scores["int16x2"])):
                raise AssertionError(f"{key}: the int16x2 route's scores differ from the int32 kernel's")
            runs = table[key]
            mean = {r: sum(x["ms"] for x in v) / len(v) for r, v in runs.items()}
            print(key, " ".join(f"{r} ms: {mean[r]:.3f} {[round(x['ms'], 3) for x in runs[r]]}" for r in runs),
                  f"int32/int16x2: {mean['int32'] / mean['int16x2']:.3f}", flush=True)
            if by_bucket:
                for k in sorted(range(len(groups)), key=lambda k: groups[k].lanes * groups[k].n_segs):
                    g = groups[k]
                    ms = {r: sum(x["buckets"][k] for x in v) / len(v) for r, v in runs.items()}
                    print(key, f"bucket {k} {g.width}x{g.n_segs} lanes {g.lanes} pairs {g.lanes * g.n_segs}:",
                          " ".join(f"{r} {v:.4f}" for r, v in ms.items()), flush=True)
    if by_bucket:  # the band sweep against the wavefront, bucket by bucket, under both routes
        for mode in ("P01008",):
            for gname, kw in gap_modes.items():
                affine = "gap_open" in kw
                key = f"crossover {mode} {gname}"
                for route, fn in routes.items():
                    for sched in ("sweep", "sweep H64", "wave") if affine else ("sweep", "wave"):
                        calls = []
                        for prof in modes[mode]:
                            nb = prof.shape[-2] // 32
                            for g in groups:
                                shape = ((1, wave_sw.BAND_H[affine]) if sched == "sweep" else (1, 64)
                                         if sched == "sweep H64" else
                                         wave_sw.wave_shape(nb, g.lanes, g.n_segs, affine, band_threads=1 << 40))
                                calls.append(lambda prof=prof, g=g, shape=shape: fn(prof, g, kw, shape))
                        timed(calls)
                        _, per_call, _ = timed(calls)
                        per_bucket = [sum(per_call[i] for i in range(k, len(calls), len(groups)))
                                      for k in range(len(groups))]
                        table.setdefault(key, {})[f"{route} {sched}"] = per_bucket
                for k in sorted(range(len(groups)), key=lambda k: groups[k].lanes * groups[k].n_segs):
                    g = groups[k]
                    print(key, f"bucket {k} pairs {g.lanes * g.n_segs}:",
                          " ".join(f"{name} {v[k]:.4f}" for name, v in table[key].items()), flush=True)
    return table


def finish(table, buckets, versions, json_path) -> int:
    from swtpu_torch.tools.roofline import card

    smi = card()
    print(smi)
    if json_path:
        Path(json_path).parent.mkdir(parents=True, exist_ok=True)
        Path(json_path).write_text(json.dumps({"card": smi, "buckets": buckets, "table": table,
                                               "versions": {n: [str(p), f, str(s)] for n, (p, f, s) in versions.items()}}))
    return 0


def coarse_ab(coarse, out_dir):
    """{mode: {name: [ms, ...]}} of each int8_mma.cu version's coarse kernel,
    the package's wrapper and torch._int_mm, in turns, at Q = 1 and 17, and
    {mode host: {name: [host microseconds a call, ...]}}."""
    import time

    import torch

    from swtpu_torch.ops import int8_mma

    libs, grids = {}, {}
    for name, spec in coarse.items():
        lib = ctypes.CDLL(str(out_dir / f"libcoarse_{name}.so"))
        grids[name] = spec.endswith(":grid")
        n_ints = 6 if grids[name] else 4
        lib.int8_mma_coarse_counts_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        libs[name] = lib
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n, dim = 559_228, 1024
    sig = (torch.rand(n, dim, device="cuda", generator=gen) < 0.1).to(torch.int8)
    where = (torch.cuda.current_device(), torch.cuda.current_stream().cuda_stream)
    table = {}
    for n_q in (1, 17):
        qs = (torch.rand(n_q, dim, device="cuda", generator=gen) < 0.1).to(torch.int8)
        padded = torch.zeros(-(-n_q // 8) * 8, dim, dtype=torch.int8, device="cuda")
        padded[:n_q] = qs
        outs = {name: torch.empty(n_q, n, dtype=torch.int32, device="cuda") for name in coarse}
        grid = int8_mma.coarse_grid(n, n_q, torch.cuda.get_device_properties(0).multi_processor_count)
        calls = {name: (lambda lib=lib, o=outs[name], g=grid if grids[name] else (): lib.int8_mma_coarse_counts_launch(
            sig.data_ptr(), qs.data_ptr(), o.data_ptr(), n, n_q, dim, *g, *where)) for name, lib in libs.items()}
        calls["wrapper"] = lambda: int8_mma.coarse_counts(qs, sig)
        calls["torch._int_mm"] = lambda: torch._int_mm(sig, padded.t())
        key = f"coarse Q={n_q}"
        for name in list(calls) + list(reversed(calls)):
            want = calls[name]()  # warm
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            for _ in range(20):
                rc = calls[name]()
                if isinstance(rc, int) and rc:
                    raise RuntimeError(f"{name}: coarse launch failed ({rc})")
            host_us = (time.perf_counter() - t0) / 20 * 1e6
            end.record()
            end.synchronize()
            table.setdefault(key, {}).setdefault(name, []).append(start.elapsed_time(end) / 20)
            table.setdefault(key + " host", {}).setdefault(name, []).append(host_us)
            if name == "wrapper":
                outs["wrapper"] = want
        first = next(iter(coarse))
        for name in [*coarse, "wrapper"]:
            if not torch.equal(outs[name], outs[first]):
                raise AssertionError(f"{key}: {name}'s counts differ from {first}'s")
        for name, runs in table[key].items():
            print(key, name, "ms:", [round(v, 4) for v in runs], "host us a call:",
                  [round(v, 1) for v in table[key + " host"][name]], flush=True)
    return table


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
