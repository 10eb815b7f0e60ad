"""A/B timing of versions of the row kernel K2/K3 (``csrc/sw_rows.cu``) on one card.

Run from the repository root on a machine with one NVIDIA GPU and nvcc:

    git show cf27c3d:swtpu_torch/csrc/sw_rows.cu > swtpu_torch/build/parent_sw_rows.cu
    python -m swtpu_torch.tools.rows_ab --parent=swtpu_torch/build/parent_sw_rows.cu [--schedules]
        [--reps=N] [--json=PATH]

The versions: ``parent``, a source with the two entry points of the
design before the band-parallel wavefront (``sw_rows_fused_launch`` for a
(C, B, L) stack, ``sw_rows_launch`` for one bucket), compiled here with the
package's nvcc flags; and ``new``, the package's own kernel at the shape
``bucket_sw.rows_shape`` picks for each launch.  With ``--schedules`` the
package's kernel also runs every launch in each schedule whatever the rule
says: ``wave`` (the wavefront, G from the bands, on every launch of more
than one band), ``band32`` and ``band64`` (the band sweep at H = 32 and 64),
which is how the rule's crossover (``bucket_sw.BAND_ROWS``) was set.

The work is P01008's against the SwissProt-shaped database of
``chip_smoke.py`` (``synth.synth_database``, 559,228 sequences, seed 0):

* ``k2``: the 13 ladder groups of the resident row-path pack, one launch a
  group as ``SearchEngine._fused_stack`` makes them (``chip_smoke.py``'s
  ``rows.k2``);
* ``k3``: the 77 batches of the streamed plan (``SearchEngine.plan``,
  uploaded once), one launch a batch, as a streamed search makes them, shown
  by batch shape (rows, width);
* ``int16``: the ladder groups of the ``score_dtype="int16"`` mode's pack,
  which it scores through K2.

Versions run in turns (in order, then in reverse), each turn a warm run and
``--reps`` timed runs (default 3) of the whole work set, every launch
between CUDA events.  Prints, for each set, every group's or shape's mean
ms under each version with the spread over the runs, the sums, and with
``--schedules`` the launches in order of rows x C beside the two schedules'
times and the crossover interval that minimises the sum; checks that every
version's scores are equal to the first's.  Prints the card's name and
power limit.  Exits 1 without a CUDA device or on unequal scores.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

import torch

SCHEDULES = {"wave": 10**12, "band32": (1, 32), "band64": (1, 64)}


def _parse(argv):
    opts = {"parent": None, "schedules": False, "reps": 3, "json": None}
    for a in argv:
        if a == "--schedules":
            opts["schedules"] = True
        elif a.startswith("--parent="):
            opts["parent"] = a.split("=", 1)[1]
        elif a.startswith("--reps="):
            opts["reps"] = int(a.split("=", 1)[1])
        elif a.startswith("--json="):
            opts["json"] = a.split("=", 1)[1]
        else:
            raise SystemExit(f"rows_ab: unknown argument {a!r}\n{__doc__}")
    return opts


def _parent_lib(path: str) -> ctypes.CDLL:
    from ..ops import _build

    out = _build.BUILD / "ab" / "libparent_sw_rows.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out), path], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {path}:\n{proc.stdout}{proc.stderr}")
    print("parent registers", [int(w.split()[0]) for w in proc.stdout.split("Used ")[1:] + proc.stderr.split("Used ")[1:]],
          flush=True)
    lib = ctypes.CDLL(str(out))
    lib.sw_rows_fused_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.sw_rows_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib


def work_sets(db) -> Dict[str, dict]:
    """{set: {"profile": padded to whole bands, "stacks": [(C, B, L) launches
    on the card], "gap"}}."""
    from ..config import SWConfig
    from ..models.search import SearchEngine
    from ..ops.bucket_sw import _band_profile
    from ..utils.bucketing import iter_packed
    from . import buckets

    rg = buckets.swissprot_rows(db)
    prof = rg.profile()
    k2 = []
    for g in rg.groups:
        step = rg.engine._fused_step(prof, g.stack)
        k2 += [g.stack[i : i + step] for i in range(0, g.chunks, step)]
    streamed = SearchEngine(SWConfig(use_wave=False, device_resident=False), device="cuda")
    k3 = [torch.from_numpy(arr).cuda()[None] for _, arr in iter_packed(db, streamed.plan(db))]
    i16 = SearchEngine(SWConfig(score_dtype="int16"), device="cuda")
    i16_prof = i16._profile(rg.query)
    i16_stacks = []
    for g in i16._resident_packed(db).groups:
        step = i16._fused_step(i16_prof, g.stack)
        i16_stacks += [g.stack[i : i + step] for i in range(0, g.chunks, step)]
    prof, i16_prof = _band_profile(prof), _band_profile(i16_prof)
    return {"k2": {"profile": prof, "stacks": k2, "gap": rg.gap},
            "k3": {"profile": prof, "stacks": k3, "gap": rg.gap},
            "int16": {"profile": i16_prof, "stacks": i16_stacks, "gap": i16.config.gap_penalty}}


def main(argv) -> int:
    opts = _parse(argv)
    if not torch.cuda.is_available():
        print("rows_ab: no CUDA device: the kernels run on the card only", file=sys.stderr)
        return 1
    from .. import synth
    from ..ops import _build, bucket_sw
    from .roofline import card

    versions: Dict[str, object] = {}
    if opts["parent"]:
        versions["parent"] = _parent_lib(opts["parent"])
    new = bucket_sw._kernel_lib()
    versions["new"] = None  # rows_shape's choice
    if opts["schedules"]:
        versions.update(SCHEDULES)
    sets = work_sets(synth.synth_database(559_228, seed=0))
    where = _build.where(torch.device("cuda"))
    max_cells = max(s.numel() for ws in sets.values() for s in ws["stacks"])
    carry = torch.empty(max_cells, dtype=torch.int32, device="cuda")

    def shape_of(name, n_bands, rows):
        spec = versions[name]
        if spec is None:
            return bucket_sw.rows_shape(n_bands, rows)
        if isinstance(spec, tuple):
            return spec
        return bucket_sw.rows_shape(n_bands, rows, band_rows=spec)

    def calls(name, key, ws, outs):
        prof = ws["profile"]  # whole bands (work_sets), alive as long as the set
        n_bands = prof.shape[0] // bucket_sw.W
        out = []
        for stack, o in zip(ws["stacks"], outs):
            C, B, L = stack.shape
            args = (prof.data_ptr(), stack.data_ptr(), carry.data_ptr(), o.data_ptr())
            if name == "parent":
                lib = versions["parent"]
                if key == "k3":  # the parent's K3 kernel; its K2 kernel for every group, C = 1 included
                    out.append(lambda a=args, B=B, L=L: lib.sw_rows_launch(*a, n_bands, B, L, ws["gap"], *where))
                else:
                    out.append(lambda a=args, C=C, B=B, L=L: lib.sw_rows_fused_launch(*a, C, n_bands, B, L, ws["gap"],
                                                                                      *where))
            else:
                g, h = shape_of(name, n_bands, C * B)
                out.append(lambda a=args, C=C, B=B, L=L, g=g, h=h: new.sw_rows_launch(*a, C, n_bands, B, L, ws["gap"],
                                                                                       g, h, *where))
        return out

    def run(thunks) -> List[float]:
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in thunks]
        for fn, (a, b) in zip(thunks, ev):
            a.record()
            rc = fn()
            b.record()
            if rc:
                raise RuntimeError(f"launch failed ({rc})")
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in ev]

    smi = card()
    print(f"device: {smi}", flush=True)
    report = {"card": smi, "band_rows": bucket_sw.BAND_ROWS, "band_h": bucket_sw.BAND_H, "sets": {}}
    unequal = []
    order = list(versions) + list(reversed(versions))
    for key, ws in sets.items():
        outs = {n: [torch.zeros(s.shape[:2], dtype=torch.int32, device="cuda") for s in ws["stacks"]] for n in versions}
        thunks = {n: calls(n, key, ws, outs[n]) for n in versions}
        times: Dict[str, List[List[float]]] = {n: [] for n in versions}
        for name in order:
            run(thunks[name])  # warm
            for _ in range(opts["reps"]):
                times[name].append(run(thunks[name]))
        first = next(iter(versions))
        for name in versions:
            if not all(torch.equal(a, b) for a, b in zip(outs[name], outs[first])):
                unequal.append(f"{key}: {name}")
        n_bands = ws["profile"].shape[0] // bucket_sw.W
        report["sets"][key] = _report(key, ws["stacks"], n_bands, times, shape_of)
    if opts["schedules"]:  # one threshold for every launch of the three sets
        report["crossover"] = _crossover("all", [r for ws in report["sets"].values() for r in ws["shapes"]])
    if unequal:
        print(f"scores differ from the first version's: {unequal}", flush=True)
    if opts["json"]:
        Path(opts["json"]).parent.mkdir(parents=True, exist_ok=True)
        Path(opts["json"]).write_text(json.dumps(report))
    print(f"device: {smi}; every version's scores equal: {not unequal}", flush=True)
    return 1 if unequal else 0


def _report(key, stacks, n_bands, times, shape_of) -> dict:
    """Print one work set's table and return it: launches grouped by shape
    (chunks x rows x width), each version's mean ms a search with the
    [min, max] over the runs, the sums; with the schedules, the crossover."""
    names = list(times)
    keys = [tuple(s.shape) for s in stacks]
    shapes = sorted(set(keys), key=lambda k: (k[0] * k[1], k[2]))
    rows = []
    print(f"{key}: {len(stacks)} launches in {len(shapes)} shapes, {n_bands} bands; ms a search, mean [min, max] "
          f"over {len(times[names[0]])} runs", flush=True)
    for shp in shapes:
        idx = [i for i, k in enumerate(keys) if k == shp]
        per = {n: [sum(run[i] for i in idx) for run in times[n]] for n in names}
        row = {"chunks": shp[0], "rows": shp[1], "width": shp[2], "launches": len(idx),
               "shape": shape_of("new", n_bands, shp[0] * shp[1]),
               "ms": {n: sum(v) / len(v) for n, v in per.items()},
               "spread": {n: [min(v), max(v)] for n, v in per.items()}}
        rows.append(row)
        print(f"  {shp[0]}x{shp[1]}x{shp[2]} ({len(idx)}) G{row['shape'][0]}H{row['shape'][1]}: "
              + "  ".join(f"{n} {row['ms'][n]:.4f} [{row['spread'][n][0]:.4f}, {row['spread'][n][1]:.4f}]"
                          for n in names), flush=True)
    totals = {n: [sum(run) for run in times[n]] for n in names}
    total = {n: {"ms": sum(v) / len(v), "spread": [min(v), max(v)]} for n, v in totals.items()}
    print(f"  {key} all: " + "  ".join(f"{n} {t['ms']:.4f} [{t['spread'][0]:.4f}, {t['spread'][1]:.4f}]"
                                      for n, t in total.items()), flush=True)
    out = {"shapes": rows, "total": total}
    if "wave" in names and "band64" in names:
        out["crossover"] = _crossover(key, rows)
    return out


def _crossover(key, rows) -> dict:
    """The interval of rows x C thresholds (wavefront below, band sweep at
    H = 32 or 64 from there) that minimises this set's sum."""
    by_rows = sorted(rows, key=lambda r: r["chunks"] * r["rows"])
    best = {}
    for band in ("band32", "band64"):
        sums = []
        cuts = sorted({r["chunks"] * r["rows"] for r in by_rows}) + [None]
        for i, cut in enumerate(cuts):
            ms = sum(r["ms"]["wave"] if cut is None or r["chunks"] * r["rows"] < cut else r["ms"][band] for r in by_rows)
            low = cuts[i - 1] + 1 if i else 1
            sums.append((ms, low, cut))
        ms, low, high = min(sums)
        best[band] = {"ms": ms, "threshold_from": low, "threshold_to": high}
        print(f"  {key} crossover to {band}: sum {ms:.4f} ms with the threshold in [{low}, "
              f"{high if high is not None else 'inf'}] rows x C", flush=True)
    return best


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
