"""Cells cut to a size the CPU tests can hold: a few thousand subjects of
at most 600 residues, a few queries, a small check sample.  Shapes and
semantics stay those of the files the cell names."""

import copy
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

from swbench import spec  # noqa: E402

SEED = 2**31 + 12345  # larger than 32 signed bits hold


def small(bench, cell, n=2500, count=5, vendored=("P02232", "P05013")):
    """(config, mix) of ``cell`` at test size."""
    w = spec.cell(bench, cell)
    cfg = copy.deepcopy(spec.config(bench, w["config"]))
    mix = copy.deepcopy(spec.traffic(w["traffic"]))
    cfg["database"].update(sequences=n, max_length=600)
    rename = {}
    for g in mix["queries"]:
        if "count" in g:
            g["count"] = count
        if g["source"] == "vendored":
            names = g["names"]
            g["names"] = list(vendored[: len(names)]) if len(names) > 1 else [vendored[-1]]
            rename.update(zip(names, g["names"]))
            rename[names[-1]] = g["names"][-1]
    for p in mix["order"].get("periodic", []):
        p.update(query=rename[p["query"]], every=3, first=1)
    for key in ("always", "no_full_scan"):
        if key in mix["check"]:
            mix["check"][key] = [rename[x] for x in mix["check"][key]]
    mix["check"].update(units=6, subjects=40, full_scans=1)
    return cfg, mix
