#!/usr/bin/env python3
"""One traced run of a cell, and where its window's time went by the
program's own spans.

    python3 benchmark/span_breakdown.py --workload <config>.<traffic> --seed <n> --seconds <s>

Runs the cell as ``run.py --trace 1`` does and prints its result line,
then one JSON line: ``self_ms``, {label: [wall ms, idle ms]} with each
stretch of the window given to the innermost ``swtpu.`` span open in it
(``swbench.spans.self_times``), and the counts of each span.  Against a
program without spans it prints ``self_ms`` null.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import run  # noqa: E402
from swbench import spans  # noqa: E402


def main(argv=None) -> int:
    kept = []
    traced = run._traced

    def keep(*args, **kw):
        window, trace = traced(*args, **kw)
        kept.append(trace)
        return window, trace

    run._traced = keep
    try:
        rc = run.main([*(sys.argv[1:] if argv is None else argv), "--trace", "1"])
    finally:
        run._traced = traced
    if kept:
        trace = kept[0]
        counts = {}
        for _, _, name in trace.host:
            if name.startswith(spans.PREFIX):
                counts[name] = counts.get(name, 0) + 1
        print(json.dumps(dict(self_ms=spans.self_times(trace), span_counts=counts, requests=len(trace.requests))))
    return rc


if __name__ == "__main__":
    sys.exit(main())
