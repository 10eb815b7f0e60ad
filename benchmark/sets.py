#!/usr/bin/env python3
"""Run cells of the benchmark one after another, each a process of its own,
and keep every result line.

    python3 benchmark/sets.py --out results/sets.jsonl CELL:SEED:SECONDS[:TRACE[:CONTROL]] ...

Writes one JSON object a run to ``--out`` (the command, its exit code and
seconds, the result line, the end of standard error), prints a line a run
and, for each cell run untraced more than once, each metric's median and
the spread of its runs (interquartile range over the median,
``statistics.quantiles(n=4)``).  The card's name and power limit come
first.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

RUN = Path(__file__).resolve().parent / "run.py"


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print("card:", smi.stdout.strip(), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    by_cell = {}
    with out.open("a") as fh:
        for item in args.runs:
            cell, seed, seconds, *rest = item.split(":")
            trace, control = (rest + ["0", "0"])[:2]
            cmd = [sys.executable, str(RUN), "--workload", cell, "--seed", seed, "--seconds", seconds,
                   "--trace", trace, "--control", control]
            clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
                                     "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            after = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,temperature.gpu,power.draw",
                                    "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
            lines = proc.stdout.strip().splitlines()
            result = None
            if proc.returncode == 0 and lines:
                result = json.loads(lines[-1])
            rec = dict(cell=cell, seed=int(seed), seconds=float(seconds), trace=int(trace), control=int(control),
                       rc=proc.returncode, wall_s=wall, card=smi.stdout.strip(), clocks_before=clocks, clocks_after=after, result=result,
                       stderr_tail=proc.stderr[-3000:])
            fh.write(json.dumps(rec) + "\n")
            fh.flush()
            if result is None:
                print(f"{cell} seed {seed}: rc {proc.returncode} in {wall:.1f}s\n{proc.stderr[-2500:]}", flush=True)
                continue
            m = {k: round(v["value"], 4) for k, v in result["metrics"].items()}
            chk = {k: v["value"] for k, v in result["check"].items()}
            print(f"[{clocks}] {cell} seed {seed} trace {trace} control {control}: correct {result['correct']} wall {wall:.1f}s "
                  f"ref {result.get('reference_s', 0):.1f}s device {result.get('window_device_s', 0):.2f}s [{after}] attempted {result['attempted']} {m} check {chk} "
                  f"peak {result['device']['memory_peak_bytes']} setup {json.dumps(result.get('setup_parts_s'))} "
                  f"slowest {json.dumps(result.get('slowest_requests'))}"
                  + (f" busy {result['device']['busy_s']:.3f}/{result['device']['window_s']:.3f}"
                     f" breakdown {json.dumps(result.get('breakdown'))[:900]}" if int(trace) else ""), flush=True)
            if not int(trace) and not int(control):
                by_cell.setdefault(cell, []).append(result["metrics"])
    for cell, runs in by_cell.items():
        for name in runs[0]:
            vals = [r[name]["value"] for r in runs if name in r]
            s = spread(vals)
            print(f"summary {cell} {name}: n {len(vals)} median {statistics.median(vals):.6g} "
                  f"spread {'-' if s is None else f'{s:.5f}'} values {[round(v, 4) for v in vals]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
