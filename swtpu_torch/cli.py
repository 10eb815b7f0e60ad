"""Command-line driver, in swtpu's output format.

Required ``--query``/``--db``, the full ``id:score`` dump, and the METRICS
block of the reference CLI.  Runs on the card unless ``--device cpu``.
Flags of features not ported yet are not accepted.

Usage::

    python -m swtpu_torch --query tests/data/queries/P01008.fasta --db swissprot.fasta
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

from .config import SWConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="swtpu_torch", description="Smith-Waterman database search on an NVIDIA GPU")
    p.add_argument("--query", required=True, help="query FASTA file")
    p.add_argument("--db", required=True, help="database FASTA file")
    p.add_argument("--device", default="cuda", help="torch device to search on (default: cuda; 'cpu' runs the plain PyTorch version)")
    p.add_argument("--matrix", default="blosum50_ref", help="substitution matrix name, or a path to an NCBI-format matrix text file")
    p.add_argument("--gap", type=int, default=2, help="linear gap penalty")
    p.add_argument("--no-scores", action="store_true", help="skip the per-sequence score dump")
    p.add_argument("--json", action="store_true", help="emit metrics as one JSON line")
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    t_start = time.perf_counter()  # the timer spans parsing, like the reference CLI

    from .io.fasta import parse_database, parse_query
    from .models.search import SearchEngine

    try:
        config = SWConfig(gap_penalty=args.gap, matrix=args.matrix)
    except ValueError as e:
        print(f"swtpu_torch: error: {e}", file=sys.stderr)
        return 2

    query = parse_query(args.query)
    print(f"Input buffer:{query.raw}")
    print()
    db = parse_database(args.db)
    try:
        engine = SearchEngine(config, device=args.device)
    except (RuntimeError, ValueError) as e:
        print(f"swtpu_torch: error: {e}", file=sys.stderr)
        return 2
    result = engine.search(query, db)

    if not args.no_scores:
        sys.stdout.write("\n".join(f"{i}:{s}" for i, s in enumerate(result.scores.tolist())))
        sys.stdout.write("\n")
    elapsed = time.perf_counter() - t_start
    if args.json:
        d = result.metrics.to_dict()
        d["wall_seconds_cli"] = elapsed
        print(json.dumps(d))
    else:
        print(result.metrics.format_reference_block(elapsed=elapsed))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
