"""Command-line driver, in swtpu's output format.

Required ``--query``/``--db``, the full ``id:score`` dump (or the ``--top-k``
hits, with E-values and bit scores under ``--evalue``; or the
``--align-top-k`` alignments), and the METRICS block of the reference CLI.
Linear gaps (``--gap``) or affine ones (``--gap-open``/``--gap-extend``);
the wavefront kernel, or the row-parallel path (``--no-wave``, ``--pallas``
for the CUDA kernels K2 and K3, ``--score-dtype int16`` for the narrow-type
parity mode, ``--batch-rows``/``--length-quantum`` for its ladder);
``--prefilter FRAC`` for the
heuristic two-phase search (k-mer coarse pass, exact rescore of the top
candidates; requires ``--top-k``); ``--mesh N`` to shard the database
over N cards (N CPU shards with ``--device cpu``) on every one of those
paths, with ``--query-shard`` to shard the query's bands instead;
``--profile DIR`` to write a ``torch.profiler`` Chrome trace of the search
to ``DIR/swtpu_torch_trace.json``.  Runs on the card unless ``--device
cpu``.  A refused combination exits 2.  The
multi-process fleet has its own entry point, ``python -m
swtpu_torch.parallel.launch``.

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
    p.add_argument(
        "--gap-open",
        type=int,
        default=None,
        help="affine gaps (wavefront kernel): a length-L gap costs OPEN + (L-1)*EXTEND; requires --gap-extend",
    )
    p.add_argument("--gap-extend", type=int, default=None, help="affine gap extension penalty")
    p.add_argument("--score-dtype", choices=["int32", "int16"], default="int32")
    p.add_argument("--top-k", type=int, default=None, help="print only the K best hits (device top-K)")
    p.add_argument(
        "--align-top-k",
        type=int,
        default=None,
        metavar="K",
        help="reconstruct and print gapped alignments for the K best hits (two-phase traceback)",
    )
    p.add_argument(
        "--evalue",
        action="store_true",
        help="with --top-k: report E-values and bit scores per hit, from an empirical "
        "length-corrected Gumbel fit of this query's score distribution (swtpu_torch.stats)",
    )
    p.add_argument(
        "--max-evalue",
        type=float,
        default=None,
        metavar="X",
        help="with --evalue: print only hits with E-value <= X",
    )
    p.add_argument("--no-scores", action="store_true", help="skip the per-sequence score dump")
    p.add_argument("--json", action="store_true", help="emit metrics as one JSON line")
    p.add_argument(
        "--pallas",
        action="store_true",
        help="row path: score through the CUDA kernels K2 and K3 (default: auto, on with a CUDA device)",
    )
    p.add_argument("--no-pallas", action="store_true", help="row path: force the PyTorch scorers")
    p.add_argument(
        "--wave",
        dest="wave",
        action="store_true",
        default=None,
        help="force the wavefront kernel (default: auto, on unless --score-dtype int16)",
    )
    p.add_argument("--no-wave", dest="wave", action="store_false", help="disable the wavefront kernel")
    p.add_argument(
        "--prefilter",
        type=float,
        default=None,
        metavar="FRAC",
        help="heuristic two-phase mode: k-mer int8 coarse pass, then exact rescore of the top FRAC "
        "of the database (requires --top-k; reported scores are exact, but hits outside the "
        "candidate set are missed)",
    )
    p.add_argument(
        "--mesh",
        type=int,
        default=1,
        metavar="N",
        help="shard the database over N devices: the first N cards, or N CPU shards with --device cpu",
    )
    p.add_argument(
        "--query-shard",
        action="store_true",
        help="with --mesh N: shard the query's bands across the devices instead (systolic wavefront "
        "pipeline; latency mode for a long query against a small database, which is replicated)",
    )
    p.add_argument(
        "--profile",
        metavar="DIR",
        default=None,
        help="write a torch.profiler Chrome trace of the search to DIR/swtpu_torch_trace.json "
        "(CPU activity, and CUDA activity on a CUDA device; a summary line goes to stderr)",
    )
    p.add_argument("--batch-rows", type=int, default=8192)
    p.add_argument("--length-quantum", type=int, default=128)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    t_start = time.perf_counter()  # the timer spans parsing, like the reference CLI

    from .io.fasta import parse_database, parse_query
    from .models.search import SearchEngine

    if args.evalue and args.top_k is None:
        print("swtpu_torch: error: --evalue requires --top-k", file=sys.stderr)
        return 2
    if args.max_evalue is not None and not args.evalue:
        print("swtpu_torch: error: --max-evalue requires --evalue", file=sys.stderr)
        return 2
    if args.align_top_k is not None and args.align_top_k < 1:
        print("swtpu_torch: error: --align-top-k must be >= 1", file=sys.stderr)
        return 2
    try:
        config = SWConfig(
            gap_penalty=args.gap,
            gap_open=args.gap_open,
            gap_extend=args.gap_extend,
            matrix=args.matrix,
            score_dtype=args.score_dtype,
            batch_rows=args.batch_rows,
            length_quantum=args.length_quantum,
            use_pallas=False if args.no_pallas else (True if args.pallas else None),
            use_wave=args.wave,
            top_k=args.top_k,
            evalue=args.evalue,
            prefilter=args.prefilter,
            mesh_shape=(args.mesh,),
            query_shard=args.query_shard,
        )
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
    if args.profile is None:
        result = engine.search(query, db)
    else:
        from .utils.profiling import trace, trace_summary

        with trace(args.profile, engine.device) as path:
            result = engine.search(query, db)
        summary = trace_summary(path)
        print(f"swtpu_torch: profile: {path}: {summary['events']} events, {summary['device_events']} on the device, "
              f"kernels {sorted(summary['kernel_ms'])}, window {summary['window_ms']:.3f} ms, "
              f"busy share {summary['busy_share']}", file=sys.stderr)
        if engine.device.type == "cuda" and not summary["device_events"]:
            print("swtpu_torch: profile: the trace holds no device events", file=sys.stderr)

    if args.align_top_k is not None:
        from .models.align import align_hits

        for aln in align_hits(query, db, result.top_k(args.align_top_k), config):
            print(aln.pretty())
            print()
    if args.top_k is not None:
        if args.evalue:
            for h in result.top_k_stats(args.top_k):
                if args.max_evalue is not None and h.evalue > args.max_evalue:
                    break  # hits are score-sorted and E(x) is monotone in x
                print(f"{h.id}:{h.score}\tE={h.evalue:.3g}\tbits={h.bits:.1f}")
        else:
            for sid, score in result.top_k(args.top_k):
                print(f"{sid}:{score}")
    elif not args.no_scores and args.align_top_k is None:
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
