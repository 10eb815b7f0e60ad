"""Multi-process search launcher: one process of a distributed fleet
(counterpart of ``swtpu.parallel.launch``).

The entry point of :class:`swtpu_torch.parallel.distributed.
DistributedSearchEngine`.  Run the same command in every process, on one
host or several; pass the coordinator, the process count and this
process's id, or start the processes with torchrun, whose variables
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, and
``LOCAL_RANK`` for the card) are read when the flags are absent::

    # process 0                                  # process 1
    python -m swtpu_torch.parallel.launch \\
        --query q.fasta --db db.fasta \\
        --coordinator 10.0.0.1:9911 \\
        --num-processes 2 --process-id 0         ... --process-id 1

    torchrun --nproc-per-node 2 -m swtpu_torch.parallel.launch --query q.fasta --db db.fasta

Every process parses the shared database, takes its contiguous shard,
scores it on its card (``--device cuda``: ``cuda:<LOCAL_RANK or process id
mod the cards>``, so processes on a one-card host share it), and joins the
collective top-K merge over gloo; each prints the same global top-K and its
shard's numbers.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="swtpu_torch.parallel.launch", description="multi-process Smith-Waterman search (one process)"
    )
    p.add_argument("--query", required=True)
    p.add_argument("--db", required=True, help="shared database FASTA (each process takes its shard)")
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--coordinator", default=None, help="host:port of process 0 (default: torchrun's MASTER_ADDR:MASTER_PORT)")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--matrix", default="blosum50_ref")
    p.add_argument("--gap", type=int, default=2)
    p.add_argument("--json", action="store_true", help="emit one JSON line instead of text")
    p.add_argument(
        "--device",
        default="cuda",
        help="torch device of this process (default: cuda, the card of its local rank; 'cpu' runs the plain "
        "PyTorch version)",
    )
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    t0 = time.perf_counter()

    import torch.distributed as dist

    from ..config import SWConfig
    from ..io.fasta import parse_database, parse_query
    from . import distributed as D

    D.initialize(coordinator_address=args.coordinator, num_processes=args.num_processes, process_id=args.process_id)
    try:
        cfg = SWConfig(matrix=args.matrix, gap_penalty=args.gap)
        eng = D.DistributedSearchEngine(cfg, device=args.device)
        t = time.perf_counter()
        db = parse_database(args.db)
        query = parse_query(args.query)
        parse_s = time.perf_counter() - t
        shard, base = eng.shard_of(db)
        t = time.perf_counter()
        resident = eng.pack(shard, args.top_k)
        pack_s = time.perf_counter() - t
        t = time.perf_counter()
        res = eng.search(query, shard, base, top_k=args.top_k)
        search_s = time.perf_counter() - t
        wall = time.perf_counter() - t0
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()

    if args.json:
        print(json.dumps({
            "process": eng.process_id,
            "n_processes": eng.process_count,
            "shard_base": res.shard_base,
            "n_local": int(shard.n),
            "hits": res.hits,
            "wall_seconds": wall,
            "device": str(eng.device),
            "route": "resident" if resident else "streamed",
            "parse_seconds": parse_s,
            "pack_seconds": pack_s,
            "search_seconds": search_s,
            "collective_seconds": res.collective_seconds,
        }))
    else:
        print(f"# process {eng.process_id}/{eng.process_count} shard [{base}, {base + shard.n}) wall {wall:.2f}s")
        for sid, score in res.hits:
            print(f"{sid}:{score}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
