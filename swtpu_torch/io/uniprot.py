"""UniProt flat-file (.dat) preprocessing (``swtpu.io.uniprot``).

The reference's offline utility ``src/parse.py``: extract the sequences of a
UniProt flat file (``SQ   SEQUENCE`` blocks, 60-column wrapped, each record
ended by ``//``), sort them by length unless asked not to, and write one
sequence a line (parse.py's output) or FASTA (which the engine's own parse
reads).  Host-only: no torch, no device.

Usage::

    python -m swtpu_torch.io.uniprot src.dat dst [--fasta] [--no-sort]
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import List, Optional, Tuple

from .fasta import write_fasta


def parse_uniprot_dat(path: str | Path) -> List[Tuple[str, str]]:
    """[(accession, sequence)] of a UniProt flat file, in file order: the
    first accession of a record's first AC line, and its SQ block without
    whitespace.  A last record without ``//`` counts if it has residues."""
    out: List[Tuple[str, str]] = []
    acc = ""
    seq_lines: Optional[List[str]] = None
    with open(path, "r", errors="replace") as f:
        for line in f:
            if line.startswith("AC") and not acc:
                acc = line[2:].strip().split(";")[0].strip()
            if line.startswith("SQ   SEQUENCE"):
                seq_lines = []
                continue
            if line.startswith("//"):
                if seq_lines is not None:
                    out.append((acc, "".join(seq_lines)))
                acc, seq_lines = "", None
                continue
            if seq_lines is not None:
                seq_lines.append("".join(line.split()))
    if seq_lines:  # an unterminated last record
        out.append((acc, "".join(seq_lines)))
    return out


def convert_dat(src: str | Path, dst: str | Path, sort_by_length: bool = True, fasta: bool = False) -> int:
    """Write ``src``'s sequences to ``dst`` as plain lines or as FASTA
    (headers: the accession, or ``seq<i>`` without one); returns their
    count.  The sort is stable, so equal lengths keep file order."""
    recs = parse_uniprot_dat(src)
    if sort_by_length:
        recs = sorted(recs, key=lambda r: len(r[1]))
    if fasta:
        write_fasta(dst, [s for _, s in recs], headers=[a or f"seq{i}" for i, (a, _) in enumerate(recs)])
    else:
        with open(dst, "w") as f:
            for _, s in recs:
                f.write(s + "\n")
    return len(recs)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="swtpu_torch.io.uniprot", description="UniProt .dat preprocessor")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--fasta", action="store_true", help="emit FASTA instead of plain lines")
    p.add_argument("--no-sort", action="store_true", help="keep file order (default: sort by length)")
    args = p.parse_args(argv)
    n = convert_dat(args.src, args.dst, sort_by_length=not args.no_sort, fasta=args.fasta)
    print(f"wrote {n} sequences to {args.dst}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
