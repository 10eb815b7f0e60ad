"""Queries read from the frozen FASTA files under ``data/queries/``:
``{"source": "vendored", "names": [...]}``, in the order given."""

from pathlib import Path

import numpy as np

from reference.scoring import encode
from swbench.spec import BENCH

QUERY_DIR = BENCH / "data" / "queries"


def read_fasta(path: Path) -> np.ndarray:
    """Every residue line of a FASTA file, concatenated and encoded."""
    body = b"".join(ln.strip() for ln in path.read_bytes().splitlines() if not ln.startswith(b">"))
    return encode(body)


def make(group: dict, gen: np.random.Generator):
    return [(name, read_fasta(QUERY_DIR / f"{name}.fasta")) for name in group["names"]]
