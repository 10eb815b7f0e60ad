"""FASTA ingestion (the NumPy path of ``swtpu.io.fasta``).

* database record ids are 0-based FASTA file order,
* a query is the concatenation of every non-header line of its file,
* unknown residue characters are legal and encode to ``*``.

A parsed database is a flat int8 residue buffer plus offsets: the packer
gathers buckets from it on the device (swtpu_torch.utils.bucketing).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import List, Tuple

import numpy as np

from ..alphabet import encode_bytes

_WHITESPACE = b"\r\n\t "


@dataclasses.dataclass
class Query:
    """A single query sequence."""

    name: str
    residues: np.ndarray  # (L,) int8 encoded
    raw: str

    @property
    def length(self) -> int:
        return int(self.residues.shape[0])


@dataclasses.dataclass
class Database:
    """A parsed sequence database: flat residues + offsets, file-order ids."""

    residues: np.ndarray  # (total,) int8, concatenated encoded sequences
    offsets: np.ndarray  # (n+1,) int64, sequence i = residues[offsets[i]:offsets[i+1]]

    @property
    def n(self) -> int:
        return int(self.offsets.shape[0] - 1)

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int64)

    @property
    def length_sum(self) -> int:
        return int(self.offsets[-1])

    def padded_length_sum(self, quantum: int = 8) -> int:
        """Sum of lengths rounded up to `quantum` (the reference program's
        ``subjectLengthSum``, which counts its pad-to-8 residues)."""
        ln = self.lengths
        return int((-(-ln // quantum) * quantum).sum())

    def sequence(self, i: int) -> np.ndarray:
        return self.residues[int(self.offsets[i]) : int(self.offsets[i + 1])]


def _split_records(data: bytes) -> List[Tuple[bytes, bytes]]:
    """Split FASTA bytes into (header, sequence bytes without whitespace)."""
    first = data.find(b">")
    if first < 0:
        # Headerless file: the whole file is one sequence.
        body = data.translate(None, _WHITESPACE)
        return [(b"", body)] if body else []
    records: List[Tuple[bytes, bytes]] = []
    for chunk in data[first + 1 :].split(b"\n>"):
        header, _, body = chunk.partition(b"\n")
        records.append((header.rstrip(b"\r"), body.translate(None, _WHITESPACE)))
    return records


def parse_query(path: str | Path) -> Query:
    """Parse a query FASTA: every record's residues, concatenated."""
    recs = _split_records(Path(path).read_bytes())
    if not recs:
        raise ValueError(f"no sequence found in query file {path}")
    raw = b"".join(body for _, body in recs)
    return Query(
        name=recs[0][0].decode("utf-8", errors="replace"),
        residues=encode_bytes(raw),
        raw=raw.decode("ascii", errors="replace"),
    )


def parse_database(path: str | Path) -> Database:
    """Parse a multi-record FASTA database."""
    recs = [(h, b) for h, b in _split_records(Path(path).read_bytes()) if h or b]
    lengths = np.fromiter((len(b) for _, b in recs), count=len(recs), dtype=np.int64)
    offsets = np.zeros(len(recs) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return Database(residues=encode_bytes(b"".join(b for _, b in recs)), offsets=offsets)


def database_from_sequences(seqs: List[str | bytes]) -> Database:
    """Build a Database directly from in-memory sequences (tests, goldens)."""
    bs = [s.encode("ascii") if isinstance(s, str) else bytes(s) for s in seqs]
    lengths = np.fromiter((len(b) for b in bs), count=len(bs), dtype=np.int64)
    offsets = np.zeros(len(bs) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return Database(residues=encode_bytes(b"".join(bs)), offsets=offsets)
