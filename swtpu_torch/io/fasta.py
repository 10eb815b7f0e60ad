"""FASTA ingestion (``swtpu.io.fasta``).

* database record ids are 0-based FASTA file order,
* a query is the concatenation of every non-header line of its file,
* unknown residue characters are legal and encode to ``*``.

A parsed database is a flat int8 residue buffer plus offsets: the packers
build buckets from it (swtpu_torch.utils.bucketing).  ``parse_database``
parses and encodes a file in one native pass (swtpu_torch.native, as
swtpu's default parse); ``parse_database_plain`` is its NumPy version, for
the tests and chip_smoke.py.  With ``keep_headers=True`` both also keep each
record's header line, less its trailing ``\r``s, in ``Database.headers``,
and ``take`` and ``shard`` carry them.  Both count records by one rule,
headers or not (C2); swtpu's header-keeping parse drops one record more
than its native parse (D10, ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import functools
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from .. import native
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

    def padded_length(self, quantum: int) -> int:
        return -(-self.length // quantum) * quantum


@dataclasses.dataclass
class Database:
    """A parsed sequence database: flat residues + offsets, file-order ids.

    The arrays are not changed once the database is made: what is derived
    from the offsets (``lengths``, ``largest_length``, each
    ``padded_length_sum``) is computed once an object, since a search of a
    large database would otherwise pay an O(n) pass for each."""

    residues: np.ndarray  # (total,) int8, concatenated encoded sequences
    offsets: np.ndarray  # (n+1,) int64, sequence i = residues[offsets[i]:offsets[i+1]]
    headers: Optional[List[str]] = None  # record i's header line, when kept

    @property
    def n(self) -> int:
        return int(self.offsets.shape[0] - 1)

    @functools.cached_property
    def lengths(self) -> np.ndarray:
        """(n,) int64 record lengths, read-only (shared by every caller)."""
        ln = np.diff(self.offsets).astype(np.int64)
        ln.setflags(write=False)
        return ln

    @property
    def length_sum(self) -> int:
        return int(self.offsets[-1])

    @functools.cached_property
    def largest_length(self) -> int:
        return int(self.lengths.max()) if self.n else 0

    @functools.cached_property
    def _padded_sums(self) -> dict:
        return {}

    def padded_length_sum(self, quantum: int = 8) -> int:
        """Sum of lengths rounded up to `quantum` (the reference program's
        ``subjectLengthSum``, which counts its pad-to-8 residues)."""
        sums = self._padded_sums
        if quantum not in sums:
            sums[quantum] = int((-(-self.lengths // quantum) * quantum).sum())
        return sums[quantum]

    def sequence(self, i: int) -> np.ndarray:
        return self.residues[int(self.offsets[i]) : int(self.offsets[i + 1])]

    def sequences(self) -> List[np.ndarray]:
        return [self.sequence(i) for i in range(self.n)]

    def take(self, ids: np.ndarray) -> "Database":
        """Gather the given record ids (ascending or not) into a compact
        database; record i of the result is ``ids[i]`` of this one (the
        prefilter hands its candidate set to the exact engine this way)."""
        ids = np.asarray(ids, dtype=np.int64)
        lens = self.lengths[ids]
        off = np.zeros(ids.shape[0] + 1, dtype=np.int64)
        np.cumsum(lens, out=off[1:])
        # Each output position's source: its record's start plus its place in the record.
        src = np.repeat(self.offsets[ids] - off[:-1], lens) + np.arange(int(off[-1]), dtype=np.int64)
        hdr = None if self.headers is None else [self.headers[int(i)] for i in ids]
        return Database(residues=self.residues[src], offsets=off, headers=hdr)

    def shard(self, index: int, count: int) -> "Database":
        """Contiguous shard ``index`` of ``count`` (:func:`shard_range`);
        record i of the shard is record ``lo + i`` of this database."""
        lo, hi = shard_range(self.n, index, count)
        off = self.offsets[lo : hi + 1]
        hdr = None if self.headers is None else self.headers[lo:hi]
        return Database(residues=self.residues[int(off[0]) : int(off[-1])], offsets=(off - off[0]).copy(), headers=hdr)


def shard_range(n: int, index: int, count: int) -> Tuple[int, int]:
    """Even contiguous [lo, hi) split of n items into ``count`` shards."""
    base, rem = divmod(n, count)
    lo = index * base + min(index, rem)
    return lo, lo + base + (1 if index < rem else 0)


def _split_records(data: bytes) -> List[Tuple[bytes, bytes]]:
    """Split FASTA bytes into (header line as read, sequence bytes without
    whitespace)."""
    first = data.find(b">")
    if first < 0:
        # Headerless file: the whole file is one sequence.
        body = data.translate(None, _WHITESPACE)
        return [(b"", body)] if body else []
    records: List[Tuple[bytes, bytes]] = []
    for chunk in data[first + 1 :].split(b"\n>"):
        header, _, body = chunk.partition(b"\n")
        records.append((header, body.translate(None, _WHITESPACE)))
    return records


def parse_query(path: str | Path) -> Query:
    """Parse a query FASTA: every record's residues, concatenated."""
    recs = _split_records(Path(path).read_bytes())
    if not recs:
        raise ValueError(f"no sequence found in query file {path}")
    raw = b"".join(body for _, body in recs)
    return Query(
        name=recs[0][0].rstrip(b"\r").decode("utf-8", errors="replace"),
        residues=encode_bytes(raw),
        raw=raw.decode("ascii", errors="replace"),
    )


def _records(data: bytes) -> List[Tuple[bytes, bytes]]:
    """The database records of FASTA bytes: one is dropped only when its
    header, less one trailing ``\r``, and its body are both empty (so a
    header line of ``\r\r`` keeps its record)."""
    return [(h, b) for h, b in _split_records(data) if b or h.removesuffix(b"\r")]


def _headers(recs: List[Tuple[bytes, bytes]]) -> List[str]:
    return [h.rstrip(b"\r").decode("utf-8", errors="replace") for h, _ in recs]


def parse_database(path: str | Path, keep_headers: bool = False) -> Database:
    """Parse a multi-record FASTA database: one native parse-and-encode pass
    over the file's bytes (record rules in ``csrc/sw_native.cpp``); with
    ``keep_headers``, also the records' header lines, by the same rule."""
    data = Path(path).read_bytes()
    residues, offsets = native.parse_fasta_bytes(data)
    headers = None
    if keep_headers:
        headers = _headers(_records(data))
        if len(headers) != offsets.shape[0] - 1:
            raise RuntimeError(f"{path}: {len(headers)} headers for {offsets.shape[0] - 1} native records")
    return Database(residues=residues, offsets=offsets, headers=headers)


def parse_database_plain(path: str | Path, keep_headers: bool = False) -> Database:
    """NumPy version of :func:`parse_database`, with the same records
    (:func:`_records`)."""
    recs = _records(Path(path).read_bytes())
    lengths = np.fromiter((len(b) for _, b in recs), count=len(recs), dtype=np.int64)
    offsets = np.zeros(len(recs) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    headers = _headers(recs) if keep_headers else None
    return Database(residues=encode_bytes(b"".join(b for _, b in recs)), offsets=offsets, headers=headers)


def database_from_sequences(seqs: List[str | bytes], headers: Optional[List[str]] = None) -> Database:
    """Build a Database directly from in-memory sequences (tests, goldens)."""
    bs = [s.encode("ascii") if isinstance(s, str) else bytes(s) for s in seqs]
    lengths = np.fromiter((len(b) for b in bs), count=len(bs), dtype=np.int64)
    offsets = np.zeros(len(bs) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    return Database(residues=encode_bytes(b"".join(bs)), offsets=offsets, headers=headers)


def write_fasta(path: str | Path, seqs: List[str], headers: Optional[List[str]] = None, width: int = 60) -> None:
    """Write sequences as FASTA, ``width`` residues a line; headers default
    to ``seq<i>`` (test fixtures, chip_smoke.py's SwissProt-sized file)."""
    with open(path, "w") as f:
        for i, s in enumerate(seqs):
            h = headers[i] if headers else f"seq{i}"
            f.write(f">{h}\n")
            for k in range(0, len(s), width):
                f.write(s[k : k + width] + "\n")
