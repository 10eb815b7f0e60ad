"""Resumable sharding manifest for multi-host database search.

The reference is a single-shot batch program with no checkpoint/resume
(SURVEY.md §5).  For pod-scale runs over very large databases, this module
records which contiguous shard of which database each process owns — and
which queries have already completed — so an interrupted fleet can resume
without rescoring finished work.

A manifest is one JSON file (written atomically) that every host can read:

```json
{
  "database": "/data/uniprot_sprot.fasta",
  "n_sequences": 559228,
  "num_shards": 8,
  "shards": [{"index": 0, "lo": 0, "hi": 69904}, ...],
  "completed_queries": ["P01008", "P02232"]
}
```
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from pathlib import Path
from typing import List

from .fasta import shard_range


@dataclasses.dataclass
class ShardManifest:
    database: str
    n_sequences: int
    num_shards: int
    shards: List[dict]
    completed_queries: List[str]

    @classmethod
    def create(cls, database: str | Path, n_sequences: int, num_shards: int) -> "ShardManifest":
        shards = []
        for i in range(num_shards):
            lo, hi = shard_range(n_sequences, i, num_shards)
            shards.append({"index": i, "lo": lo, "hi": hi})
        return cls(
            database=str(database),
            n_sequences=n_sequences,
            num_shards=num_shards,
            shards=shards,
            completed_queries=[],
        )

    def shard_bounds(self, index: int) -> tuple:
        s = self.shards[index]
        return s["lo"], s["hi"]

    def mark_completed(self, query_name: str) -> None:
        if query_name not in self.completed_queries:
            self.completed_queries.append(query_name)

    def is_completed(self, query_name: str) -> bool:
        return query_name in self.completed_queries

    def save(self, path: str | Path) -> None:
        """Atomic write (rename) so concurrent readers never see a torn file."""
        path = Path(path)
        fd, tmp = tempfile.mkstemp(dir=str(path.parent), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(dataclasses.asdict(self), f, indent=1)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    @classmethod
    def load(cls, path: str | Path) -> "ShardManifest":
        with open(path) as f:
            d = json.load(f)
        return cls(**d)

    def validate(self) -> None:
        """Shards must tile [0, n) exactly, in order."""
        pos = 0
        for s in self.shards:
            if s["lo"] != pos or s["hi"] < s["lo"]:
                raise ValueError(f"shard {s['index']} does not tile: {s}")
            pos = s["hi"]
        if pos != self.n_sequences:
            raise ValueError(f"shards cover {pos} of {self.n_sequences} sequences")


def resume_or_create(
    path: str | Path, database: str | Path, n_sequences: int, num_shards: int
) -> ShardManifest:
    """Load a matching manifest or create a fresh one."""
    path = Path(path)
    if path.exists():
        m = ShardManifest.load(path)
        if (
            m.database == str(database)
            and m.n_sequences == n_sequences
            and m.num_shards == num_shards
        ):
            m.validate()
            return m
    m = ShardManifest.create(database, n_sequences, num_shards)
    m.save(path)
    return m
