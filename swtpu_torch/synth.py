"""Seeded synthetic databases for goldens and the on-card check.

Copies of the generators in ``tools/make_goldens.py`` and ``bench.py``: the
same recipes with the same seeds give the same arrays (tests hold them
equal), so the committed goldens score these databases.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .io.fasta import Database


def synth_scale_db(planted: np.ndarray, n: int = 10_000, seed: int = 7) -> List[np.ndarray]:
    """SwissProt-shaped database of the 10k scale golden.

    Lognormal lengths (median ~290) over the 25-letter alphabet, plus one
    subject (id n-1) of 9 tandem copies of ``planted`` (query P02232 in the
    golden).
    """
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.lognormal(mean=5.67, sigma=0.62, size=n - 1), 5, 4000).astype(np.int64)
    seqs = [rng.integers(0, 25, int(l)).astype(np.int8) for l in lengths]
    seqs.append(np.tile(np.asarray(planted, dtype=np.int8), 9))
    return seqs


def synth_sat_case(seed: int = 13) -> Tuple[np.ndarray, List[np.ndarray]]:
    """(query, seqs) of the saturation golden: a 4000-aa query cloned into
    subject 0 and a 350-residue all-W run in subject 1 (scores far above
    any int16 ceiling), then 98 SwissProt-shaped fillers."""
    rng = np.random.default_rng(seed)
    W_IDX = 17  # 'W'
    query = rng.integers(0, 25, 4000).astype(np.int8)
    query[1000:1350] = W_IDX
    seqs = [query.copy(), np.full(350, W_IDX, dtype=np.int8)]
    lengths = np.clip(rng.lognormal(mean=5.67, sigma=0.62, size=98), 5, 2000).astype(np.int64)
    seqs.extend(rng.integers(0, 25, int(l)).astype(np.int8) for l in lengths)
    return query, seqs


def synth_database(n_seqs: int, seed: int = 0) -> Database:
    """SwissProt-shaped random database of bench.py (lognormal lengths,
    median ~290, clipped to [20, 8000]).  At the reference's 559,228
    sequences and seed 0: 196,472,195 residues, longest 5,452."""
    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.lognormal(mean=5.67, sigma=0.62, size=n_seqs), 20, 8000).astype(np.int64)
    offsets = np.zeros(n_seqs + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    residues = rng.integers(0, 25, size=int(offsets[-1]), dtype=np.int8)
    return Database(residues=residues, offsets=offsets)


def database_from_arrays(seqs: List[np.ndarray]) -> Database:
    """A Database over already-encoded int8 sequences."""
    lengths = np.fromiter((len(s) for s in seqs), count=len(seqs), dtype=np.int64)
    offsets = np.zeros(len(seqs) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    residues = np.concatenate(seqs).astype(np.int8) if seqs else np.zeros(0, np.int8)
    return Database(residues=residues, offsets=offsets)
