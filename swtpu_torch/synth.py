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


# W-run lengths whose copies score 15 a residue (BLOSUM50's W/W) against a
# longer W run: 32,640 (the int16x2 kernel's flag threshold, unflagged),
# 32,655 (just over), 32,760 and 32,775 (either side of int16's 32,767) and
# 33,000.
SAT_RUNS = (2176, 2177, 2184, 2185, 2200)


def saturating_bucket(seed: int, n_segs: int = 1, lanes: int = 8, n_queries: int = 1, tail: int = 200):
    """(profiles, bucket) for the int16x2 kernel's saturation checks.

    Query 0 is a run of 2,200 W followed by ``tail`` random residues; the
    others (a (n_queries, qpad, 32) stack when n_queries > 1, else one
    (qpad, 32) profile) are random of the same length, and the last of them
    carries the W run at its end instead.  The (n_segs * seg_cols + 32,
    lanes) int8 bucket chains ``n_segs`` subjects a lane (seg_cols 2,240):
    the copies of ``SAT_RUNS``, a random prefix before a 2,177-residue W
    run, random subjects of any length up to seg_cols and a few empty
    slots, shuffled so that a saturating segment sits beside normal ones.
    Under BLOSUM50 (``matrices.blosum50_ref``) and any gaps, query 0 scores
    each W-run copy at 15 a residue.
    """
    from .alphabet import PADDED_ALPHABET_SIZE
    from .matrices import blosum50_ref
    from .ops.profile import PAD_SUBJECT, make_profile

    rng = np.random.default_rng(seed)
    w_idx, run = 17, 2200
    qlen = run + tail
    queries = [np.concatenate([np.full(run, w_idx), rng.integers(0, 25, tail)]).astype(np.int8)]
    for k in range(1, n_queries):
        q = rng.integers(0, 25, qlen).astype(np.int8)
        if k == n_queries - 1:
            q[tail:] = w_idx
        queries.append(q)
    matrix = blosum50_ref()
    profiles = np.stack([make_profile(q, matrix, pad_rows_to=32) for q in queries])
    assert profiles.shape[-1] == PADDED_ALPHABET_SIZE
    seg_cols = 2240
    n_slots = lanes * n_segs
    subjects = [np.full(k, w_idx, dtype=np.int8) for k in SAT_RUNS]
    subjects.append(np.concatenate([rng.integers(0, 25, 40), np.full(2177, w_idx)]).astype(np.int8))
    while len(subjects) < n_slots - 2:
        subjects.append(rng.integers(0, 25, int(rng.integers(1, seg_cols + 1))).astype(np.int8))
    subjects = subjects[: max(n_slots - 2, 0)] + [np.zeros(0, np.int8)] * (n_slots - max(n_slots - 2, 0))
    order = rng.permutation(n_slots)
    bucket = np.full((n_segs * seg_cols + 32, lanes), PAD_SUBJECT, dtype=np.int8)
    for slot, k in enumerate(order):
        s = subjects[k]
        lane, seg = divmod(slot, n_segs)
        bucket[seg * seg_cols : seg * seg_cols + len(s), lane] = s
    return (profiles if n_queries > 1 else profiles[0]), bucket
