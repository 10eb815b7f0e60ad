"""The k-mer prefilter's heuristic, worked out again: which subjects a
prefiltered search scores exactly, its hits, and their E-values from a
sampled null.

A prefiltered search does not answer the exhaustive question: it returns
the best hits among its candidates, with E-values from a fixed calibration
sample.  This module states that answer plainly, as the configurations
state the heuristic, so that a check can hold the program to it exactly.

* Signatures: each sequence's 3-mers hashed into DIM = 1,024 buckets,
  ``h = ((a >> 20) ^ a) & 1023`` with ``a = r0 * MIX[0] + r1 * MIX[1] +
  r2 * MIX[2]`` modulo 2**32; a signature marks each bucket present.
  A k-mer never spans two sequences.
* Coarse counts: the buckets a query and a subject share, a plain product
  of 0/1 rows in float64 (exact), a block of subjects at a time.
* Ranking: the z-score ``(c - E) * rsqrt(max(E, 1))``, ``E = qk * pop /
  DIM`` (``qk``, ``pop``: the query's and the subject's popcounts), in
  float32 and in these steps; and the raw count.  The ``n_cand`` best ids
  of each signal, value descending and ties to the lower id, merge round
  robin (an id already taken is skipped) until ``n_cand`` are taken.
* ``n_cand``: ``ceil(fraction * n)``, at least ``min(min_candidates, n)``
  and ``4 * top_k``, at most ``n``.  A query with no k-mer, an empty
  database, or no shared bucket anywhere has no signal: every subject is a
  candidate.
* With E-values the calibration sample (2,048 ids, ``default_rng(0)``, or
  every id of a smaller database) joins the candidates.
* Every candidate is scored exactly (``reference.sw``); the hits are the
  ``top_k`` best (score desc, id asc), and their E-values and bits come
  from the null fitted to the sample's scores, extrapolated to the whole
  database's lengths (``reference.hits.evalues`` with ``population``).

``precision="int16"`` and ``dtype=np.float32`` make the control of a lower
precision: saturating exact scores and float32 E-value arithmetic, on the
same candidates.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import hits as ref_hits
from . import sw

DIM = 1024
K = 3
MIX = (2654435761, 2246822519, 3266489917)
SAMPLE = 2048
SAMPLE_SEED = 0
SUBJECTS_A_BLOCK = 1 << 15
TILE_RATIO = 3.0  # few, wide tiles: a query's ~2,000 candidates are few cells, and launches bound the plain DP


def n_candidates(n: int, fraction: float, min_candidates: int, top_k: int) -> int:
    if n == 0:
        return 0
    return min(max(math.ceil(fraction * n), min(min_candidates, n), 4 * top_k), n)


def calibration_sample(n: int) -> np.ndarray:
    return np.sort(np.random.default_rng(SAMPLE_SEED).choice(n, min(SAMPLE, n), replace=False)).astype(np.int64)


def _buckets(res: torch.Tensor) -> torch.Tensor:
    """The bucket of every k-mer window of a residue run (int64 tensor)."""
    acc = sum(res[j : res.numel() - K + 1 + j] * MIX[j] for j in range(K)) & 0xFFFFFFFF
    return ((acc >> 20) ^ acc) & (DIM - 1)


def query_signature(query: np.ndarray) -> np.ndarray:
    """(DIM,) 0/1 float64 signature of one query."""
    sig = np.zeros(DIM)
    if len(query) >= K:
        sig[_buckets(torch.from_numpy(np.asarray(query, dtype=np.int64))).numpy()] = 1.0
    return sig


def coarse_counts(qsigs: np.ndarray, residues: torch.Tensor, offsets: np.ndarray, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """((Q, n) int32 shared-bucket counts, (n,) int32 subject popcounts) on
    ``device``, the subjects' signatures built there a block at a time and
    dropped after their product."""
    n = offsets.size - 1
    q = torch.from_numpy(qsigs).to(device=device, dtype=torch.float64)
    counts = torch.zeros(q.shape[0], n, dtype=torch.int32, device=device)
    pop = torch.zeros(n, dtype=torch.int32, device=device)
    res = residues.to(device)
    for a in range(0, n, SUBJECTS_A_BLOCK):
        b = min(a + SUBJECTS_A_BLOCK, n)
        lo, hi = int(offsets[a]), int(offsets[b])
        if hi - lo < K:
            continue
        lens = torch.from_numpy(np.diff(offsets[a : b + 1])).to(device)
        rec = torch.repeat_interleave(torch.arange(b - a, device=device), lens)
        whole = rec[: hi - lo - K + 1] == rec[K - 1 :]  # the window lies in one sequence
        h = _buckets(res[lo:hi].to(torch.int64))
        sig = torch.zeros((b - a) * DIM, dtype=torch.float64, device=device)
        sig[(rec[: hi - lo - K + 1] * DIM + h)[whole]] = 1.0
        sig = sig.view(b - a, DIM)
        pop[a:b] = sig.sum(dim=1).to(torch.int32)
        counts[:, a:b] = (q @ sig.T).to(torch.int32)
    return counts, pop


def zscores(counts: torch.Tensor, pop: torch.Tensor, qk: float) -> torch.Tensor:
    """(n,) float32 z-scores of one query's counts (``qk``: its popcount)."""
    qk = torch.tensor([[qk]], dtype=torch.float32, device=counts.device)
    e = qk * pop.to(torch.float32)[None, :] / DIM
    return ((counts.to(torch.float32)[None, :] - e) * torch.rsqrt(torch.clamp_min(e, 1.0)))[0]


def best_ids(x: torch.Tensor, m: int) -> np.ndarray:
    """The ``m`` largest entries' ids, value descending, ties to the lower
    id: all above the m-th largest value, then the lowest ids equal to it."""
    v = torch.topk(x, m).values[-1]
    above = torch.nonzero(x > v).flatten()
    tied = torch.nonzero(x == v).flatten()[: m - above.numel()]
    ids = torch.cat([above, tied]).cpu().numpy()
    vals = x[torch.from_numpy(ids).to(x.device)].cpu().numpy()
    return ids[np.lexsort((ids, -vals.astype(np.float64)))]


def merge(lists: Sequence[np.ndarray], m: int) -> np.ndarray:
    """Round robin over ``lists``, an id taken once, until ``m``; ascending."""
    out: List[int] = []
    seen = set()
    for i in range(m):
        for ids in lists:
            v = int(ids[i])
            if v not in seen:
                seen.add(v)
                out.append(v)
                if len(out) == m:
                    return np.sort(np.array(out, dtype=np.int64))
    return np.sort(np.array(out, dtype=np.int64))


def candidates(queries: Sequence[np.ndarray], residues: torch.Tensor, offsets: np.ndarray, n_cand: int,
               with_sample: bool, device) -> List[np.ndarray]:
    """Each query's ascending candidate ids."""
    n = offsets.size - 1
    qsigs = np.stack([query_signature(q) for q in queries]) if len(queries) else np.zeros((0, DIM))
    counts, pop = coarse_counts(qsigs, residues, offsets, device) if n else (None, None)
    out = []
    for i, qsig in enumerate(qsigs):
        cand = np.arange(n, dtype=np.int64)
        if n and qsig.any() and int(counts[i].max()) != 0:
            z = zscores(counts[i], pop, float(qsig.sum()))
            cand = merge([best_ids(z, n_cand), best_ids(counts[i], n_cand)], n_cand)
        out.append(np.union1d(cand, calibration_sample(n)) if with_sample else cand)
    return out


def answers(queries: Sequence[np.ndarray], cands: Sequence[np.ndarray], residues: torch.Tensor, offsets: np.ndarray,
            matrix: np.ndarray, gaps: dict, top_k: int, with_evalue: bool, device, precision: str = "int32",
            dtype=np.float64) -> List[List[Tuple[int, int, Optional[float], Optional[float]]]]:
    """Each prefiltered search's hits, [(id, score, E-value, bits)], from
    the exact scores of its candidates ``cands[g]`` (E-value and bits None
    without E-values)."""
    scored = sw.best_scores_many(list(queries), list(cands), residues, offsets, matrix, gaps, device, precision,
                                 TILE_RATIO)
    lengths = np.diff(offsets)
    sample = calibration_sample(offsets.size - 1)
    out = []
    for query, cand, scores in zip(queries, cands, scored):
        order = np.lexsort((cand, -scores))[: min(top_k, cand.size)]
        top = [(int(cand[j]), int(scores[j])) for j in order]
        if not with_evalue:
            out.append([(i, s, None, None) for i, s in top])
            continue
        at = np.searchsorted(cand, sample)
        ev = ref_hits.evalues(scores[at], lengths[sample], len(query), top, dtype, population=lengths)
        out.append([(i, s, e, b) for (i, s), (e, b) in zip(top, ev)])
    return out
