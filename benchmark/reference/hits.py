"""Hit order and E-values, frozen as the configurations state them.

* Hits: the ``k`` best (id, score) pairs, score descending, then id
  ascending.
* E-values: the empirical Gumbel null of FASTA/SSEARCH fitted to the
  query's own nonzero scores over the database, with the top ``trim``
  (0.02) fraction censored and the moment estimators corrected for it, the
  location regressed on ln(subject length) over 12 equal-count length bins
  when at least two bins hold 64 usable scores, and E(x) = sum over bins of
  N_b * P(S >= x | mu_b); else the pooled fit, E(x) = n * P(S >= x).  Bits:
  (lambda * S - ln K) / ln 2, K = exp(lambda * mu) / (m * mean subject
  length).

A sampled null (the prefilter's calibration sample) takes the sample's
scores and the whole database's lengths: the bins, their subject counts
and the pooled count are the database's, the score moments the sample's.

Every float is of ``dtype``: float64 is the stated arithmetic, float32 the
control of a lower precision.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

TRIM = 0.02
NBINS = 12
MIN_BIN = 64


def top_hits(scores: np.ndarray, k: int) -> List[Tuple[int, int]]:
    """The ``k`` best (id, score) of a file-order score array."""
    scores = np.asarray(scores)
    order = np.lexsort((np.arange(scores.size), -scores.astype(np.int64)))[:k]
    return [(int(i), int(scores[i])) for i in order]


def _trunc(p: float, ft):
    """(mean, variance) of a standard Gumbel conditioned below its (1 - p)
    quantile, by piecewise Gauss-Legendre in t = ln u."""
    if p <= 0.0:
        return ft(np.euler_gamma), ft(np.pi**2 / 6.0)
    x, w = np.polynomial.legendre.leggauss(80)
    x, w = x.astype(ft), w.astype(ft)
    q = ft(1.0) - ft(p)
    lo = np.log(-np.log(q))
    edges = np.linspace(lo, ft(5.0), 9, dtype=ft)
    i1 = i2 = ft(0.0)
    for a, b in zip(edges[:-1], edges[1:]):
        t = ft(0.5) * (b - a) * x + ft(0.5) * (a + b)
        ww = ft(0.5) * (b - a) * w
        f = np.exp(t - np.exp(t))
        i1 = ft(i1 + (ww * t * f).sum(dtype=ft))
        i2 = ft(i2 + (ww * t * t * f).sum(dtype=ft))
    m1 = -i1 / q
    return ft(m1), ft(i2 / q - m1 * m1)


def _bin_edges(lengths: np.ndarray, ft) -> np.ndarray:
    pos = lengths[lengths > 0]
    if pos.size == 0:
        return np.array([1], dtype=np.int64)
    qs = np.quantile(pos.astype(ft), np.linspace(0.0, 1.0, NBINS + 1)[1:].astype(ft))
    return np.unique(np.ceil(qs).astype(np.int64))


def _bin_ids(lengths: np.ndarray, edges: np.ndarray) -> np.ndarray:
    ids = np.searchsorted(edges, lengths, side="left").astype(np.int64)
    ids[lengths <= 0] = len(edges)
    return np.minimum(ids, len(edges))


def evalues(
    scores: np.ndarray, lengths: np.ndarray, query_length: int, hits: List[Tuple[int, int]], dtype=np.float64,
    population: Optional[np.ndarray] = None,
) -> List[Tuple[float, float]]:
    """(E-value, bits) of each hit under the null fitted to ``scores``
    (file order, every subject of the database; ``lengths`` theirs).

    A sampled null: ``scores`` and ``lengths`` cover a sample of the
    database and ``population`` holds every subject's length.  The bins'
    edges, subject counts and mean ln(length), the mean subject length and
    the pooled count are then the population's; the score moments stay the
    sample's."""
    ft = np.dtype(dtype).type
    scores = np.asarray(scores)
    lengths = np.asarray(lengths, dtype=np.int64)
    pop = lengths if population is None else np.asarray(population, dtype=np.int64)
    nz = scores > 0
    body = scores[nz].astype(ft)
    count = int(body.size)
    if count < 16:
        raise ValueError(f"need >= 16 nonzero scores to fit the null (got {count})")
    cut = min(int(np.ceil(TRIM * count)), count - 16)
    # the top `cut` scores, (score desc, position asc)
    pos = np.lexsort((np.arange(count), -scores[nz].astype(np.int64)))[:cut]
    top = body[pos]
    s = ft(body.sum(dtype=ft) - top.sum(dtype=ft))
    qq = ft((body * body).sum(dtype=ft) - (top * top).sum(dtype=ft))
    n_body = ft(count - cut)
    mean = s / n_body
    var = qq / n_body - mean * mean
    m1, v = _trunc(cut / count, ft)
    beta = ft(np.sqrt(var / v))
    lam, mu = ft(1.0) / beta, ft(mean - beta * m1)

    edges = _bin_edges(pop, ft)
    nb = len(edges)
    ids = _bin_ids(lengths, edges)
    ids_nz = ids[nz]
    ok = ids_nz < nb
    counts = np.bincount(ids_nz[ok], minlength=nb)[:nb].astype(ft)
    sums = np.bincount(ids_nz[ok], weights=body[ok], minlength=nb)[:nb].astype(ft)
    sumsqs = np.bincount(ids_nz[ok], weights=body[ok] * body[ok], minlength=nb)[:nb].astype(ft)
    tb = ids_nz[pos]
    tok = tb < nb
    cut_counts = np.bincount(tb[tok], minlength=nb)[:nb].astype(ft)
    cut_sums = np.bincount(tb[tok], weights=top[tok], minlength=nb)[:nb].astype(ft)
    cut_sumsqs = np.bincount(tb[tok], weights=top[tok] * top[tok], minlength=nb)[:nb].astype(ft)
    pids = _bin_ids(pop, edges)
    okl = pids < nb
    n_subj = np.bincount(pids[okl], minlength=nb)[:nb].astype(ft)
    logsum = np.bincount(pids[okl], weights=np.log(np.maximum(pop[okl], 1)).astype(ft), minlength=nb)[:nb]
    log_len = (logsum / np.maximum(n_subj, 1)).astype(ft)

    lfit = None
    n_b = counts - cut_counts
    usable = n_b >= MIN_BIN
    if int(usable.sum()) >= 2:
        nbu = n_b[usable]
        mean_b = (sums[usable] - cut_sums[usable]) / nbu
        var_b = (sumsqs[usable] - cut_sumsqs[usable]) / nbu - mean_b * mean_b
        x = log_len[usable]
        if not (var_b <= 0).any() and float(np.ptp(x)) >= 1e-6:
            p_b = cut_counts[usable] / counts[usable]
            co = [_trunc(float(p), ft) for p in p_b]
            m1_b = np.array([c[0] for c in co], dtype=ft)
            v_b = np.array([c[1] for c in co], dtype=ft)
            beta_p = ft((nbu * np.sqrt(var_b / v_b)).sum(dtype=ft) / nbu.sum(dtype=ft))
            mu_b = mean_b - beta_p * m1_b
            xm = (nbu * x).sum(dtype=ft) / nbu.sum(dtype=ft)
            ym = (nbu * mu_b).sum(dtype=ft) / nbu.sum(dtype=ft)
            b = ft((nbu * (x - xm) * (mu_b - ym)).sum(dtype=ft) / (nbu * (x - xm) ** 2).sum(dtype=ft))
            lfit = (ft(1.0) / beta_p, ft(ym - b * xm), b)

    mean_len = ft(pop.sum()) / ft(max(pop.size, 1))
    k_const = np.exp(lam * mu) / ft(max(query_length * mean_len, 1.0))
    out = []
    for _, sc in hits:
        x = ft(sc)
        if lfit is not None:
            lam_l, a, b = lfit
            z = np.exp(-lam_l * (x - (a + b * log_len)))
            e = (n_subj * -np.expm1(-z)).sum(dtype=ft)
        else:
            e = ft(pop.size) * -np.expm1(-np.exp(-lam * (x - mu)))
        bits = (lam * x - np.log(max(k_const, ft(1e-300) if ft is np.float64 else ft(1e-38)))) / np.log(ft(2.0))
        out.append((float(e), float(bits)))
    return out
