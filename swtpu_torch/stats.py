"""Hit-significance statistics: empirical E-values and bit scores.

A copy of ``swtpu.stats`` (NumPy only), so that the port imports nothing of
swtpu; the two are held equal by tests/test_torch_serving.py.  One change:
:func:`null_stats_from_scores` orders equal top scores by position (score
descending, then index ascending) instead of leaving their order to
``np.argpartition``.  Which of several tied scores fall inside the trimmed
top decides the per-length-bin counts of the length-corrected fit, so only
a canonical order lets the engine's device top-K (ordered the same way)
reproduce a full-array fit exactly.

The reference reports raw max scores only (src/main.cpp:58-60); a
production search engine reports SIGNIFICANCE — how surprising a score is
against this database.  Max local-alignment scores of UNRELATED sequence
pairs follow an extreme-value (Gumbel) law (Karlin-Altschul):

    P(S >= x) = 1 - exp(-exp(-lambda * (x - mu)))      per comparison

Published (lambda, K) constants exist only for standard scoring schemes
(e.g. BLOSUM50 + affine 10/2); the reference's linear-gap-2 zeroed-`*`
scheme has none, so the law is FIT empirically to each query's own score
distribution over the database — the same approach as FASTA/SSEARCH's
empirical statistics.

Three design points (rounds 4-5):

* **Censoring-corrected trimmed fit.**  The top ``trim`` fraction (true
  homologs — the very scores being judged) is excluded, and the moment
  estimators are CORRECTED for the known truncation fraction: the body is
  a Gumbel right-censored at its (1-trim) quantile, whose conditional
  mean/variance differ from the full law's (an uncorrected fit at
  trim=0.02 overestimates lambda ~14%, making E-values anticonservative
  by orders of magnitude in the far tail — round-4 advisor finding).

* **Sufficient statistics.**  The estimator is a pure function of
  (nonzero count, sum, sum-of-squares, the top scores) — so a device-side
  3-scalar reduction plus the already-transferred top-K candidate values
  feed the exact same fit in the serving modes that never materialise the
  full score array (device top-K, batched, prefilter).
  :func:`fit_gumbel` on a full array and :func:`fit_gumbel_stats` on its
  moments are bit-identical by construction.

* **Length-corrected E-values.**  Longer subjects reach higher chance
  scores (location grows ~ln(subject length)); a single pooled fit on a
  length-skewed database mis-calibrates both tails.  With per-length-bin
  (count, sum) reductions the fitted location is regressed against
  ln(length) (FASTA/SSEARCH's correction) and the E-value sums the
  per-bin expectations: E(x) = sum_b N_b * P(S >= x | mu_b).

The E-value of a hit is the expected number of database sequences
reaching its score by chance: E(x) = n * P(S >= x).  The bit score
normalises a raw score across scoring systems: S' = (lambda*S - ln K) /
ln 2, with K recovered from the fitted location via mu = ln(K*m*n̄) /
lambda (m = query length, n̄ = mean subject length).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_TRIM = 0.02


@dataclass(frozen=True)
class GumbelFit:
    """Empirical null law: P(S >= x) = 1 - exp(-exp(-lam*(x - mu)))."""

    lam: float  # scale (Karlin-Altschul lambda analogue)
    mu: float  # location; absorbs ln(K*m*n̄)/lam
    n_fit: int  # scores the fit used (after masking + trimming)

    def sf(self, x) -> np.ndarray:
        """Per-comparison survival P(S >= x)."""
        z = np.exp(-self.lam * (np.asarray(x, np.float64) - self.mu))
        return -np.expm1(-z)

    def k_constant(self, query_length: int, mean_subject_length: float) -> float:
        """Karlin-Altschul K recovered from mu = ln(K*m*n̄)/lam."""
        mn = max(query_length * mean_subject_length, 1.0)
        return float(np.exp(self.lam * self.mu) / mn)


# --- truncated-Gumbel moment coefficients -----------------------------------

_GL_X, _GL_W = np.polynomial.legendre.leggauss(80)


def _trunc_coeffs(p: float) -> Tuple[float, float]:
    """(conditional mean, conditional variance) of a STANDARD Gumbel given
    it lies below its (1-p) quantile.

    With u = e^{-z} (so z = -ln u) the truncated moments are
    I_k = ∫_{ln u_q}^{∞} t^k e^{t - e^t} dt with u_q = -ln(1-p) — a smooth
    double-exponentially decaying integrand, evaluated by piecewise
    Gauss-Legendre to ~1e-12.  p=0 recovers the closed forms
    (Euler-Mascheroni, pi^2/6) exactly.
    """
    if p <= 0.0:
        return float(np.euler_gamma), float(np.pi**2 / 6.0)
    if p >= 1.0:
        raise ValueError("trim fraction must be < 1")
    q = 1.0 - p
    lo = float(np.log(-np.log(q)))  # ln(u_q): lower limit in t-space
    edges = np.linspace(lo, 5.0, 9)
    i1 = i2 = 0.0
    for a, b in zip(edges[:-1], edges[1:]):
        t = 0.5 * (b - a) * _GL_X + 0.5 * (a + b)
        w = 0.5 * (b - a) * _GL_W
        f = np.exp(t - np.exp(t))
        i1 += float((w * t * f).sum())
        i2 += float((w * t * t * f).sum())
    m1 = -i1 / q  # z = -t
    m2 = i2 / q
    return m1, m2 - m1 * m1


def _censored_fit(n_body: int, mean_body: float, var_body: float, p: float) -> GumbelFit:
    """Gumbel parameters from the mean/variance of a sample right-censored
    at its (1-p) quantile (p = the trimmed-away fraction)."""
    if n_body < 16:
        raise ValueError(
            f"need >= 16 nonzero scores to fit the null distribution "
            f"(got {n_body}); E-values are meaningless on tiny databases"
        )
    if var_body <= 0.0:
        raise ValueError("degenerate score distribution (zero variance)")
    m1, v = _trunc_coeffs(p)
    beta = float(np.sqrt(var_body / v))
    return GumbelFit(lam=1.0 / beta, mu=float(mean_body - beta * m1), n_fit=int(n_body))


# --- fits from sufficient statistics / full arrays --------------------------


def fit_gumbel_stats(
    count: int,
    total: float,
    total_sq: float,
    top_vals: np.ndarray,
    trim: float = DEFAULT_TRIM,
) -> GumbelFit:
    """Censoring-corrected Gumbel fit from sufficient statistics.

    ``count``/``total``/``total_sq`` are over ALL nonzero scores;
    ``top_vals`` holds the largest nonzero scores in DESCENDING order.
    The top ``ceil(trim*count)`` scores are removed (bounded by how many
    top values are available — the effective censoring fraction is
    whatever was actually removed, and the moment estimators are
    corrected for exactly that fraction, so a shorter top list shrinks
    the homolog-exclusion margin but never biases the fit).
    """
    count = int(count)
    if count < 16:
        raise ValueError(
            f"need >= 16 nonzero scores to fit the null distribution "
            f"(got {count}); E-values are meaningless on tiny databases"
        )
    top = np.asarray(top_vals, np.float64).reshape(-1)
    cut = int(np.ceil(trim * count)) if trim > 0 else 0
    cut = min(cut, top.size, count - 16)
    cut = max(cut, 0)
    tv = top[:cut]
    n_body = count - cut
    s = float(total) - float(tv.sum())
    qq = float(total_sq) - float((tv * tv).sum())
    mean = s / n_body
    var = qq / n_body - mean * mean
    return _censored_fit(n_body, mean, var, cut / count)


def fit_gumbel(scores: np.ndarray, trim: float = DEFAULT_TRIM) -> GumbelFit:
    """Censoring-corrected trimmed Gumbel fit of a full score array.

    Zeros are excluded (pad/empty records — and a score of 0 carries no
    rank information under local alignment), then the top ``trim``
    fraction is dropped with truncation-corrected moment estimators
    (see module docstring).  Computes the sufficient statistics and
    delegates to :func:`fit_gumbel_stats`, so an array fit and a
    moments fit of the same data are bit-identical.
    """
    s = np.asarray(scores, np.float64).reshape(-1)
    s = s[s > 0]
    cut = int(np.ceil(trim * s.size)) if (trim > 0 and s.size) else 0
    if cut:
        top = -np.sort(np.partition(-s, cut - 1)[:cut])  # descending
    else:
        top = np.empty(0, np.float64)
    return fit_gumbel_stats(s.size, s.sum(), (s * s).sum(), top, trim=trim)


# --- length-corrected law ----------------------------------------------------


def length_bin_edges(lengths: np.ndarray, nbins: int = 12) -> np.ndarray:
    """Right-inclusive bin edges over subject lengths, ~equal-count
    (quantile) in ln-length; duplicates collapse on small/uniform
    databases.  Bin of L = searchsorted(edges, L, 'left'); the last edge
    is the max length so every positive length lands in [0, len(edges))."""
    pos = np.asarray(lengths)
    pos = pos[pos > 0]
    if pos.size == 0:
        return np.array([1], dtype=np.int64)
    qs = np.quantile(pos, np.linspace(0.0, 1.0, nbins + 1)[1:])
    return np.unique(np.ceil(qs).astype(np.int64))


def length_bin_ids(lengths: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Bin index per subject (len(edges) for zero-length records — an
    overflow bin the reductions ignore)."""
    lengths = np.asarray(lengths)
    ids = np.searchsorted(edges, lengths, side="left").astype(np.int32)
    ids[lengths <= 0] = len(edges)
    return np.minimum(ids, len(edges))


@dataclass(frozen=True)
class LengthFit:
    """Pooled-scale Gumbel with location regressed on ln(subject length):
    mu(L) = a + b*ln(L) (FASTA/SSEARCH-style correction)."""

    lam: float
    a: float
    b: float
    bin_n_subjects: np.ndarray  # ALL subjects per bin (zero scorers included)
    bin_log_len: np.ndarray  # mean ln(length) per bin
    n_bins_fit: int

    def expected_hits(self, x) -> np.ndarray:
        """E(x) = sum_b N_b * P(S >= x | mu(L_b)) — the length-corrected
        E-value (already summed over the database; no extra n factor)."""
        mu_b = self.a + self.b * self.bin_log_len
        z = np.exp(-self.lam * (np.asarray(x, np.float64)[..., None] - mu_b))
        return (self.bin_n_subjects * -np.expm1(-z)).sum(axis=-1)


def fit_length_corrected(
    bin_counts: np.ndarray,
    bin_sums: np.ndarray,
    bin_sumsqs: np.ndarray,
    bin_cut_counts: np.ndarray,
    bin_cut_sums: np.ndarray,
    bin_cut_sumsqs: np.ndarray,
    bin_log_len: np.ndarray,
    bin_n_subjects: np.ndarray,
    min_bin: int = 64,
) -> Optional[LengthFit]:
    """Regress per-bin fitted locations against mean ln(length).

    Per bin b: the nonzero-score (count, sum, sumsq) minus the
    globally-trimmed top members falling in b give a censored
    (mean_b, var_b, p_b) and thus a per-bin censoring-corrected Gumbel
    fit.  The scale is POOLED across bins (lambda is length-independent
    under the Karlin-Altschul law; fitting it per bin on a pooled global
    array would instead absorb the between-bin location spread and bias
    every tail), then locations are re-derived under the pooled scale and
    regressed on ln(length) by weighted least squares.  Bins need >=
    ``min_bin`` usable scores; None when fewer than 2 qualify
    (degenerate / uniform-length databases — callers fall back to the
    global fit).
    """
    counts = np.asarray(bin_counts, np.float64)
    n_body = counts - np.asarray(bin_cut_counts, np.float64)
    usable = n_body >= min_bin
    if int(usable.sum()) < 2:
        return None
    nb = n_body[usable]
    mean_b = (np.asarray(bin_sums, np.float64)[usable] - np.asarray(bin_cut_sums, np.float64)[usable]) / nb
    q_b = (np.asarray(bin_sumsqs, np.float64)[usable] - np.asarray(bin_cut_sumsqs, np.float64)[usable]) / nb
    var_b = q_b - mean_b * mean_b
    if (var_b <= 0).any():
        return None
    p_b = np.asarray(bin_cut_counts, np.float64)[usable] / counts[usable]
    coeffs = [(_trunc_coeffs(float(p))) for p in p_b]
    m1_b = np.array([c[0] for c in coeffs])
    v_b = np.array([c[1] for c in coeffs])
    beta_b = np.sqrt(var_b / v_b)
    beta = float((nb * beta_b).sum() / nb.sum())  # pooled scale
    mu_b = mean_b - beta * m1_b
    x = np.asarray(bin_log_len, np.float64)[usable]
    w = nb
    if float(np.ptp(x)) < 1e-6:  # all usable bins at one length: no slope
        return None
    xm = (w * x).sum() / w.sum()
    ym = (w * mu_b).sum() / w.sum()
    b = float((w * (x - xm) * (mu_b - ym)).sum() / (w * (x - xm) ** 2).sum())
    a = float(ym - b * xm)
    return LengthFit(
        lam=1.0 / beta,
        a=a,
        b=b,
        bin_n_subjects=np.asarray(bin_n_subjects, np.float64),
        bin_log_len=np.asarray(bin_log_len, np.float64),
        n_bins_fit=int(usable.sum()),
    )


# --- engine-facing container --------------------------------------------------


@dataclass(frozen=True)
class NullStats:
    """Sufficient statistics of one query's null score distribution.

    Produced either host-side from a full score array
    (:func:`null_stats_from_scores`) or from the engine's device-side
    reductions (3 scalars + the top-K candidate values that transfer
    anyway) — the fit is identical either way.  ``scale_to`` covers
    sampled nulls (prefilter mode scores a random subset exactly): the
    per-comparison law is fitted from ``count`` scores but E-values
    extrapolate to ``n_subjects`` comparisons.
    """

    count: int  # nonzero scores in the fitted sample
    total: float
    total_sq: float
    top_vals: np.ndarray  # descending nonzero scores (>= ceil(trim*count) ideally)
    n_subjects: int  # comparisons the E-value extrapolates to
    query_length: int
    mean_subject_length: float
    # Optional per-length-bin reductions (FASTA-style corrected E-values).
    top_bins: Optional[np.ndarray] = None  # bin id per top_vals entry
    bin_counts: Optional[np.ndarray] = None  # nonzero scores per bin
    bin_sums: Optional[np.ndarray] = None
    bin_sumsqs: Optional[np.ndarray] = None
    bin_log_len: Optional[np.ndarray] = None  # mean ln(length) per bin
    bin_n_subjects: Optional[np.ndarray] = None  # ALL subjects per bin (full db)

    def fit(self, trim: float = DEFAULT_TRIM) -> GumbelFit:
        return fit_gumbel_stats(self.count, self.total, self.total_sq, self.top_vals, trim=trim)

    def length_fit(self, trim: float = DEFAULT_TRIM) -> Optional[LengthFit]:
        """Length-corrected law, or None when bins are absent/degenerate."""
        if self.bin_counts is None or self.top_bins is None:
            return None
        cut = min(
            int(np.ceil(trim * self.count)) if trim > 0 else 0,
            np.asarray(self.top_vals).size,
            self.count - 16,
        )
        cut = max(cut, 0)
        nb = len(self.bin_counts)
        tb = np.asarray(self.top_bins[:cut])
        tv = np.asarray(self.top_vals[:cut], np.float64)
        ok = tb < nb
        cut_counts = np.bincount(tb[ok], minlength=nb)[:nb]
        cut_sums = np.bincount(tb[ok], weights=tv[ok], minlength=nb)[:nb]
        cut_sumsqs = np.bincount(tb[ok], weights=tv[ok] * tv[ok], minlength=nb)[:nb]
        return fit_length_corrected(
            self.bin_counts,
            self.bin_sums,
            self.bin_sumsqs,
            cut_counts,
            cut_sums,
            cut_sumsqs,
            self.bin_log_len,
            self.bin_n_subjects,
        )


def bin_log_lengths(lengths: np.ndarray, edges: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(mean ln(length), subject count) per bin for a database's lengths."""
    nb = len(edges)
    ids = length_bin_ids(lengths, edges)
    ok = ids < nb
    counts = np.bincount(ids[ok], minlength=nb)[:nb]
    logsum = np.bincount(ids[ok], weights=np.log(np.maximum(lengths[ok], 1)), minlength=nb)[:nb]
    return logsum / np.maximum(counts, 1), counts


def population_bins(lengths: np.ndarray, nbins: int = 12) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(bin edges, mean ln(length) a bin, subjects a bin) of a database's
    lengths: what ``null_stats_from_scores`` derives from its population,
    computed once a database by a caller that fits many nulls to it."""
    lengths = np.asarray(lengths)
    edges = length_bin_edges(lengths, nbins)
    return (edges, *bin_log_lengths(lengths, edges))


def null_stats_from_scores(
    scores: np.ndarray,
    n_subjects: int,
    query_length: int,
    mean_subject_length: float,
    lengths: Optional[np.ndarray] = None,
    nbins: int = 12,
    trim: float = DEFAULT_TRIM,
    population_lengths: Optional[np.ndarray] = None,
    bins: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
) -> NullStats:
    """Host-side sufficient statistics of a score array (with
    per-length-bin reductions when ``lengths`` is given).

    For SAMPLED nulls (``scores``/``lengths`` cover a random subset of
    the database, prefilter calibration mode) pass the FULL database's
    lengths as ``population_lengths``: bin edges and per-bin subject
    counts then describe the whole database while the per-bin score
    moments come from the sample — E-values extrapolate correctly.
    ``bins``, ``population_bins`` of the population (``population_lengths``,
    else ``lengths``) at ``nbins``, stands in for that O(n) pass with the
    same result."""
    s = np.asarray(scores, np.float64).reshape(-1)
    nz = s > 0
    body = s[nz]
    cut = int(np.ceil(trim * body.size)) if trim > 0 else 0
    cut = min(cut, body.size)
    if cut:
        # Every score >= the cut-th largest, then (score desc, index asc):
        # the same tie order as the engine's device top-K.
        kth = -np.partition(-body, cut - 1)[cut - 1]
        idx = np.nonzero(body >= kth)[0]
        top_idx = idx[np.lexsort((idx, -body[idx]))[:cut]]
        top = body[top_idx]
    else:
        top_idx = np.empty(0, np.int64)
        top = np.empty(0, np.float64)
    kw = {}
    if lengths is not None:
        lengths = np.asarray(lengths)
        pop = lengths if population_lengths is None else np.asarray(population_lengths)
        edges, log_len, n_subj_b = population_bins(pop, nbins) if bins is None else bins
        nb = len(edges)
        ids = length_bin_ids(lengths, edges)
        ids_nz = ids[nz]
        okb = ids_nz < nb
        bin_counts = np.bincount(ids_nz[okb], minlength=nb)[:nb]
        bin_sums = np.bincount(ids_nz[okb], weights=body[okb], minlength=nb)[:nb]
        bin_sumsqs = np.bincount(ids_nz[okb], weights=body[okb] ** 2, minlength=nb)[:nb]
        kw = dict(
            top_bins=ids_nz[top_idx],
            bin_counts=bin_counts,
            bin_sums=bin_sums,
            bin_sumsqs=bin_sumsqs,
            bin_log_len=log_len,
            bin_n_subjects=n_subj_b,
        )
    return NullStats(
        count=int(body.size),
        total=float(body.sum()),
        total_sq=float((body * body).sum()),
        top_vals=top,
        n_subjects=int(n_subjects),
        query_length=int(query_length),
        mean_subject_length=float(mean_subject_length),
        **kw,
    )


@dataclass(frozen=True)
class HitStat:
    """One scored hit with its significance."""

    id: int
    score: int
    evalue: float
    bits: float


def hit_significance(
    null: NullStats,
    hits: Sequence[Tuple[int, int]],
    trim: float = DEFAULT_TRIM,
    length_correct: Optional[bool] = None,
) -> List[HitStat]:
    """Significance of ``hits`` ((id, score) pairs) under ``null``.

    ``length_correct`` None = auto: use the length-regressed law whenever
    the per-bin statistics exist and the regression is non-degenerate,
    else the pooled global fit.
    """
    fit = null.fit(trim=trim)
    lfit = None
    if length_correct or length_correct is None:
        lfit = null.length_fit(trim=trim)
        if lfit is None and length_correct:
            raise ValueError(
                "length-corrected E-values need per-length-bin statistics "
                "(too few usable bins or bins not collected)"
            )
    k = fit.k_constant(null.query_length, null.mean_subject_length)
    out = []
    for sid, sc in hits:
        if lfit is not None:
            # Sampled nulls (count < n_subjects) extrapolate: the bins hold
            # FULL-db subject counts already, so no extra scaling.
            e = float(lfit.expected_hits(sc))
        else:
            e = float(null.n_subjects * fit.sf(sc))
        bits = float((fit.lam * sc - np.log(max(k, 1e-300))) / np.log(2.0))
        out.append(HitStat(id=int(sid), score=int(sc), evalue=e, bits=bits))
    return out


def hit_stats(
    scores: np.ndarray,
    hits: Sequence[Tuple[int, int]],
    query_length: int,
    mean_subject_length: float,
    trim: float = DEFAULT_TRIM,
    lengths: Optional[np.ndarray] = None,
) -> List[HitStat]:
    """Significance of ``hits`` against the empirical null fitted from
    ``scores`` (the query's full per-sequence array).  With ``lengths``
    the E-values are length-corrected (see module docstring)."""
    null = null_stats_from_scores(
        scores,
        n_subjects=int(np.asarray(scores).size),
        query_length=query_length,
        mean_subject_length=mean_subject_length,
        lengths=lengths,
        trim=trim,
    )
    return hit_significance(null, hits, trim=trim)
