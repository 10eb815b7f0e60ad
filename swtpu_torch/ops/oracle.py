"""NumPy Smith-Waterman oracle for the traceback and the checks (copy of
the parts of ``swtpu.ops.oracle`` this package needs).

Deliberately simple host code, independent of the kernel and of its plain
version: full H (linear) and H/E/F (affine, Gotoh) matrices for the
traceback (``swtpu_torch.models.align``), their row-block recomputation from
a checkpoint row for its memory-bounded mode, anti-diagonal and scalar
scorers that hold the engine's scores to an independent algorithm, and the
cell-by-cell score and direction matrices with their walk
(``sw_matrix``, ``sw_traceback``) behind the pairwise aligner
``swtpu_torch.cpu_align``.

Semantics: local alignment, ``H = max(0, diag + S, E, F)``; a linear gap
costs ``gap`` a residue, an affine gap of length L ``open_ + (L-1)*ext``
(``open_ == ext`` is the linear recurrence).  Traceback ties follow the
reference CPU aligner: LEFT, TOP, DIAG tried in that order, each overriding
only on a strictly greater score; the argmax is the first maximal cell in
row-major order.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

FROM_NONE = 0
FROM_LEFT = 1
FROM_TOP = 2
FROM_TOP_LEFT = 3


def sw_score_scalar(query: np.ndarray, subject: np.ndarray, matrix: np.ndarray, gap: int) -> int:
    """Naive scalar SW max-score (the most obviously correct form; tiny
    inputs only).  query/subject: int residue indices."""
    q = np.asarray(query, dtype=np.int64)
    s = np.asarray(subject, dtype=np.int64)
    prev = np.zeros(len(s) + 1, dtype=np.int64)
    best = 0
    for qi in q:
        cur = np.zeros(len(s) + 1, dtype=np.int64)
        for j in range(1, len(s) + 1):
            h = max(0, cur[j - 1] - gap, prev[j] - gap, prev[j - 1] + int(matrix[qi, s[j - 1]]))
            cur[j] = h
            if h > best:
                best = h
        prev = cur
    return int(best)


def sw_matrix(query: np.ndarray, subject: np.ndarray, matrix: np.ndarray, gap: int) -> Tuple[np.ndarray, np.ndarray]:
    """Full (m+1, n+1) score and direction matrices, cell by cell: LEFT,
    TOP, DIAG tried in that order, each overriding only on a strictly
    greater score (FROM_NONE where the cell is 0)."""
    q = np.asarray(query, dtype=np.int64)
    s = np.asarray(subject, dtype=np.int64)
    m, n = len(q), len(s)
    H = np.zeros((m + 1, n + 1), dtype=np.int64)
    TB = np.zeros((m + 1, n + 1), dtype=np.int8)
    for i in range(1, m + 1):
        for j in range(1, n + 1):
            score, origin = 0, FROM_NONE
            cand = H[i, j - 1] - gap
            if cand > score:
                score, origin = cand, FROM_LEFT
            cand = H[i - 1, j] - gap
            if cand > score:
                score, origin = cand, FROM_TOP
            cand = H[i - 1, j - 1] + int(matrix[q[i - 1], s[j - 1]])
            if cand > score:
                score, origin = cand, FROM_TOP_LEFT
            H[i, j] = score
            TB[i, j] = origin
    return H, TB


def sw_traceback(
    query_str: str, subject_str: str, matrix: np.ndarray, gap: int, encode=None
) -> Tuple[int, str, str, Tuple[int, int]]:
    """Score and gapped aligned strings of the first maximal cell in
    row-major order, walked back until a cell of 0.

    Returns (max_score, aligned_query, aligned_subject, (end_i, end_j)), the
    end indices 1-based into the DP matrix.  ``encode`` maps a string to
    residue indices (default: ``swtpu_torch.alphabet.encode_str``).
    """
    if encode is None:
        from ..alphabet import encode_str as encode
    H, TB = sw_matrix(encode(query_str), encode(subject_str), matrix, gap)
    i, j = divmod(int(np.argmax(H)), H.shape[1])
    best = int(H[i, j])
    out_q: List[str] = []
    out_s: List[str] = []
    ti, tj = i, j
    while H[ti, tj] != 0:
        d = TB[ti, tj]
        if d == FROM_LEFT:
            tj -= 1
            out_q.append("-")
            out_s.append(subject_str[tj])
        elif d == FROM_TOP:
            ti -= 1
            out_q.append(query_str[ti])
            out_s.append("-")
        elif d == FROM_TOP_LEFT:
            ti -= 1
            tj -= 1
            out_q.append(query_str[ti])
            out_s.append(subject_str[tj])
        else:  # a nonzero cell always has an origin
            break
    return best, "".join(reversed(out_q)), "".join(reversed(out_s)), (i, j)


def sw_matrix_h(query: np.ndarray, subject: np.ndarray, matrix: np.ndarray, gap: int) -> np.ndarray:
    """Full (m+1, n+1) scoring matrix, vectorised per row (no Python cell loop).

    The H of a cell-by-cell fill, ~1000x faster for long pairs: the
    within-row gap chain H[j] = max(T[j], H[j-1]-g) is computed as
    ``np.maximum.accumulate(T + g*j) - g*j`` (the u-space trick the device
    kernels use).  Use together with an on-the-fly traceback that re-derives
    each cell's origin from H (models.align.traceback_pair) when the full
    int8 direction matrix would be too slow to build cell-by-cell.
    """
    q = np.asarray(query, dtype=np.int64)
    s = np.asarray(subject, dtype=np.int64)
    m, n = len(q), len(s)
    H = np.zeros((m + 1, n + 1), dtype=np.int64)
    if n == 0 or m == 0:
        return H
    rebase = gap * np.arange(1, n + 1, dtype=np.int64)
    for i in range(1, m + 1):
        sub = matrix[q[i - 1], s]
        prev = H[i - 1]
        t = np.maximum(0, prev[:-1] + sub)  # diag
        np.maximum(t, prev[1:] - gap, out=t)  # top
        H[i, 1:] = np.maximum.accumulate(t + rebase) - rebase
    return H


def sw_matrix_h_from(
    query: np.ndarray,
    subject: np.ndarray,
    matrix: np.ndarray,
    gap: int,
    first_row: np.ndarray,
    i_lo: int,
    i_hi: int,
) -> np.ndarray:
    """Rows ``i_lo..i_hi`` (inclusive) of H, given ``H[i_lo] == first_row``.

    The row recurrence is Markov in the previous row, so any block of rows
    recomputes exactly from a checkpointed row — the building block of the
    memory-bounded traceback (swtpu_torch.models.align), which replaces the
    full (m+1)x(n+1) materialisation (1.5 GB for a 5.5k-aa query vs a 35k-aa
    subject) with O(sqrt(m)*n) checkpoints + one block.
    """
    q = np.asarray(query, dtype=np.int64)
    s = np.asarray(subject, dtype=np.int64)
    n = len(s)
    rows = i_hi - i_lo + 1
    H = np.zeros((rows, n + 1), dtype=np.int64)
    H[0] = first_row
    rebase = gap * np.arange(1, n + 1, dtype=np.int64)
    for r in range(1, rows):
        i = i_lo + r
        sub = matrix[q[i - 1], s]
        prev = H[r - 1]
        t = np.maximum(0, prev[:-1] + sub)
        np.maximum(t, prev[1:] - gap, out=t)
        H[r, 1:] = np.maximum.accumulate(t + rebase) - rebase
    return H


def sw_score_diag(query: np.ndarray, subject: np.ndarray, matrix: np.ndarray, gap: int) -> int:
    """Anti-diagonal vectorised SW max-score (NumPy).

    State is three diagonals indexed by query position i; cells on diagonal d
    are (i, j=d-i).  Independent of the device kernels' row-cummax algorithm.
    """
    q = np.asarray(query, dtype=np.int64)
    s = np.asarray(subject, dtype=np.int64)
    m, n = len(q), len(s)
    if m == 0 or n == 0:
        return 0
    neg = np.int64(-(1 << 40))
    d2 = np.full(m, neg)  # H on diagonal d-2, index by i
    d1 = np.full(m, neg)  # H on diagonal d-1
    best = np.int64(0)
    ii = np.arange(m)
    for d in range(m + n - 1):
        lo = max(0, d - n + 1)
        hi = min(m - 1, d)
        cur = np.full(m, neg)
        seg = slice(lo, hi + 1)
        jj = d - ii[seg]
        sub = matrix[q[seg], s[jj]].astype(np.int64)
        # H[i-1, j-1]: for i>=1, j>=1 it lives at d2[i-1]; boundaries -> 0.
        shifted_d2 = np.concatenate(([np.int64(0)], d2[:-1]))
        diag_prev = np.where((ii[seg] >= 1) & (jj >= 1), shifted_d2[seg], 0)
        up = np.where(ii[seg] >= 1, np.concatenate(([np.int64(0)], d1[:-1]))[seg], 0)  # H[i-1, j]
        left = np.where(jj >= 1, d1[seg], 0)  # H[i, j-1]
        h = np.maximum(0, diag_prev + sub)
        h = np.maximum(h, up - gap)
        h = np.maximum(h, left - gap)
        cur[seg] = h
        m_ = h.max()
        if m_ > best:
            best = m_
        d2, d1 = d1, cur
    return int(best)


def sw_score_many(query: np.ndarray, subjects: Sequence[np.ndarray], matrix: np.ndarray, gap: int) -> np.ndarray:
    """One query against many subjects with the diagonal scorer; (n,) int32."""
    return np.array([sw_score_diag(query, s, matrix, gap) for s in subjects], dtype=np.int32)


def sw_affine_score_scalar(
    query: np.ndarray, subject: np.ndarray, matrix: np.ndarray, open_: int, ext: int
) -> int:
    """Naive scalar affine-gap (Gotoh) SW max-score.

    A gap of length L costs ``open_ + (L-1)*ext`` —
    the first gapped residue pays ``open_``, each further one ``ext`` —
    so ``open_ == ext`` reduces exactly to the linear recurrence with
    ``gap = open_`` (property-tested).  Local alignment: H floors at 0.
    """
    q = np.asarray(query, dtype=np.int64)
    s = np.asarray(subject, dtype=np.int64)
    n = len(s)
    neg = -(1 << 40)
    h_prev = np.zeros(n + 1, dtype=np.int64)
    f_prev = np.full(n + 1, neg, dtype=np.int64)
    best = 0
    for qi in q:
        h_cur = np.zeros(n + 1, dtype=np.int64)
        f_cur = np.full(n + 1, neg, dtype=np.int64)
        e = neg
        for j in range(1, n + 1):
            e = max(h_cur[j - 1] - open_, e - ext)
            f_cur[j] = max(h_prev[j] - open_, f_prev[j] - ext)
            h = max(0, h_prev[j - 1] + int(matrix[qi, s[j - 1]]), e, f_cur[j])
            h_cur[j] = h
            if h > best:
                best = h
        h_prev, f_prev = h_cur, f_cur
    return int(best)


def sw_affine_score_diag(
    query: np.ndarray, subject: np.ndarray, matrix: np.ndarray, open_: int, ext: int
) -> int:
    """Anti-diagonal vectorised affine (Gotoh) max-score (NumPy).

    Same diagonal state walk as :func:`sw_score_diag` plus E/F gap states:
    E[i,j] depends on (i, j-1) (previous diagonal, same i), F[i,j] on
    (i-1, j) (previous diagonal, i-1) — an independent cross-check for
    :func:`sw_affine_score_scalar` and the device kernels.
    """
    q = np.asarray(query, dtype=np.int64)
    s = np.asarray(subject, dtype=np.int64)
    m, n = len(q), len(s)
    if m == 0 or n == 0:
        return 0
    neg = np.int64(-(1 << 40))
    d2 = np.full(m, neg)  # H on diagonal d-2
    d1 = np.full(m, neg)  # H on diagonal d-1
    e1 = np.full(m, neg)  # E on diagonal d-1
    f1 = np.full(m, neg)  # F on diagonal d-1
    best = np.int64(0)
    ii = np.arange(m)
    for d in range(m + n - 1):
        lo = max(0, d - n + 1)
        hi = min(m - 1, d)
        curh = np.full(m, neg)
        cure = np.full(m, neg)
        curf = np.full(m, neg)
        seg = slice(lo, hi + 1)
        jj = d - ii[seg]
        sub = matrix[q[seg], s[jj]].astype(np.int64)
        shifted_d2 = np.concatenate(([np.int64(0)], d2[:-1]))
        diag_prev = np.where((ii[seg] >= 1) & (jj >= 1), shifted_d2[seg], 0)
        up_h = np.where(ii[seg] >= 1, np.concatenate(([neg], d1[:-1]))[seg], neg)
        up_f = np.where(ii[seg] >= 1, np.concatenate(([neg], f1[:-1]))[seg], neg)
        left_h = np.where(jj >= 1, d1[seg], neg)
        left_e = np.where(jj >= 1, e1[seg], neg)
        e = np.maximum(left_h - open_, left_e - ext)
        f = np.maximum(up_h - open_, up_f - ext)
        h = np.maximum(0, diag_prev + sub)
        h = np.maximum(h, np.maximum(e, f))
        curh[seg], cure[seg], curf[seg] = h, e, f
        m_ = h.max()
        if m_ > best:
            best = m_
        d2, d1, e1, f1 = d1, curh, cure, curf
    return int(best)


def sw_affine_matrices(
    query: np.ndarray, subject: np.ndarray, matrix: np.ndarray, open_: int, ext: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full (m+1, n+1) H/E/F Gotoh matrices (traceback support).

    Row-vectorised: F is a plain elementwise recurrence across rows, and
    the within-row E chain collapses to a shifted running max in "u-space"
    (E[j] = max_{j'<j} H[j'] - open_ - (j-j'-1)*ext
          = cummax(H[j'] + ext*j')[j-1] - open_ - ext*(j-1)).
    """
    q = np.asarray(query, dtype=np.int64)
    s = np.asarray(subject, dtype=np.int64)
    m, n = len(q), len(s)
    neg = np.int64(-(1 << 40))
    H = np.zeros((m + 1, n + 1), dtype=np.int64)
    E = np.full((m + 1, n + 1), neg, dtype=np.int64)
    F = np.full((m + 1, n + 1), neg, dtype=np.int64)
    if open_ < ext:
        raise ValueError("closed-form E row requires open_ >= ext (SWConfig enforces this)")
    jfull = np.arange(n + 1, dtype=np.int64)
    for i in range(1, m + 1):
        F[i, 1:] = np.maximum(H[i - 1, 1:] - open_, F[i - 1, 1:] - ext)
        sub = matrix[q[i - 1], s].astype(np.int64)
        diag = H[i - 1, :-1] + sub
        # E depends on H of the SAME row: with open_ >= ext, chaining a
        # new gap open off an E-raised H cell is never strictly better
        # than extending the original gap, so the fixed point is the
        # running max over h0 = H-without-E (incl. the j'=0 boundary):
        # E[j] = max_{j' < j} (h0[j'] + ext*j') - open_ - ext*(j-1).
        h0 = np.maximum(0, np.maximum(diag, F[i, 1:]))
        u = np.maximum.accumulate(np.concatenate(([np.int64(0)], h0)) + ext * jfull)
        E[i, 1:] = u[:-1] - open_ - ext * (jfull[1:] - 1)
        H[i, 1:] = np.maximum(h0, E[i, 1:])
    return H, E, F


#: int32-safe "minus infinity" for the blocked affine traceback: far enough
#: below any reachable E/F value (E, F >= -open_ on rows >= 1) that no
#: equality test matches it, far enough above INT32_MIN that -ext never wraps.
NEG32 = np.int32(-(1 << 30))


def sw_affine_rows_from(
    query: np.ndarray,
    subject: np.ndarray,
    matrix: np.ndarray,
    open_: int,
    ext: int,
    h_first: np.ndarray,
    e_first: np.ndarray,
    f_first: np.ndarray,
    i_lo: int,
    i_hi: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Rows ``i_lo..i_hi`` (inclusive) of the Gotoh H/E/F matrices, given
    the checkpointed row ``i_lo``.

    The affine row recurrence is Markov in (H, F) of the previous row (E is
    closed-form within its own row), so any row block recomputes exactly
    from a (H, F) checkpoint — the affine counterpart of
    :func:`sw_matrix_h_from`, backing the memory-bounded traceback
    (swtpu_torch.models.align._BlockedHEF).  int32 throughout: H is bounded by
    max(matrix)*min(m,n) and E/F by ``-open_`` below zero on rows >= 1;
    boundary cells carry the :data:`NEG32` sentinel.
    """
    q = np.asarray(query, dtype=np.int64)
    s = np.asarray(subject, dtype=np.int64)
    n = len(s)
    rows = i_hi - i_lo + 1
    H = np.zeros((rows, n + 1), dtype=np.int32)
    E = np.full((rows, n + 1), NEG32, dtype=np.int32)
    F = np.full((rows, n + 1), NEG32, dtype=np.int32)
    H[0], E[0], F[0] = h_first, e_first, f_first
    jfull = np.arange(n + 1, dtype=np.int32)
    zero = np.zeros(1, dtype=np.int32)
    for r in range(1, rows):
        i = i_lo + r
        F[r, 1:] = np.maximum(H[r - 1, 1:] - open_, F[r - 1, 1:] - ext)
        sub = matrix[q[i - 1], s].astype(np.int32)
        diag = H[r - 1, :-1] + sub
        h0 = np.maximum(0, np.maximum(diag, F[r, 1:]))
        u = np.maximum.accumulate(np.concatenate((zero, h0)) + ext * jfull)
        E[r, 1:] = u[:-1] - open_ - ext * (jfull[1:] - 1)
        H[r, 1:] = np.maximum(h0, E[r, 1:])
    return H, E, F
