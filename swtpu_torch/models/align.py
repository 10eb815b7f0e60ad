"""Two-phase alignment reconstruction (traceback), a copy of
``swtpu.models.align``.

1. **Score phase** (the card, every cell): the engine finds every subject's
   exact maximum score and ranks the top-K hits.
2. **Traceback phase** (the host, only for the K hits): each hit's DP is
   recomputed with the NumPy oracle (``swtpu_torch.ops.oracle``) and walked
   back from its argmax cell into gapped strings.  Linear gaps follow the
   reference CPU aligner's semantics (candidate order LEFT < TOP < DIAG with
   strictly-greater override, argmax = first maximal cell row-major, walk
   stops at value 0); affine gaps walk the Gotoh H/E/F state machine.

The traceback is a pointer-chasing scalar walk that suits the host, and only
K of the database's subjects need it.  Its score is checked against the
device score of the same hit, a free cross-check of both phases.  Pairs too
large for full matrices recompute row blocks from checkpoints
(``_BlockedH``, ``_BlockedHEF``) in bounded memory, with identical results.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

import numpy as np

from ..alphabet import decode
from ..config import SWConfig
from ..io.fasta import Database, Query
from ..matrices import get_matrix
from ..ops.oracle import (
    FROM_LEFT,
    FROM_NONE,
    FROM_TOP,
    FROM_TOP_LEFT,
    NEG32,
    sw_affine_matrices,
    sw_affine_rows_from,
    sw_matrix_h,
    sw_matrix_h_from,
)


@dataclasses.dataclass
class Alignment:
    """One reconstructed local alignment."""

    subject_id: int  # 0-based database file-order id
    score: int
    aligned_query: str  # gapped, '-' for gaps (cpu.cpp output format)
    aligned_subject: str
    query_end: int  # 1-based DP end row (cpu.cpp maxIndexI)
    subject_end: int  # 1-based DP end column (cpu.cpp maxIndexJ)

    @property
    def query_start(self) -> int:
        """1-based inclusive start position in the query."""
        return self.query_end - sum(1 for c in self.aligned_query if c != "-") + 1

    @property
    def subject_start(self) -> int:
        return self.subject_end - sum(1 for c in self.aligned_subject if c != "-") + 1

    def midline(self) -> str:
        """BLAST-style midline: '|' match, ' ' mismatch/gap."""
        return "".join(
            "|" if a == b and a != "-" else " "
            for a, b in zip(self.aligned_query, self.aligned_subject)
        )

    def pretty(self, width: int = 60) -> str:
        lines: List[str] = [
            f"subject {self.subject_id}  score {self.score}  "
            f"q[{self.query_start}:{self.query_end}] s[{self.subject_start}:{self.subject_end}]"
        ]
        mid = self.midline()
        for k in range(0, len(self.aligned_query), width):
            lines.append("Q " + self.aligned_query[k : k + width])
            lines.append("  " + mid[k : k + width])
            lines.append("S " + self.aligned_subject[k : k + width])
        return "\n".join(lines)


class _BlockedH:
    """Memory-bounded H accessor for the traceback walk.

    Instead of materialising the full (m+1)x(n+1) int64 H (1.5 GB for a
    5.5k-aa query vs a 35k-aa subject), row
    checkpoints every R rows are kept (int32) plus ONE recomputed (R+1)-row
    block around the walk position: peak memory is O((m/R + R) * n).  The
    walk's rows are non-increasing, so each block recomputes at most once
    (total recompute <= one extra full DP pass).  Values are bit-identical
    to sw_matrix_h (the block recurrence is Markov in the previous row).
    """

    def __init__(self, q: np.ndarray, s: np.ndarray, matrix: np.ndarray, gap: int):
        self.q, self.s, self.matrix, self.gap = q, s, matrix, gap
        m, n = len(q), len(s)
        # Balance checkpoint rows (m/R, int32) vs block rows (R, int64).
        self.R = max(16, int(math.isqrt(max(m, 1)) * 2))
        rebase = gap * np.arange(1, n + 1, dtype=np.int64)
        self.checkpoints = {0: np.zeros(n + 1, dtype=np.int64)}
        # Pass 1: row sweep tracking the FIRST row-major maximal cell
        # (cpu.cpp:66-70 strictly-greater update order).
        prev = np.zeros(n + 1, dtype=np.int64)
        best, bi, bj = 0, 0, 0
        row = np.zeros(n + 1, dtype=np.int64)
        for i in range(1, m + 1):
            sub = matrix[q[i - 1], s]
            t = np.maximum(0, prev[:-1] + sub)
            np.maximum(t, prev[1:] - gap, out=t)
            row[1:] = np.maximum.accumulate(t + rebase) - rebase
            rmax = int(row.max())
            if rmax > best:
                best, bi, bj = rmax, i, int(np.argmax(row))
            if i % self.R == 0:
                self.checkpoints[i] = row.astype(np.int32)
            prev, row = row, prev  # buffer swap; next row is built from `prev`
        self.best, self.bi, self.bj = best, bi, bj
        self._blk_lo = -1
        self._blk = None

    def _ensure(self, i: int) -> None:
        """Materialise the block containing row i (and row i-1 when i>0).

        Containment (not block-base equality) check: at a block boundary
        the walk alternates hval(i, ...) / hval(i-1, ...) reads, and a
        base-equality check would ping-pong between adjacent blocks,
        recomputing an R-row DP block per access during gap runs.
        """
        if (
            self._blk is not None
            and self._blk_lo <= i
            and i - self._blk_lo <= self._blk.shape[0] - 1
        ):
            return
        # Recompute base: include row i-1 too — the walk reads it next.
        lo = max(0, ((i - 1) // self.R) * self.R) if i > 0 else 0
        hi = min(lo + self.R, len(self.q))
        self._blk = sw_matrix_h_from(
            self.q, self.s, self.matrix, self.gap, self.checkpoints[lo], lo, hi
        )
        self._blk_lo = lo

    def __call__(self, i: int, j: int) -> int:
        self._ensure(i)
        if i < self._blk_lo:  # pragma: no cover - walk rows never increase
            raise AssertionError("traceback moved forward")
        return int(self._blk[i - self._blk_lo, j])


def traceback_pair(
    query_idx: np.ndarray,
    subject_idx: np.ndarray,
    matrix: np.ndarray,
    gap: int,
    subject_id: int = 0,
    max_full_bytes: int = 128 << 20,
) -> Alignment:
    """Recompute one pair's DP with directions and walk the traceback.

    Exact cpu.cpp semantics (src/cpu.cpp:43-103); operates on encoded
    residue indices so any engine matrix (BLOSUM or match/mismatch) works.
    Pairs whose full H would exceed ``max_full_bytes`` use the blocked
    checkpoint-recompute accessor (same values, bounded memory).
    """
    q = np.asarray(query_idx, dtype=np.int64)
    s = np.asarray(subject_idx, dtype=np.int64)
    # Vectorised H fill; directions re-derived per visited cell during the
    # walk (O(alignment) cells) with cpu.cpp's exact candidate order —
    # building the full int8 direction matrix cell-by-cell would cost
    # O(q*l) Python-loop time (minutes for long hits).
    if (len(q) + 1) * (len(s) + 1) * 8 <= max_full_bytes:
        H = sw_matrix_h(q, s, matrix, gap)
        flat = int(np.argmax(H))  # first maximal cell row-major (cpu.cpp:66-70)
        i, j = divmod(flat, H.shape[1])
        hval = lambda ti, tj: int(H[ti, tj])  # noqa: E731
        score = int(H[i, j])
    else:
        blocked = _BlockedH(q, s, matrix, gap)
        i, j, score = blocked.bi, blocked.bj, blocked.best
        hval = blocked
    q_str = decode(q)
    s_str = decode(s)

    def origin(ti: int, tj: int) -> int:
        """cpu.cpp:47-64 selection: LEFT, TOP, DIAG tried in order, each
        overriding only on strictly-greater score."""
        best, org = 0, FROM_NONE
        cand = hval(ti, tj - 1) - gap
        if cand > best:
            best, org = cand, FROM_LEFT
        cand = hval(ti - 1, tj) - gap
        if cand > best:
            best, org = cand, FROM_TOP
        cand = hval(ti - 1, tj - 1) + int(matrix[q[ti - 1], s[tj - 1]])
        if cand > best:
            best, org = cand, FROM_TOP_LEFT
        return org

    out_q: List[str] = []
    out_s: List[str] = []
    ti, tj = i, j
    while hval(ti, tj) != 0:
        d = origin(ti, tj)
        if d == FROM_LEFT:
            tj -= 1
            out_q.append("-")
            out_s.append(s_str[tj])
        elif d == FROM_TOP:
            ti -= 1
            out_q.append(q_str[ti])
            out_s.append("-")
        elif d == FROM_TOP_LEFT:
            ti -= 1
            tj -= 1
            out_q.append(q_str[ti])
            out_s.append(s_str[tj])
        else:  # pragma: no cover - nonzero cell always has an origin
            break
    return Alignment(
        subject_id=subject_id,
        score=score,
        aligned_query="".join(reversed(out_q)),
        aligned_subject="".join(reversed(out_s)),
        query_end=i,
        subject_end=j,
    )


def align_hits(query: Query, db: Database, hits: Sequence[Tuple[int, int]], config: SWConfig) -> List[Alignment]:
    """Tracebacks of (subject id, device score) hits under ``config``'s
    matrix and gap model (the Gotoh walk when ``gap_open`` is set).

    Raises AssertionError when a traceback score differs from its device
    score: the two phases disagree.
    """
    matrix = get_matrix(config.matrix)
    out: List[Alignment] = []
    for sid, dev_score in hits:
        if config.gap_open is not None:
            aln = traceback_pair_affine(
                query.residues, db.sequence(sid), matrix, config.gap_open, config.gap_extend, subject_id=sid
            )
        else:
            aln = traceback_pair(query.residues, db.sequence(sid), matrix, config.gap_penalty, subject_id=sid)
        if aln.score != dev_score:
            raise AssertionError(f"traceback score {aln.score} != device score {dev_score} for subject {sid}")
        out.append(aln)
    return out


def align_top_k(
    query: Query,
    db: Database,
    k: int = 10,
    config: SWConfig = SWConfig(),
    engine=None,
    device=None,
) -> List[Alignment]:
    """Search the database, then reconstruct alignments for the top-K hits.

    Phase 1 runs on the engine's device (``engine``, else a
    :class:`swtpu_torch.models.search.SearchEngine` of ``config`` on
    ``device``: the card unless the caller names another); phase 2 is the
    host traceback above.  Device and traceback scores are checked equal.
    """
    from .search import SearchEngine

    if engine is None:
        engine = SearchEngine(config, device=device)
    return align_hits(query, db, engine.search(query, db).top_k(k), config)


class _BlockedHEF:
    """Memory-bounded H/E/F accessor for the affine traceback walk.

    The affine counterpart of :class:`_BlockedH`:
    instead of materialising three full (m+1)x(n+1) int64 matrices (~4.6 GB
    for a 5.5k-aa query vs a 35k-aa subject), (H, E, F) row checkpoints are
    kept every R rows (int32) plus ONE recomputed (R+1)-row block around
    the walk position: peak memory is O((m/R + R) * n) int32 — under
    ~80 MB for the 5.5k x 35k case.  The walk's rows are non-increasing,
    so each block recomputes at most once.  Values are bit-identical to
    sw_affine_matrices: the row recurrence is Markov in the previous row's
    (H, F) and E is closed-form within its own row
    (swtpu_torch.ops.oracle.sw_affine_rows_from).
    """

    def __init__(self, q: np.ndarray, s: np.ndarray, matrix: np.ndarray, open_: int, ext: int):
        self.q, self.s, self.matrix, self.open_, self.ext = q, s, matrix, open_, ext
        m, n = len(q), len(s)
        self.R = max(16, int(math.isqrt(max(m, 1)) * 2))
        h_prev = np.zeros(n + 1, dtype=np.int32)
        f_prev = np.full(n + 1, NEG32, dtype=np.int32)
        self.checkpoints = {0: (h_prev, np.full(n + 1, NEG32, dtype=np.int32), f_prev)}
        jfull = np.arange(n + 1, dtype=np.int32)
        zero = np.zeros(1, dtype=np.int32)
        # Pass 1: row sweep tracking the FIRST row-major maximal H cell
        # (same semantics as np.argmax over the full matrix).
        best, bi, bj = 0, 0, 0
        for i in range(1, m + 1):
            f_cur = np.full(n + 1, NEG32, dtype=np.int32)
            f_cur[1:] = np.maximum(h_prev[1:] - open_, f_prev[1:] - ext)
            sub = matrix[q[i - 1], s].astype(np.int32)
            diag = h_prev[:-1] + sub
            h0 = np.maximum(0, np.maximum(diag, f_cur[1:]))
            u = np.maximum.accumulate(np.concatenate((zero, h0)) + ext * jfull)
            e_cur = np.full(n + 1, NEG32, dtype=np.int32)
            e_cur[1:] = u[:-1] - open_ - ext * (jfull[1:] - 1)
            h_cur = np.zeros(n + 1, dtype=np.int32)
            h_cur[1:] = np.maximum(h0, e_cur[1:])
            rmax = int(h_cur.max())
            if rmax > best:
                best, bi, bj = rmax, i, int(np.argmax(h_cur))
            if i % self.R == 0:
                self.checkpoints[i] = (h_cur, e_cur, f_cur)
            h_prev, f_prev = h_cur, f_cur
        self.best, self.bi, self.bj = best, bi, bj
        self._blk_lo = -1
        self._blk = None

    def _ensure(self, i: int) -> None:
        """Materialise the block containing rows i and i-1 (containment
        check, not base equality — see _BlockedH._ensure)."""
        if (
            self._blk is not None
            and self._blk_lo <= i
            and i - self._blk_lo <= self._blk[0].shape[0] - 1
        ):
            return
        lo = max(0, ((i - 1) // self.R) * self.R) if i > 0 else 0
        hi = min(lo + self.R, len(self.q))
        h0, e0, f0 = self.checkpoints[lo]
        self._blk = sw_affine_rows_from(
            self.q, self.s, self.matrix, self.open_, self.ext, h0, e0, f0, lo, hi
        )
        self._blk_lo = lo

    def h(self, i: int, j: int) -> int:
        self._ensure(i)
        return int(self._blk[0][i - self._blk_lo, j])

    def e(self, i: int, j: int) -> int:
        self._ensure(i)
        return int(self._blk[1][i - self._blk_lo, j])

    def f(self, i: int, j: int) -> int:
        self._ensure(i)
        return int(self._blk[2][i - self._blk_lo, j])


def traceback_pair_affine(
    query_idx: np.ndarray,
    subject_idx: np.ndarray,
    matrix: np.ndarray,
    gap_open: int,
    gap_extend: int,
    subject_id: int = 0,
    max_full_bytes: int = 128 << 20,
) -> Alignment:
    """Affine (Gotoh) traceback: recompute H/E/F and walk the state machine.

    Beyond-reference (the reference's cpu.cpp is linear-gap only).  State
    semantics: in H, prefer DIAG, then E (gap in the query / consume
    subject), then F — a documented deterministic order (there is no
    reference format to match here); in E/F, the walk stays in the gap
    state while the extension identity holds, closing it at the opening
    cell.  Emitted alignments are validated by re-scoring in tests.

    Pairs whose full int64 H+E+F would exceed ``max_full_bytes`` use the
    blocked checkpoint-recompute accessor :class:`_BlockedHEF` (identical
    values, O((m/R + R) * n) int32 memory) — the affine port of the
    linear path's memory-bounded scheme.
    """
    q = np.asarray(query_idx, dtype=np.int64)
    s = np.asarray(subject_idx, dtype=np.int64)
    if 3 * (len(q) + 1) * (len(s) + 1) * 8 <= max_full_bytes:
        H, E, F = sw_affine_matrices(q, s, matrix, gap_open, gap_extend)
        flat = int(np.argmax(H))  # first maximal cell row-major
        i, j = divmod(flat, H.shape[1])
        score = int(H[i, j])
        hval = lambda ti, tj: int(H[ti, tj])  # noqa: E731
        eval_ = lambda ti, tj: int(E[ti, tj])  # noqa: E731
        fval = lambda ti, tj: int(F[ti, tj])  # noqa: E731
    else:
        blk = _BlockedHEF(q, s, matrix, gap_open, gap_extend)
        i, j, score = blk.bi, blk.bj, blk.best
        hval, eval_, fval = blk.h, blk.e, blk.f
    q_str = decode(q)
    s_str = decode(s)
    out_q: List[str] = []
    out_s: List[str] = []
    # All reads sit on rows ti and ti-1 (gap-state closing tests read the
    # PRE-decrement cells), so the blocked accessor's single block always
    # covers the walk position.
    ti, tj, state = i, j, "H"
    while not (state == "H" and hval(ti, tj) == 0):
        if state == "H":
            if ti > 0 and tj > 0 and hval(ti, tj) == hval(ti - 1, tj - 1) + int(
                matrix[q[ti - 1], s[tj - 1]]
            ):
                ti -= 1
                tj -= 1
                out_q.append(q_str[ti])
                out_s.append(s_str[tj])
            elif hval(ti, tj) == eval_(ti, tj):
                state = "E"
            else:  # H == F by construction
                state = "F"
        elif state == "E":  # gap in the query: consume a subject residue
            # Closing test on pre-decrement cells: E[i,j] == H[i,j-1]-open
            # (else E[i,j] == E[i,j-1]-ext: stay in E).
            closing = eval_(ti, tj) == hval(ti, tj - 1) - gap_open
            tj -= 1
            out_q.append("-")
            out_s.append(s_str[tj])
            if closing:
                state = "H"
        else:  # state == "F": gap in the subject, consume a query residue
            closing = fval(ti, tj) == hval(ti - 1, tj) - gap_open
            ti -= 1
            out_q.append(q_str[ti])
            out_s.append("-")
            if closing:
                state = "H"
    return Alignment(
        subject_id=subject_id,
        score=score,
        aligned_query="".join(reversed(out_q)),
        aligned_subject="".join(reversed(out_s)),
        query_end=i,
        subject_end=j,
    )
