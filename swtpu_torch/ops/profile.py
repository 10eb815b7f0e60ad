"""Query profile and padding constants (from ``swtpu.ops.xla_sw``).

Subject pad slots hold ``PAD_SUBJECT`` (25), an index outside the real
alphabet, and profile column 25-31 and query pad rows hold ``PAD_SCORE``.
PAD_SCORE is strictly negative (and below -2*gap for the default gap), so a
pad cell never raises the running max: by induction its value stays below
the best real cell (diag + negative < diag; gap moves decay).
"""

from __future__ import annotations

import numpy as np

from ..alphabet import PADDED_ALPHABET_SIZE

PAD_SUBJECT = 25
PAD_SCORE = -16


def make_profile(query_idx: np.ndarray, matrix: np.ndarray, pad_rows_to: int = 1) -> np.ndarray:
    """Build the (qpad, 32) int8 query profile.

    profile[i, r] = matrix[query[i], r] for real residues r; PAD_SCORE for
    columns 25-31 and for query pad rows.  qpad = ceil(q / pad_rows_to) *
    pad_rows_to.
    """
    q = np.asarray(query_idx, dtype=np.int64)
    qlen = q.shape[0]
    qpad = -(-max(qlen, 1) // pad_rows_to) * pad_rows_to
    prof = np.full((qpad, PADDED_ALPHABET_SIZE), PAD_SCORE, dtype=np.int8)
    if matrix.min() < -128 or matrix.max() > 127:
        raise ValueError("substitution matrix does not fit int8 profile")
    prof[:qlen, : matrix.shape[1]] = matrix[q].astype(np.int8)
    return prof
