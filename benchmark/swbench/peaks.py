"""The yardstick's constants: one NVIDIA H100 SXM's peaks and the
operations of a dynamic-programming cell.

The integer peak is the packed rate: 132 SMs x 64 lanes x 1.98 GHz x 2
(an add and a max in one ``VIADDMNMX``) x 2 (two int16 cells a 32-bit
lane), 66.9 T ops/s.  A kernel that packs two cells a lane is held to it
and cannot read over 100%; an int32 kernel reaches at most half.  Memory:
3.35 TB/s.  A cell costs 6 operations under linear gaps and 11 under affine
ones (the adds and maxes of the recurrence), counted on true cells (query
length x subject length), never on the program's padding.
"""

from __future__ import annotations

SMS, LANES, CLOCK_HZ = 132, 64, 1.98e9
INT_OPS_PER_S = SMS * LANES * CLOCK_HZ * 2 * 2  # 6.69e13
HBM_BYTES_PER_S = 3.35e12
OPS_PER_CELL = {"linear": 6, "affine": 11}
PROFILE_COLUMNS = 32  # a query residue's row of substitution scores, one byte each
SCORE_BYTES = 4


def least_seconds(query_length: int, db_residues: int, n_subjects: int, gap_model: str) -> float:
    """The least time one search could take on the card: the larger of its
    operations over the integer peak and its bytes (the database, the
    query's profile and one score a subject, each moved once) over the
    memory rate."""
    ops = OPS_PER_CELL[gap_model] * query_length * db_residues
    nbytes = db_residues + PROFILE_COLUMNS * query_length + SCORE_BYTES * n_subjects
    return max(ops / INT_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
