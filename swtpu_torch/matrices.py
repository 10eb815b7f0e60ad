"""Substitution matrices (copy of ``swtpu.matrices``).

The canonical BLOSUM50 (public NCBI data) is stored once in matrix-text form.
``blosum50()`` is the standard table (``*`` scores -5, +1 against itself);
``blosum50_ref()``, the default, zeroes the ``*`` row and column like the
reference CUDA program's production table.  ``match_mismatch`` is the +3/-3
scoring of the reference's CPU aligner.  A name containing ``/`` or ending in
``.txt``/``.mat`` loads an NCBI-format matrix file.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

from .alphabet import ALPHABET, ALPHABET_SIZE, STAR

_BLOSUM50_TEXT = """
   A  R  N  D  C  Q  E  G  H  I  L  K  M  F  P  S  T  W  Y  V  B  J  Z  X
A  5 -2 -1 -2 -1 -1 -1  0 -2 -1 -2 -1 -1 -3 -1  1  0 -3 -2  0 -2 -2 -1 -1
R -2  7 -1 -2 -4  1  0 -3  0 -4 -3  3 -2 -3 -3 -1 -1 -3 -1 -3 -1 -3  0 -1
N -1 -1  7  2 -2  0  0  0  1 -3 -4  0 -2 -4 -2  1  0 -4 -2 -3  5 -4  0 -1
D -2 -2  2  8 -4  0  2 -1 -1 -4 -4 -1 -4 -5 -1  0 -1 -5 -3 -4  6 -4  1 -1
C -1 -4 -2 -4 13 -3 -3 -3 -3 -2 -2 -3 -2 -2 -4 -1 -1 -5 -3 -1 -3 -2 -3 -1
Q -1  1  0  0 -3  7  2 -2  1 -3 -2  2  0 -4 -1  0 -1 -1 -1 -3  0 -3  4 -1
E -1  0  0  2 -3  2  6 -3  0 -4 -3  1 -2 -3 -1 -1 -1 -3 -2 -3  1 -3  5 -1
G  0 -3  0 -1 -3 -2 -3  8 -2 -4 -4 -2 -3 -4 -2  0 -2 -3 -3 -4 -1 -4 -2 -1
H -2  0  1 -1 -3  1  0 -2 10 -4 -3  0 -1 -1 -2 -1 -2 -3  2 -4  0 -3  0 -1
I -1 -4 -3 -4 -2 -3 -4 -4 -4  5  2 -3  2  0 -3 -3 -1 -3 -1  4 -4  4 -3 -1
L -2 -3 -4 -4 -2 -2 -3 -4 -3  2  5 -3  3  1 -4 -3 -1 -2 -1  1 -4  4 -3 -1
K -1  3  0 -1 -3  2  1 -2  0 -3 -3  6 -2 -4 -1  0 -1 -3 -2 -3  0 -3  1 -1
M -1 -2 -2 -4 -2  0 -2 -3 -1  2  3 -2  7  0 -3 -2 -1 -1  0  1 -3  2 -1 -1
F -3 -3 -4 -5 -2 -4 -3 -4 -1  0  1 -4  0  8 -4 -3 -2  1  4 -1 -4  1 -4 -1
P -1 -3 -2 -1 -4 -1 -1 -2 -2 -3 -4 -1 -3 -4 10 -1 -1 -4 -3 -3 -2 -3 -1 -1
S  1 -1  1  0 -1  0 -1  0 -1 -3 -3  0 -2 -3 -1  5  2 -4 -2 -2  0 -3  0 -1
T  0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  2  5 -3 -2  0  0 -1 -1 -1
W -3 -3 -4 -5 -5 -1 -3 -3 -3 -3 -2 -3 -1  1 -4 -4 -3 15  2 -3 -5 -2 -2 -1
Y -2 -1 -2 -3 -3 -1 -2 -3  2 -1 -1 -2  0  4 -3 -2 -2  2  8 -1 -3 -1 -2 -1
V  0 -3 -3 -4 -1 -3 -3 -4 -4  4  1 -3  1 -1 -3 -2  0 -3 -1  5 -3  2 -3 -1
B -2 -1  5  6 -3  0  1 -1  0 -4 -4  0 -3 -4 -2  0  0 -5 -3 -3  6 -4  1 -1
J -2 -3 -4 -4 -2 -3 -3 -4 -3  4  4 -3  2  1 -3 -3 -1 -2 -1  2 -4  4 -3 -1
Z -1  0  0  1 -3  4  5 -2  0 -3 -3  1 -1 -4 -1  0 -1 -2 -2 -3  1 -3  5 -1
X -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1 -1
"""

_STAR_SCORE = -5  # standard '*' vs anything
_STAR_SELF = 1  # standard '*' vs '*'


def _parse_matrix_text(text: str) -> np.ndarray:
    lines = [ln for ln in text.strip().splitlines() if ln.strip()]
    header = lines[0].split()
    out = np.zeros((len(header), len(header)), dtype=np.int32)
    for i, ln in enumerate(lines[1:]):
        out[i] = [int(v) for v in ln.split()[1:]]
    return out


def blosum50() -> np.ndarray:
    """Standard BLOSUM50, 25x25 int32, engine alphabet order ('*' = -5/+1)."""
    core = _parse_matrix_text(_BLOSUM50_TEXT)
    full = np.full((ALPHABET_SIZE, ALPHABET_SIZE), _STAR_SCORE, dtype=np.int32)
    full[: ALPHABET_SIZE - 1, : ALPHABET_SIZE - 1] = core
    full[STAR, STAR] = _STAR_SELF
    return full


def blosum50_ref() -> np.ndarray:
    """BLOSUM50 with the '*' row/col zeroed (pad-neutral reference variant)."""
    full = blosum50()
    full[STAR, :] = 0
    full[:, STAR] = 0
    return full


def match_mismatch(match: int = 3, mismatch: int = -3) -> np.ndarray:
    """Uniform match/mismatch matrix over all 25 symbols."""
    m = np.full((ALPHABET_SIZE, ALPHABET_SIZE), mismatch, dtype=np.int32)
    np.fill_diagonal(m, match)
    return m


_REGISTRY = {
    "blosum50": blosum50,
    "blosum50_ref": blosum50_ref,
    "match_mismatch": match_mismatch,
}


def load_matrix_file(path) -> np.ndarray:
    """Load an NCBI-format substitution matrix text file.

    '#' comment lines, a header row of residue letters, then one labelled row
    per letter.  Letters outside the 25-letter alphabet are skipped with a
    warning; pairs the file does not list take the file's minimum score.
    """
    with open(os.fspath(path)) as fh:
        text = fh.read()
    lines = [ln for ln in text.splitlines() if ln.strip() and not ln.lstrip().startswith("#")]
    header = lines[0].split()
    idx = {c: i for i, c in enumerate(ALPHABET)}
    unknown = [c for c in header if c not in idx]
    if unknown:
        warnings.warn(
            f"matrix file letters {unknown} are outside the engine's 25-letter "
            f"alphabet and were skipped"
        )
    rows = {}
    for ln in lines[1:]:
        parts = ln.split()
        if parts[0] not in set(header) or len(parts) != len(header) + 1:
            raise ValueError(f"malformed matrix row: {ln!r}")
        rows[parts[0]] = [int(v) for v in parts[1:]]
    if set(rows) != set(header):
        raise ValueError("matrix file rows and header letters disagree")
    keep = [i for i, c in enumerate(header) if c in idx]
    header = [header[i] for i in keep]
    if not header:
        raise ValueError("matrix file has no letters from the engine alphabet")
    vals = np.array([rows[r] for r in header], dtype=np.int32)[:, keep]
    if not np.array_equal(vals, vals.T):
        raise ValueError("substitution matrix must be symmetric")
    full = np.full((ALPHABET_SIZE, ALPHABET_SIZE), int(vals.min()), dtype=np.int32)
    for a, ra in enumerate(header):
        for b, rb in enumerate(header):
            full[idx[ra], idx[rb]] = vals[a, b]
    return full


def get_matrix(name: str) -> np.ndarray:
    """Look up a substitution matrix by name, or load a matrix text file."""
    if "/" in name or name.endswith((".txt", ".mat")):
        return load_matrix_file(name)
    try:
        return _REGISTRY[name]()
    except KeyError:
        raise KeyError(f"unknown substitution matrix {name!r}; available: {sorted(_REGISTRY)}") from None
