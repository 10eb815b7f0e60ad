"""Standalone pairwise aligner: the reference's CPU traceback program.

``python -m swtpu_torch.cpu_align <seqA> <seqB>`` reproduces the output of
the reference's ``src/cpu.cpp`` byte for byte, as ``swtpu.cpu_align`` does:
match/mismatch +3/-3 on raw characters (not BLOSUM), linear gap 2, the
traceback from the first maximal cell, then the two gapped strings and the
full scoring matrix with sequence-letter headers.  Host-only: no torch, no
device.

Flags extend it without breaking the positional contract:
  --match/--mismatch/--gap   change the scoring constants,
  --matrix NAME              score with an engine substitution matrix
                             (residues are alphabet-encoded first),
  --no-matrix-dump           skip the O(m*n) matrix print for long inputs.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from .ops.oracle import FROM_LEFT, FROM_TOP, FROM_TOP_LEFT, sw_matrix


def score_matrix_chars(seq_a: str, seq_b: str, match: int, mismatch: int, gap: int):
    """Full DP and direction matrices on raw characters (``oracle.sw_matrix``
    semantics: LEFT, TOP, DIAG with a strictly-greater override)."""
    a = np.frombuffer(seq_a.encode("latin-1"), dtype=np.uint8).astype(np.int64)
    b = np.frombuffer(seq_b.encode("latin-1"), dtype=np.uint8).astype(np.int64)
    # A character-identity matrix over the joint alphabet of the two strings,
    # not a 256 x 256 one.
    uniq, inv = np.unique(np.concatenate([a, b]), return_inverse=True)
    a_idx, b_idx = inv[: len(a)], inv[len(a) :]
    m = np.full((len(uniq), len(uniq)), mismatch, dtype=np.int64)
    np.fill_diagonal(m, match)
    return sw_matrix(a_idx, b_idx, m, gap)


def traceback_chars(seq_a: str, seq_b: str, H: np.ndarray, TB: np.ndarray):
    """Walk back from the first maximal cell (row-major) until a cell of 0;
    returns the two gapped strings and the end cell."""
    i, j = divmod(int(np.argmax(H)), H.shape[1])
    out_a, out_b = [], []
    ti, tj = i, j
    while H[ti, tj] != 0:
        d = TB[ti, tj]
        if d == FROM_LEFT:
            tj -= 1
            out_a.append("-")
            out_b.append(seq_b[tj])
        elif d == FROM_TOP:
            ti -= 1
            out_a.append(seq_a[ti])
            out_b.append("-")
        elif d == FROM_TOP_LEFT:
            ti -= 1
            tj -= 1
            out_a.append(seq_a[ti])
            out_b.append(seq_b[tj])
        else:
            break
    return "".join(reversed(out_a)), "".join(reversed(out_b)), (i, j)


def format_matrix(seq_a: str, seq_b: str, H: np.ndarray) -> str:
    """The reference's matrix dump, every line with a trailing space.

    Its column-header loop runs to len(seq_b) + 1 inclusive and so prints
    the string's terminating NUL byte in the last slot; so does this.
    """
    lines = ["    " + "".join(c + " " for c in seq_b) + "\x00 "]
    for i in range(H.shape[0]):
        prefix = "  " if i == 0 else seq_a[i - 1] + " "
        lines.append(prefix + " ".join(str(int(v)) for v in H[i]) + " ")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="swtpu_torch.cpu_align", description="pairwise local aligner (cpu.cpp parity)")
    p.add_argument("seq_a")
    p.add_argument("seq_b")
    p.add_argument("--match", type=int, default=3, help="match score (cpu.cpp SEQ_EQUAL)")
    p.add_argument("--mismatch", type=int, default=-3, help="mismatch score (cpu.cpp SEQ_DIFF)")
    p.add_argument("--gap", type=int, default=2, help="linear gap penalty")
    p.add_argument("--matrix", default=None, help="use an engine substitution matrix instead")
    p.add_argument("--no-matrix-dump", action="store_true")
    args = p.parse_args(argv)

    if args.matrix:
        from .alphabet import encode_str
        from .matrices import get_matrix

        H, TB = sw_matrix(encode_str(args.seq_a), encode_str(args.seq_b), get_matrix(args.matrix), args.gap)
    else:
        H, TB = score_matrix_chars(args.seq_a, args.seq_b, args.match, args.mismatch, args.gap)

    aligned_a, aligned_b, _ = traceback_chars(args.seq_a, args.seq_b, H, TB)
    print(aligned_a)
    print(aligned_b)
    if not args.no_matrix_dump:
        print(format_matrix(args.seq_a, args.seq_b, H))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
