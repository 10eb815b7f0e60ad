"""The port's pairwise aligner and its oracle functions against swtpu's.

``swtpu_torch.cpu_align.main`` and ``swtpu.cpu_align.main`` run in-process
on the same arguments and must print the same bytes: the six fixed pairs of
``tests/test_cpu_cpp_differential.py`` and 50 seeded random DNA and protein
pairs of length 1-120, under every flag (the defaults, other scoring
constants, an engine matrix, no matrix dump), plus non-ASCII latin-1
characters.  ``sw_score_scalar``, ``sw_matrix``, ``sw_traceback`` and
``sw_score_many`` of ``swtpu_torch.ops.oracle`` equal swtpu's exactly.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from swtpu import cpu_align as ref_align
from swtpu.ops import oracle as ref_oracle
from swtpu_torch import cpu_align
from swtpu_torch.matrices import blosum50_ref
from swtpu_torch.ops import oracle

FIXED = [("GGTTGACTA", "TGTTACGG"), ("A", "A"), ("A", "T"), ("ACGT", "TGCA"), ("AAAA", "AAAA"), ("ACACACTA", "AGCACACA")]
FLAGS = {
    "defaults": [],
    "scoring": ["--match", "5", "--mismatch", "-4", "--gap", "3"],
    "matrix": ["--matrix", "blosum50"],
    "matrix_ref": ["--matrix", "blosum50_ref", "--gap", "1"],
    "no_dump": ["--no-matrix-dump", "--gap", "1"],
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stdout(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def _random_pairs(n=50, seed=0):
    rng = np.random.default_rng(seed)
    dna, protein = np.array(list("ACGT")), np.array(list("ARNDCQEGHILKMFPSTWYVBJZX"))
    for i in range(n):
        alpha = dna if i % 2 == 0 else protein
        yield ("".join(rng.choice(alpha, int(rng.integers(1, 121)))), "".join(rng.choice(alpha, int(rng.integers(1, 121)))))


@pytest.mark.parametrize("flag", list(FLAGS))
def test_fixed_pairs_byte_identical(flag):
    for a, b in FIXED:
        assert _stdout(cpu_align.main, [a, b, *FLAGS[flag]]) == _stdout(ref_align.main, [a, b, *FLAGS[flag]])


@pytest.mark.parametrize("flag", list(FLAGS))
def test_random_pairs_byte_identical(flag):
    for i, (a, b) in enumerate(_random_pairs()):
        ours, theirs = _stdout(cpu_align.main, [a, b, *FLAGS[flag]]), _stdout(ref_align.main, [a, b, *FLAGS[flag]])
        assert ours == theirs, f"pair {i}: {a!r} vs {b!r}"


def test_matrix_dump_quirks_and_latin1():
    """The header's NUL slot and the trailing spaces of the dump, and
    characters outside ASCII remapped through latin-1, as swtpu prints them."""
    out = _stdout(cpu_align.main, ["GATTACA", "GCATGCU"])
    header = out.splitlines()[2]
    assert header.endswith("U \x00 ") and all(line.endswith(" ") for line in out.splitlines()[2:])
    for a, b in (("ÉCOLÉ", "ÉCOLE"), ("ñAñA", "AñA")):
        assert _stdout(cpu_align.main, [a, b]) == _stdout(ref_align.main, [a, b])


def test_oracle_functions_equal_swtpu():
    rng = np.random.default_rng(7)
    mat = blosum50_ref()
    for k in range(12):
        q = rng.integers(0, 25, int(rng.integers(1, 40))).astype(np.int8)
        s = rng.integers(0, 25, int(rng.integers(0, 40))).astype(np.int8)
        gap = int(rng.integers(0, 6))
        assert oracle.sw_score_scalar(q, s, mat, gap) == ref_oracle.sw_score_scalar(q, s, mat, gap)
        H, TB = oracle.sw_matrix(q, s, mat, gap)
        rH, rTB = ref_oracle.sw_matrix(q, s, mat, gap)
        assert np.array_equal(H, rH) and np.array_equal(TB, rTB) and H.dtype == rH.dtype and TB.dtype == rTB.dtype
        assert oracle.sw_score_scalar(q, s, mat, gap) == int(H.max()) == oracle.sw_score_diag(q, s, mat, gap)
    letters = np.array(list("ARNDCQEGHILKMFPSTWYVBJZX*"))
    for k in range(8):
        a = "".join(rng.choice(letters, int(rng.integers(1, 50))))
        b = "".join(rng.choice(letters, int(rng.integers(1, 50))))
        assert oracle.sw_traceback(a, b, mat, 2) == ref_oracle.sw_traceback(a, b, mat, 2)
    subjects = [rng.integers(0, 25, int(n)).astype(np.int8) for n in rng.integers(0, 60, 9)]
    got = oracle.sw_score_many(q, subjects, mat, 2)
    want = ref_oracle.sw_score_many(q, subjects, mat, 2)
    assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
