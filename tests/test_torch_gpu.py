"""CUDA kernel and engine on the card (marker ``gpu``).

These tests need an NVIDIA GPU with nvcc; elsewhere the ``cuda`` fixture
skips them.  The kernel is held exactly to its plain PyTorch version on the
same card, and the engine to the committed goldens.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from swtpu_torch import synth
from swtpu_torch.config import SWConfig
from swtpu_torch.io.fasta import Query, parse_database, parse_query
from swtpu_torch.matrices import blosum50_ref
from swtpu_torch.models.search import SearchEngine
from swtpu_torch.ops import wave_sw
from swtpu_torch.ops.profile import PAD_SUBJECT, make_profile

DATA = Path(__file__).resolve().parent / "data"
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bucket(rng, qlen, ws, S, B):
    prof = make_profile(rng.integers(0, 25, qlen).astype(np.int8), blosum50_ref(), pad_rows_to=32)
    stack = np.full((S * ws + 32, B), PAD_SUBJECT, dtype=np.int8)
    for k in range(B * S - 1):
        n = int(rng.integers(1, ws + 1))
        stack[(k % S) * ws : (k % S) * ws + n, k // S] = rng.integers(0, 25, n)
    return torch.from_numpy(prof), torch.from_numpy(stack)


@pytest.mark.parametrize(
    "qlen,ws,S,B",
    [(20, 32, 1, 64), (100, 200, 1, 130), (33, 48, 2, 77), (464, 96, 3, 1000), (64, 40, 8, 129), (300, 4100, 1, 65)],
)
def test_kernel_matches_plain(cuda, qlen, ws, S, B):
    prof, stack = _bucket(np.random.default_rng(qlen + S), qlen, ws, S, B)
    prof, stack = prof.to(cuda), stack.to(cuda)
    before = wave_sw.sw_wave.launches
    got = wave_sw.sw_wave(prof, stack, gap=2, n_segs=S)
    torch.cuda.synchronize()
    assert wave_sw.sw_wave.launches == before + 1
    want = wave_sw.sw_wave_plain(prof, stack, gap=2, n_segs=S)
    assert torch.equal(got, want)


@pytest.mark.parametrize("query", ["P02232", "P01008", "P05013"])
def test_engine_subset_goldens_on_card(cuda, query):
    eng = SearchEngine(SWConfig(), device=cuda)
    db = parse_database(DATA / "uniprot_subset.fasta")
    res = eng.search(parse_query(DATA / "queries" / f"{query}.fasta"), db)
    golden = np.loadtxt(DATA / f"golden_{query}_subset.txt", dtype=np.int64)
    assert np.array_equal(res.scores, golden)
    assert res.metrics.kernel_launches == len(eng._resident_packed(db).wave_groups)


def test_engine_sat_golden_on_card(cuda):
    query, seqs = synth.synth_sat_case()
    res = SearchEngine(device=cuda).search(Query("sat", query, ""), synth.database_from_arrays(seqs))
    assert np.array_equal(res.scores, np.loadtxt(DATA / "golden_sat_case.txt", dtype=np.int64))
