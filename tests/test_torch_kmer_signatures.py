"""The prefilter's signature index built on the card
(``ops.prefilter.database_signatures_cuda``, ``csrc/kmer_signatures.cu``).

* Anywhere: the wrapper refuses what its kernel cannot take (tensors off
  the card, other dtypes or ranks, offsets without the n + 1 entries)
  before it builds anything; on the card also offsets that do not bound
  records inside the buffer.
* On the card (marker ``gpu``): the signatures and popcounts equal the
  native host pass's (``native.build_signatures_native``) byte for byte:
  records of length 0 to 2 (zero rows), records at the edges of a warp's
  stride and of a block's eight records, long records, and an index past
  2**31 bytes (2.2 M records, 64-bit byte indices); the
  prefiltered engine on the card builds its index there (the native host
  pass is never called) and answers as on the CPU.
"""

import numpy as np
import pytest
import torch

from swtpu_torch import native
from swtpu_torch.config import SWConfig
from swtpu_torch.io.fasta import Database, Query
from swtpu_torch.models.search import SearchEngine
from swtpu_torch.ops import prefilter as pf


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _database(lengths, seed=0):
    lengths = np.asarray(lengths, dtype=np.int64)
    offsets = np.zeros(lengths.size + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    residues = np.random.default_rng(seed).integers(0, 25, int(offsets[-1])).astype(np.int8)
    return residues, offsets


def _native(residues, offsets):
    sig = native.build_signatures_native(residues, offsets, pf.DIM, pf.K, pf._MIX)
    return sig, sig.sum(axis=1, dtype=np.int32)


BAD = {
    "on the cpu": lambda r, o: dict(residues=r, offsets=o),
    "int32 residues": lambda r, o: dict(residues=r.to(torch.int32), offsets=o),
    "int32 offsets": lambda r, o: dict(residues=r, offsets=o.to(torch.int32)),
    "2-d residues": lambda r, o: dict(residues=r[None], offsets=o),
    "uint8 residues": lambda r, o: dict(residues=r.to(torch.uint8), offsets=o),
    "2-d offsets": lambda r, o: dict(residues=r, offsets=o[None]),
    "no offsets": lambda r, o: dict(residues=r, offsets=o[:0]),
}


@pytest.mark.parametrize("case", list(BAD))
def test_the_wrapper_refuses_what_its_kernel_cannot_take(case):
    residues, offsets = _database([5, 0, 7])
    with pytest.raises(ValueError):
        pf.database_signatures_cuda(**BAD[case](torch.from_numpy(residues), torch.from_numpy(offsets)))


CASES = {
    "short records": [0, 1, 2, 3, 0, 2, 4, 1, 0, 3, 5],
    "a warp's stride": [31, 32, 33, 34, 35, 64, 65, 66, 95, 96, 97, 3],
    "a block's records": list(range(1, 8 * 4 + 2)),  # 33 records: four blocks of 8 and one more
    "long records": [8000, 2, 7999, 40, 5478, 0, 4548],
    "swissprot-like": np.clip(np.random.default_rng(7).lognormal(5.67, 0.62, 5000), 20, 8000).astype(np.int64),
    "empty": [],
    "one empty record": [0],
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CASES))
def test_card_signatures_equal_the_native_host_pass(cuda, case):
    residues, offsets = _database(CASES[case], seed=len(case))
    want_sig, want_pop = _native(residues, offsets)
    sig, pop = pf.database_signatures_cuda(torch.from_numpy(residues).to(cuda), torch.from_numpy(offsets).to(cuda))
    assert sig.shape == want_sig.shape and sig.dtype == torch.int8 and pop.dtype == torch.int32
    assert np.array_equal(sig.cpu().numpy(), want_sig) and np.array_equal(pop.cpu().numpy(), want_pop)


@pytest.mark.gpu
@pytest.mark.parametrize("offsets", [[0, 5, 3, 9], [0, 4, 9, 13], [-1, 4, 9, 12]])
def test_card_signatures_refuse_offsets_outside_the_buffer(cuda, offsets):
    residues = torch.zeros(12, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        pf.database_signatures_cuda(residues, torch.tensor(offsets, dtype=torch.int64, device=cuda))


@pytest.mark.gpu
def test_card_signatures_past_2_31_bytes_equal_the_native_host_pass(cuda):
    n = 2_200_000  # x 1,024 bytes = 2.25 GB: the byte index of the last rows passes 2**31
    lengths = np.random.default_rng(3).integers(0, 48, n)
    lengths[-5:] = [0, 2, 3, 47, 100]
    residues, offsets = _database(lengths, seed=4)
    want_sig, want_pop = _native(residues, offsets)
    sig, pop = pf.database_signatures_cuda(torch.from_numpy(residues).to(cuda), torch.from_numpy(offsets).to(cuda))
    assert sig.shape == (n, pf.DIM) and n * pf.DIM > 2**31
    assert torch.equal(pop.cpu(), torch.from_numpy(want_pop))
    for lo in range(0, n, 1 << 19):  # compared on the card a slab at a time
        hi = min(lo + (1 << 19), n)
        assert torch.equal(sig[lo:hi], torch.from_numpy(want_sig[lo:hi]).to(cuda)), (lo, hi)


@pytest.mark.gpu
def test_the_engine_on_the_card_builds_its_index_there(cuda, monkeypatch):
    rng = np.random.default_rng(12)
    residues, offsets = _database(rng.integers(0, 300, 6000), seed=12)
    db = Database(residues=residues, offsets=offsets)
    queries = [Query(name=str(i), residues=rng.integers(0, 25, L).astype(np.int8), raw="") for i, L in enumerate([90, 250])]
    cfg = SWConfig(matrix="blosum50_ref", gap_open=10, gap_extend=2, top_k=10, evalue=True, prefilter=1e-6,
                   prefilter_min_candidates=300)
    want = [SearchEngine(cfg, device="cpu").search(q, db) for q in queries]

    def native_host_pass(*args, **kw):
        raise AssertionError("the native host pass ran on the card's path")

    monkeypatch.setattr(pf, "database_signatures", native_host_pass)
    engine = SearchEngine(cfg, device=cuda)
    got = [engine.search(q, db) for q in queries]
    sig, pop, _, _ = engine._sig_cache[1]
    assert sig.device.type == "cuda" and pop.device.type == "cuda"
    for g, w in zip(got, want):
        assert [(h.id, h.score) for h in g.top_k_stats(10)] == [(h.id, h.score) for h in w.top_k_stats(10)]
        assert g.metrics.prefilter_candidates == w.metrics.prefilter_candidates
