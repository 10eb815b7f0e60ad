"""The launch shape of the row kernel K2/K3 (``bucket_sw.rows_shape``), its
band carry counted by passes (``bucket_sw.carry_bytes``), and the engine's
chunk budget that follows it (``SearchEngine._fused_step``).

On the CPU the wrappers run their plain versions whatever the shape, so
these tests hold the pure arithmetic of the shape rule, which decides on
the card which instantiation of ``csrc/sw_rows.cu`` a launch runs and how
much scratch it takes.
"""

import numpy as np
import pytest
import torch

from swtpu_torch.config import SWConfig
from swtpu_torch.matrices import blosum50_ref
from swtpu_torch.models import search as tsearch
from swtpu_torch.models.search import SearchEngine
from swtpu_torch.ops import bucket_sw, row_sw, wave_sw
from swtpu_torch.ops.profile import PAD_SUBJECT, make_profile

BAND = (1, bucket_sw.BAND_H)  # the band sweep's shape for several bands


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: intra-op threads only contend with the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize(
    "n_bands,rows,want",
    [
        (1, 1, (1, 32)),  # a single band: the band sweep, one 32-row band
        (1, 10**7, (1, 32)),  # many rows, but a 64-row band would idle half its rows
        (2, 64, (2, 32)),
        (3, 64, (4, 32)),
        (5, 64, (8, 32)),
        (8, 64, (8, 32)),
        (9, 6144, (16, 32)),
        (15, 64, (16, 32)),  # P01008: one pass of 16 bands
        (143, 9, (16, 32)),  # the suite's longest query: nine passes
        (15, bucket_sw.BAND_ROWS - 1, (16, 32)),  # the crossover's last wavefront launch
        (15, bucket_sw.BAND_ROWS, BAND),  # and its first band sweep
        (2, bucket_sw.BAND_ROWS, BAND),
        (143, 5 * 8192 + bucket_sw.BAND_ROWS, BAND),
    ],
)
def test_rows_shape_picks_the_wavefront_below_the_crossover(n_bands, rows, want):
    assert bucket_sw.rows_shape(n_bands, rows) == want


def test_rows_shape_takes_its_crossover_as_an_argument():
    assert bucket_sw.rows_shape(15, 64, band_rows=0) == BAND  # the band sweep everywhere
    assert bucket_sw.rows_shape(15, 10**9, band_rows=10**10) == (16, 32)  # the wavefront everywhere
    assert bucket_sw.rows_shape(1, 64, band_rows=0) == (1, 32)


@pytest.mark.parametrize("band_rows", [0, bucket_sw.BAND_ROWS, 10**10])
def test_every_shape_the_rule_picks_is_compiled(band_rows):
    picked = {bucket_sw.rows_shape(n, rows, band_rows) for n in range(1, 200) for rows in (1, 8192, 10**6)}
    assert picked <= set(bucket_sw.SHAPES)
    assert all(g == 1 or h == bucket_sw.W for g, h in bucket_sw.SHAPES)  # the wavefront's bands are 32 rows


@pytest.mark.parametrize(
    "n_bands,chunks,rows,width,passes",
    [
        (1, 3, 100, 256, 1),
        (15, 5, 64, 640, 1),  # P01008 on a small group: one pass of G = 16, no carry
        (16, 1, 64, 640, 1),
        (17, 1, 64, 640, 2),
        (143, 2, 9, 33, 9),  # 4,548 residues: nine passes of 16 bands
        (15, 1, bucket_sw.BAND_ROWS, 640, 8),  # the band sweep at H = 64: 480 rows in eight bands
        (2, 1, bucket_sw.BAND_ROWS, 640, 1),  # two 32-row bands in one 64-row band
        (1, 1, bucket_sw.BAND_ROWS, 640, 1),
    ],
)
def test_carry_bytes_count_passes(n_bands, chunks, rows, width, passes):
    assert wave_sw.n_passes(n_bands, *bucket_sw.rows_shape(n_bands, chunks * rows)) == passes
    want = 4 * chunks * rows * width if passes > 1 else 0
    assert bucket_sw.carry_bytes(n_bands, chunks, rows, width) == want


def _profile(qlen, seed=0):
    q = np.random.default_rng(seed).integers(0, 25, qlen).astype(np.int8)
    return torch.from_numpy(make_profile(q, blosum50_ref(), pad_rows_to=32))


def _stack(C, B, L, seed=1):
    rng = np.random.default_rng(seed)
    stack = np.full((C, B, L), PAD_SUBJECT, dtype=np.int8)
    for c in range(C):
        for b in range(B):
            n = int(rng.integers(1, L + 1))
            stack[c, b, :n] = rng.integers(0, 25, n)
    return torch.from_numpy(stack)


@pytest.mark.parametrize(
    "qlen,budget,want",
    [
        (464, 1, 5),  # 15 bands, one pass: no carry, so every chunk in one launch whatever the budget
        (544, 1, 1),  # 17 bands, two passes: not even one chunk's carry fits; one a launch
        (544, 2 * 4 * 8 * 40, 2),  # two chunks' carry fits
        (544, 5 * 4 * 8 * 40, 5),
        (4548, None, 5),  # no cap (the CPU)
    ],
)
def test_fused_step_follows_the_carry_by_passes(monkeypatch, qlen, budget, want):
    monkeypatch.setattr(tsearch, "scratch_budget_bytes", lambda device: budget)
    eng = SearchEngine(SWConfig(use_wave=False, use_pallas=True), device="cpu")
    assert eng._fused_step(_profile(qlen), _stack(5, 8, 40)) == want


def test_one_pass_stack_scores_in_one_launch_under_any_budget(monkeypatch):
    """With a budget no carry fits in, a 15-band query's stack still goes to
    K2 whole, and scores as the plain version does."""
    monkeypatch.setattr(tsearch, "scratch_budget_bytes", lambda device: 1)
    calls = []
    real = bucket_sw.sw_score_bucket_fused

    def spy(profile, subjects, **kw):
        calls.append(tuple(subjects.shape))
        return real(profile, subjects, **kw)

    spy.launches = 0
    monkeypatch.setattr(bucket_sw, "sw_score_bucket_fused", spy)
    eng = SearchEngine(SWConfig(use_wave=False, use_pallas=True), device="cpu")
    prof, stack = _profile(464), _stack(5, 8, 40)
    got = eng._fused_stack(prof, stack)
    assert calls == [(5, 8, 40)]
    assert torch.equal(got, row_sw.sw_score_stack(prof, stack, gap=eng.config.gap_penalty, strip=32))
