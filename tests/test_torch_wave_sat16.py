"""The saturation rule of K1's int16x2 kernel, on a plain model of its DP.

The kernel (``csrc/sw_wave.cu``: ``sw_wave16_kernel``, ``sw_band16_kernel``)
keeps H, E and F in int16 and flags an entry whose int16 best passed
``wave_sw.SAT16`` = 32,767 - 127; the wrapper rescores flagged entries in
int32.  The model here is the same recurrence on int16 values, with the
kernel's int16 sentinels (E and F start at -16,384) and its one add that
can wrap, diag + s: every other value stays in [-32,767, 32,767] (H >= 0,
E, F >= -16,384 - ext).  The order of the cells does not change their
values, so the model has no bands, passes or packing; the card tests
(tests/test_torch_gpu.py) hold the kernel itself to the int32 plain version
at every shape.  These cases hold the model to that plain version and to
the scalar oracle: every unflagged entry is exact, and an entry is flagged
exactly when its score is over 32,640.
"""

import numpy as np
import pytest
import torch

from swtpu_torch import synth
from swtpu_torch.alphabet import PADDED_ALPHABET_SIZE as A32
from swtpu_torch.matrices import blosum50_ref
from swtpu_torch.ops import oracle, wave_sw
from swtpu_torch.ops.profile import PAD_SUBJECT, make_profile

NEG16 = -16384


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread a test: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def wrap16(x: torch.Tensor) -> torch.Tensor:
    """int32 values taken modulo 2^16 into [-32768, 32767], as an int16 add wraps."""
    return ((x + 32768) & 0xFFFF) - 32768


def sat16_model(profile: torch.Tensor, subjT: torch.Tensor, n_segs: int, gap=None, gap_open=None, gap_extend=None):
    """(best, flagged) of every (lane, segment), lane-major: the int16 DP's
    running best and whether it passed SAT16."""
    seg_cols = (subjT.shape[0] - wave_sw.W) // n_segs
    B = subjT.shape[1]
    idx = subjT[: n_segs * seg_cols].T.reshape(B * n_segs, seg_cols).long() & (A32 - 1)
    prof = profile.to(torch.int32)
    N, L = idx.shape
    zero = torch.zeros((N, 1), dtype=torch.int32)
    best = torch.zeros(N, dtype=torch.int32)
    h = torch.zeros((N, L), dtype=torch.int32)
    if gap_open is None:
        rebase = torch.arange(L, dtype=torch.int32) * gap
        for i in range(prof.shape[0]):
            diag = torch.cat([zero, h[:, :-1]], dim=1)
            t = torch.maximum(torch.maximum(wrap16(diag + prof[i][idx]), h - gap), torch.zeros_like(h))
            # The left chain max(t[j], H[j-1] - gap) on values in [0, 32767] cannot wrap.
            h = torch.cummax(t + rebase, dim=1).values - rebase
            best = torch.maximum(best, h.amax(dim=1))
    else:
        ramp = torch.arange(L, dtype=torch.int32) * gap_extend
        f = torch.full((N, L), NEG16, dtype=torch.int32)
        for i in range(prof.shape[0]):
            f = torch.maximum(h - gap_open, f - gap_extend)
            diag = torch.cat([zero, h[:, :-1]], dim=1)
            t = torch.maximum(wrap16(diag + prof[i][idx]), f).clamp_min_(0)
            # E from the left boundary's H = 0 (E = NEG16 before it loses to 0 - open).
            u = torch.cummax(torch.cat([zero, t[:, :-1]], dim=1) + ramp, dim=1).values
            h = torch.maximum(t, u - ramp - gap_open)
            best = torch.maximum(best, h.amax(dim=1))
    assert int(h.max()) <= 32767 and int(h.min()) >= 0
    return best, best > wave_sw.SAT16


def _random_bucket(rng, qlen, qpad, ws, S, B):
    q = rng.integers(0, 25, qlen).astype(np.int8)
    prof = make_profile(q, blosum50_ref(), pad_rows_to=qpad)
    subjects = [rng.integers(0, 25, int(rng.integers(1, ws + 1))).astype(np.int8) for _ in range(B * S - 2)]
    stack = np.full((S * ws + 32, B), PAD_SUBJECT, dtype=np.int8)
    for k, s in enumerate(subjects):
        stack[(k % S) * ws : (k % S) * ws + len(s), k // S] = s
    return q, prof, stack, subjects


GAPS = [dict(gap=2), dict(gap_open=10, gap_extend=2), dict(gap=wave_sw.I16_GAP_MAX),
        dict(gap_open=wave_sw.I16_GAP_MAX, gap_extend=wave_sw.I16_GAP_MAX)]
GAP_IDS = ["linear", "affine", "linear-widest", "affine-widest"]


def _check(profile, stack, n_segs, gaps):
    prof, subj = torch.from_numpy(profile), torch.from_numpy(stack)
    exact = wave_sw.sw_wave_plain(prof, subj, n_segs=n_segs, **gaps)
    best, flagged = sat16_model(prof, subj, n_segs, **gaps)
    assert torch.equal(flagged, exact > wave_sw.SAT16)
    assert torch.equal(best[~flagged], exact[~flagged])
    return exact, best, flagged


@pytest.mark.parametrize("gaps", GAPS, ids=GAP_IDS)
@pytest.mark.parametrize("qlen,qpad,ws,S,B", [(40, 64, 96, 1, 16), (70, 96, 48, 3, 8), (600, 608, 40, 2, 6)])
def test_model_exact_on_random_buckets(gaps, qlen, qpad, ws, S, B):
    """Ordinary scores, one band to 19 (past a 16-band pass): nothing flagged,
    every entry exact, and equal to the scalar oracle."""
    rng = np.random.default_rng(qlen + S)
    q, prof, stack, subjects = _random_bucket(rng, qlen, qpad, ws, S, B)
    exact, best, flagged = _check(prof, stack, S, gaps)
    assert not flagged.any()
    mat = blosum50_ref()
    for k, s in enumerate(subjects[:6]):
        want = (oracle.sw_score_scalar(q, s, mat, gaps["gap"]) if "gap" in gaps
                else oracle.sw_affine_score_scalar(q, s, mat, gaps["gap_open"], gaps["gap_extend"]))
        assert int(best[k]) == want


@pytest.mark.parametrize("gaps", GAPS[:2], ids=GAP_IDS[:2])
@pytest.mark.parametrize("n_segs,lanes", [(1, 10), (2, 6)], ids=["unchained", "chained"])
def test_model_flags_every_score_over_the_threshold(gaps, n_segs, lanes):
    """W-run copies at 32,640 (unflagged and exact), just over it, either
    side of 32,767 and at 33,000, unchained and chained beside random
    subjects, on a 2,400-row query (75 bands: five 16-band passes)."""
    profile, stack = synth.saturating_bucket(n_segs + lanes, n_segs=n_segs, lanes=lanes)
    exact, best, flagged = _check(profile, stack, n_segs, gaps)
    scores = set(exact.tolist())
    assert {32640, 32655, 32760, 32775, 33000} <= scores
    assert int(flagged.sum()) == sum(s > wave_sw.SAT16 for s in exact.tolist()) >= 4
    assert not flagged[exact == 32640].any()
    over = exact > 32767
    assert over.any() and flagged[over].all()


@pytest.mark.parametrize("gaps", GAPS[:2], ids=GAP_IDS[:2])
def test_model_on_a_query_stack(gaps):
    """Each query of a stack on its own: the W query and the query ending
    in the W run flag the same copies; the random one flags none."""
    profiles, stack = synth.saturating_bucket(3, n_segs=2, lanes=5, n_queries=3)
    flags = [_check(p, stack, 2, gaps)[2] for p in profiles]
    assert flags[0].any() and not flags[1].any() and torch.equal(flags[0], flags[2])


def test_model_oracle_near_the_threshold():
    """The scalar oracle agrees with the plain version on the threshold's
    neighbours, so the flag rule is checked against independent scores."""
    mat = blosum50_ref()
    w = np.full(2200, 17, dtype=np.int8)
    for k in (2176, 2177):
        s = np.full(k, 17, dtype=np.int8)
        assert oracle.sw_score_diag(w, s, mat, 2) == 15 * k
