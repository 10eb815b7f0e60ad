"""swtpu_torch.ops.wave_sw against swtpu's wavefront kernel and the oracle.

On the CPU the port's ``sw_wave`` runs its plain PyTorch version; these
cases hold it, exactly, to swtpu's Pallas kernel in interpret mode (at the
small shapes swtpu's own tests use, one query and a query axis) and to the
scalar oracle.  The CUDA
kernel itself is held to the plain version on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.matrices import blosum50_ref
from swtpu.ops import oracle
from swtpu.ops import wave_sw as jwave
from swtpu.ops import xla_sw
from swtpu_torch.ops import profile as tprofile
from swtpu_torch.ops import wave_sw

GAP = 2
MAT = blosum50_ref()


def _bucket(rng, qlen, qpad, ws, S, B, exact_fill=False, n_pad_slots=2):
    """Random query profile and chained (S*ws + 32, B) bucket; the last
    ``n_pad_slots`` flat slots are left empty."""
    q = rng.integers(0, 25, qlen).astype(np.int8)
    prof = xla_sw.make_profile(q, MAT, pad_rows_to=qpad)
    n_subj = B * S - n_pad_slots
    lens = np.full(n_subj, ws) if exact_fill else rng.integers(1, ws + 1, n_subj)
    subjects = [rng.integers(0, 25, l).astype(np.int8) for l in lens]
    stack = np.full((S * ws + 32, B), xla_sw.PAD_SUBJECT, dtype=np.int8)
    for k, s in enumerate(subjects):
        stack[(k % S) * ws : (k % S) * ws + len(s), k // S] = s
    return q, prof, stack, subjects


def _port(prof, stack, S):
    out = wave_sw.sw_wave(torch.from_numpy(prof), torch.from_numpy(stack), gap=GAP, n_segs=S)
    assert out.dtype == torch.int32 and out.shape == (stack.shape[1] * S,)
    return out.numpy()


@pytest.mark.parametrize(
    "qlen,qpad,ws,S,B,Lc,exact_fill",
    [
        (40, 64, 96, 1, 16, 64, False),  # two bands, unchained
        (33, 64, 48, 2, 8, 32, True),  # separator column is a real cell
        (40, 64, 32, 3, 8, 32, False),  # two separators, pad segments
    ],
)
def test_sw_wave_matches_swtpu_interpret(qlen, qpad, ws, S, B, Lc, exact_fill):
    rng = np.random.default_rng(qlen * 10 + S)
    q, prof, stack, subjects = _bucket(rng, qlen, qpad, ws, S, B, exact_fill)
    expect = np.asarray(
        jwave.sw_wave(
            jnp.asarray(jwave.build_lhs_banded(prof)), jnp.asarray(stack),
            gap=GAP, Lc=Lc, Bt=8, n_segs=S, interpret=True,
        )
    )
    got = _port(prof, stack, S)
    assert np.array_equal(got, expect)
    for k, s in enumerate(subjects):
        assert got[k] == oracle.sw_score_scalar(q, s, MAT, GAP)
    assert (got[len(subjects):] == 0).all(), "pad segments must score 0"


@pytest.mark.parametrize(
    "qlens,qpad,ws,S,B,Lc",
    [
        ((40, 55, 64), 64, 96, 1, 16, 64),  # two bands, unchained
        ((20, 31), 32, 48, 2, 8, 32),  # one band, chained
        ((70, 90, 96, 65), 96, 32, 3, 8, 32),  # three bands, chained
    ],
)
def test_sw_wave_query_axis_matches_swtpu_interpret(qlens, qpad, ws, S, B, Lc):
    """A (Q, qpad, 32) profile stack against swtpu's 4-D lhsB launch."""
    rng = np.random.default_rng(sum(qlens) + S)
    _, _, stack, subjects = _bucket(rng, qlens[0], qpad, ws, S, B)
    queries = [rng.integers(0, 25, n).astype(np.int8) for n in qlens]
    profs = np.stack([xla_sw.make_profile(q, MAT, pad_rows_to=qpad) for q in queries])
    expect = np.asarray(
        jwave.sw_wave(
            jnp.asarray(np.stack([jwave.build_lhs_banded(p) for p in profs])), jnp.asarray(stack),
            gap=GAP, Lc=Lc, Bt=8, n_segs=S, interpret=True,
        )
    )
    got = wave_sw.sw_wave(torch.from_numpy(profs), torch.from_numpy(stack), gap=GAP, n_segs=S)
    assert got.dtype == torch.int32 and got.shape == (len(qlens), B * S)
    assert np.array_equal(got.numpy(), expect)
    for row, p in enumerate(profs):  # each row is that query's single launch
        assert np.array_equal(got[row].numpy(), _port(p, stack, S))
    k = int(rng.integers(len(subjects)))
    assert got[-1, k] == oracle.sw_score_scalar(queries[-1], subjects[k], MAT, GAP)


@pytest.mark.parametrize(
    "qlen,qpad,ws,S,B,exact_fill",
    [
        (20, 32, 64, 1, 6, False),  # one band
        (70, 96, 40, 2, 5, False),  # three bands
        (45, 64, 24, 3, 4, True),
        (31, 32, 17, 8, 3, False),  # widest chain factor
        (90, 96, 33, 8, 2, True),
    ],
)
def test_sw_wave_matches_oracle(qlen, qpad, ws, S, B, exact_fill):
    rng = np.random.default_rng(1000 + qlen)
    q, prof, stack, subjects = _bucket(rng, qlen, qpad, ws, S, B, exact_fill, n_pad_slots=1)
    got = _port(prof, stack, S)
    expect = [oracle.sw_score_scalar(q, s, MAT, GAP) for s in subjects] + [0]
    assert got.tolist() == expect


def test_sw_wave_plain_keeps_all_pad_rows_when_pads_score():
    # With a profile whose pad column scores positive, all-pad rows are real
    # work: the plain version must not drop them.
    prof = np.full((32, 32), 3, dtype=np.int8)
    stack = np.full((40, 2), tprofile.PAD_SUBJECT, dtype=np.int8)
    got = _port(prof, stack, 1)
    # 32 rows x 8 columns of +3: the best local alignment is the diagonal
    assert got.tolist() == [24, 24]


def test_sw_wave_cpu_never_launches_the_kernel():
    rng = np.random.default_rng(3)
    _, prof, stack, _ = _bucket(rng, 10, 32, 16, 2, 4)
    before = (wave_sw.sw_wave.launches, wave_sw.sw_wave.multi_launches)
    _port(prof, stack, 2)
    wave_sw.sw_wave(torch.from_numpy(np.stack([prof, prof])), torch.from_numpy(stack), gap=GAP, n_segs=2)
    assert (wave_sw.sw_wave.launches, wave_sw.sw_wave.multi_launches) == before


@pytest.mark.parametrize(
    "prof_shape,prof_dtype,stack_shape,n_segs,match",
    [
        ((30, 32), torch.int8, (64, 4), 1, "multiple"),
        ((32, 25), torch.int8, (64, 4), 1, "profile"),
        ((32, 32), torch.int32, (64, 4), 1, "profile"),
        ((32, 32), torch.int8, (64, 4), 3, "n_segs"),
        ((32, 32), torch.int8, (32, 4), 1, "n_segs"),
        ((0, 32, 32), torch.int8, (64, 4), 1, "at least one query"),
        ((2, 40, 32), torch.int8, (64, 4), 1, "multiple"),
        ((2, 1, 32, 32), torch.int8, (64, 4), 1, "profile"),
    ],
)
def test_sw_wave_rejects_bad_inputs(prof_shape, prof_dtype, stack_shape, n_segs, match):
    prof = torch.zeros(prof_shape, dtype=prof_dtype)
    stack = torch.full(stack_shape, tprofile.PAD_SUBJECT, dtype=torch.int8)
    with pytest.raises(ValueError, match=match):
        wave_sw.sw_wave(prof, stack, gap=GAP, n_segs=n_segs)


def test_make_profile_matches_swtpu():
    rng = np.random.default_rng(4)
    for qlen, pad in ((1, 32), (33, 32), (100, 64)):
        q = rng.integers(0, 25, qlen).astype(np.int8)
        assert np.array_equal(
            tprofile.make_profile(q, MAT, pad_rows_to=pad), xla_sw.make_profile(q, MAT, pad_rows_to=pad)
        )
    assert (tprofile.PAD_SUBJECT, tprofile.PAD_SCORE) == (xla_sw.PAD_SUBJECT, xla_sw.PAD_SCORE)


def test_layout_parameters_match_swtpu():
    assert wave_sw.W == jwave.W
    assert wave_sw.LC_LADDER == jwave.LC_LADDER
    assert wave_sw.BT_SPEED == jwave.BT_SPEED
    for n in (1, 100, 128, 700, 5000, 40448, 70266):
        assert wave_sw.pick_lanes(n) == jwave.pick_lanes(n)
        assert wave_sw.pick_lc(n) == jwave.pick_lc(n)
        assert wave_sw.has_lc(n) == jwave.has_lc(n)
    for n in (128, 384, 512, 1536):
        assert wave_sw.pick_bt_div(n) == jwave.pick_bt_div(n)
