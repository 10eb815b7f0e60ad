"""swtpu_torch.ops.row_sw and ops.bucket_sw against swtpu's row scorers.

Every scorer of ``row_sw`` takes the same inputs as its twin in
``swtpu.ops.xla_sw`` (seeded buckets made with numpy, handed to both) and
must give the same integers, exactly: the int32 scorer, the explicit-carry
row step, fast16 (with and without int8 staging), the int16 parity scorer
sat16, segment-packed seg16, the three stack variants and the ragged
convenience.  The saturating cases use a matrix whose diagonal scores 100,
so a short self-alignment passes each ceiling.  On the CPU the wrappers of
the CUDA kernels K2 and K3 (``bucket_sw``) run their plain versions; they
are held to swtpu's Pallas kernels in interpret mode, at tiny shapes only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.ops import pallas_sw
from swtpu.ops import xla_sw
from swtpu_torch.io.fasta import Database
from swtpu_torch.matrices import blosum50_ref
from swtpu_torch.ops import bucket_sw, row_sw
from swtpu_torch.ops.profile import PAD_SUBJECT, make_profile
from swtpu_torch.utils import segpack


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads gain nothing here, and next
    to other test workers on the same cores they only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hot_matrix():
    """A matrix whose diagonal scores 100: short self-alignments saturate."""
    m = np.full((25, 25), -4, dtype=np.int8)
    np.fill_diagonal(m, 100)
    return m


def _bucket(rng, B, L, min_len=1):
    out = np.full((B, L), PAD_SUBJECT, dtype=np.int8)
    for b in range(B):
        n = int(rng.integers(min_len, L + 1))
        out[b, :n] = rng.integers(0, 25, n)
    return out


def _case(seed, qlen, B, L, strip=16, matrix=None):
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 25, qlen).astype(np.int8)
    prof = make_profile(q, blosum50_ref() if matrix is None else matrix, pad_rows_to=strip)
    return q, prof, _bucket(rng, B, L)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _j(x):
    return jnp.asarray(np.asarray(x))


def test_constants_match_swtpu():
    assert row_sw.SAT16_MAX == xla_sw.SAT16_MAX and row_sw._PROFILE_MAX == xla_sw._PROFILE_MAX
    for gap, width in ((1, 128), (2, 512), (11, 4096), (3, 20000)):
        assert row_sw.fast16_sat(gap, width) == xla_sw.fast16_sat(gap, width)


@pytest.mark.parametrize("gap", [1, 2, 11])
def test_sw_score_bucket_matches_xla(gap):
    _, prof, subj = _case(gap, 27, 9, 40)
    got = row_sw.sw_score_bucket(_t(prof), _t(subj), gap=gap, strip=16)
    want = np.asarray(xla_sw.sw_score_bucket(_j(prof), _j(subj), gap=gap, strip=16))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_sw_score_rows_matches_xla_from_a_carry():
    _, prof, subj = _case(4, 20, 6, 33)
    rng = np.random.default_rng(5)
    u = (np.arange(33) * 2)[None, :] + rng.integers(0, 40, (6, 33))
    bestu = np.maximum(u, (np.arange(33) * 2)[None, :] + rng.integers(0, 60, (6, 33)))
    u, bestu = u.astype(np.int32), bestu.astype(np.int32)
    got = row_sw.sw_score_rows(_t(prof), _t(subj), _t(u), _t(bestu), gap=2, strip=16)
    want = xla_sw.sw_score_rows(_j(prof), _j(subj), _j(u), _j(bestu), gap=2, strip=16)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("stage_int8", [False, True])
@pytest.mark.parametrize("saturating", [False, True], ids=["exact", "saturating"])
def test_fast16_matches_xla(stage_int8, saturating):
    _, prof, subj = _case(7, 30, 8, 48, matrix=_hot_matrix() if saturating else None)
    if saturating:  # copy the query into two rows: their scores pass the clamp
        subj[:2, :30] = np.nonzero(prof[:30] == 100)[1]
    sat = 300 if saturating else row_sw.fast16_sat(2, 48)
    got = row_sw.sw_score_bucket_fast16(_t(prof), _t(subj), gap=2, strip=16, sat=sat, stage_int8=stage_int8)
    want = np.asarray(xla_sw.sw_score_bucket_fast16(_j(prof), _j(subj), gap=2, strip=16, sat=sat, stage_int8=stage_int8))
    assert np.array_equal(got.numpy(), want)
    assert (want >= sat).any() == saturating


def test_fast16_refuses_a_ceiling_above_int16():
    _, prof, subj = _case(8, 10, 2, 16)
    with pytest.raises(ValueError, match="too large"):
        row_sw.sw_score_bucket_fast16(_t(prof), _t(subj), gap=2, strip=16, sat=row_sw.fast16_sat(2, 16) + 1)


@pytest.mark.parametrize("saturating", [False, True], ids=["exact", "saturating"])
def test_sat16_matches_xla(saturating):
    if saturating:  # a 340-residue self-alignment at 100 a residue passes 32767
        q, prof, subj = _case(9, 340, 3, 352, strip=32, matrix=_hot_matrix())
        subj[1, :340] = q
    else:
        q, prof, subj = _case(9, 40, 5, 64, strip=32)
    got = row_sw.sw_score_bucket_sat16(_t(prof), _t(subj), gap=2, strip=32)
    want = np.asarray(xla_sw.sw_score_bucket_sat16(_j(prof), _j(subj), gap=2, strip=32))
    assert np.array_equal(got.numpy(), want)
    assert (want == row_sw.SAT16_MAX).any() == saturating


def _seg_inputs(seed, gap, s_max, width, matrix=None, plant=False):
    """A query, its profile and one segment-packed batch of random subjects
    (with ``plant``, two of them copies of the query)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 25, 90).astype(np.int8)
    lens = rng.integers(5, 60, 40)
    seqs = [rng.integers(0, 25, int(n)).astype(np.int8) for n in lens]
    if plant:
        seqs[3], seqs[17] = q.copy(), q[:85].copy()
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    db = Database(residues=np.concatenate(seqs), offsets=offsets)
    batch = segpack.plan_segments(db.lengths, np.arange(db.n), width=width, s_max=s_max, batch_rows=64)[0]
    sat = segpack.seg16_sat(gap, width, s_max)
    prof = make_profile(q, blosum50_ref() if matrix is None else matrix, pad_rows_to=32)
    return db, batch, sat, prof, segpack.pack_segments(db, batch), segpack.build_rebase(batch, gap, sat)


@pytest.mark.parametrize("stage_int8", [False, True])
@pytest.mark.parametrize("saturating", [False, True], ids=["exact", "saturating"])
def test_seg16_matches_xla_and_exact_scores(stage_int8, saturating):
    gap = 2
    db, batch, sat, prof, subj, reb = _seg_inputs(
        11, gap, 4, 128, matrix=_hot_matrix() if saturating else None, plant=saturating
    )
    got = row_sw.sw_score_bucket_seg16(
        _t(prof), _t(subj), _t(reb), _t(batch.ends), gap=gap, strip=32, sat=sat, stage_int8=stage_int8
    )
    want = np.asarray(xla_sw.sw_score_bucket_seg16(
        _j(prof), _j(subj), _j(reb), _j(batch.ends), gap=gap, strip=32, sat=sat, stage_int8=stage_int8
    ))
    assert np.array_equal(got.numpy(), want)
    ids, vals = segpack.extract_scores(batch, got.numpy(), sat)
    subjects = [db.sequence(int(i)) for i in ids]
    width = max(len(s) for s in subjects)
    padded = np.full((len(subjects), width), PAD_SUBJECT, np.int8)
    for k, s in enumerate(subjects):
        padded[k, : len(s)] = s
    exact = row_sw.sw_score_bucket(_t(prof), _t(padded), gap=gap, strip=32).numpy()
    below = vals < sat
    assert np.array_equal(vals[below], exact[below])  # exact below the ceiling
    assert (exact[~below] >= sat).all() and (~below).any() == saturating


def test_stack_variants_match_xla():
    rng = np.random.default_rng(12)
    _, prof, _ = _case(12, 25, 1, 8)
    stack = np.stack([_bucket(rng, 6, 40) for _ in range(3)])
    got = row_sw.sw_score_stack(_t(prof), _t(stack), gap=2, strip=16)
    assert got.shape == (3, 6)
    assert np.array_equal(got.numpy(), np.asarray(xla_sw.sw_score_stack(_j(prof), _j(stack), gap=2, strip=16)))
    sat = row_sw.fast16_sat(2, 40)
    got16 = row_sw.sw_score_stack_fast16(_t(prof), _t(stack), gap=2, strip=16, sat=sat, stage_int8=True)
    want16 = xla_sw.sw_score_stack_fast16(_j(prof), _j(stack), gap=2, strip=16, sat=sat, stage_int8=True)
    assert np.array_equal(got16.numpy(), np.asarray(want16))
    # each chunk of the stack equals the bucket scorer on that chunk alone
    for c in range(3):
        assert torch.equal(got[c], row_sw.sw_score_bucket(_t(prof), _t(stack[c]), gap=2, strip=16))


def test_seg16_stack_matches_xla():
    parts = [_seg_inputs(20 + k, 2, 4, 128) for k in range(2)]
    rows = max(p[1].rows for p in parts)
    prof = parts[0][3]

    def pad(a, fill):
        return np.concatenate([a, np.full((rows - a.shape[0],) + a.shape[1:], fill, a.dtype)])

    stack = np.stack([pad(p[4], PAD_SUBJECT) for p in parts])
    reb = np.stack([pad(p[5], 0) for p in parts])
    ends = np.stack([pad(p[1].ends, 0) for p in parts])
    sat = parts[0][2]
    got = row_sw.sw_score_stack_seg16(_t(prof), _t(stack), _t(reb), _t(ends), gap=2, strip=32, sat=sat)
    want = xla_sw.sw_score_stack_seg16(_j(prof), _j(stack), _j(reb), _j(ends), gap=2, strip=32, sat=sat)
    assert got.shape == (2, rows, 4) and np.array_equal(got.numpy(), np.asarray(want))


def test_sw_score_pairs_matches_xla():
    rng = np.random.default_rng(13)
    q = rng.integers(0, 25, 21).astype(np.int8)
    subjects = [rng.integers(0, 25, int(n)).astype(np.int8) for n in (1, 7, 30, 12)]
    got = row_sw.sw_score_pairs(q, subjects, blosum50_ref(), 2)
    want = xla_sw.sw_score_pairs(q, subjects, blosum50_ref(), 2)
    assert np.array_equal(got, want)


def test_row_steps_count_one_step_per_query_row_per_stack():
    _, prof, subj = _case(14, 20, 4, 24)
    row_sw.reset_row_steps()
    row_sw.sw_score_stack(_t(prof), _t(np.stack([subj, subj, subj])), gap=2, strip=16)
    assert row_sw.row_steps() == prof.shape[0]  # one set of operations a row for all three chunks


# --- the wrappers of K2 and K3 on the CPU, against swtpu's Pallas kernels in interpret mode --------------


def _tiny(seed, B):
    """Interpret mode unrolls a strip of rows and costs seconds a shape:
    strip 8 keeps each of the three shapes here near one second."""
    return _case(seed, 29, B, 64, strip=8)


def test_fused_wrapper_matches_pallas_fused():
    _, prof, subj = _tiny(15, 5)  # B = 5 is not a multiple of a tile: swtpu pads
    before = bucket_sw.sw_score_bucket_fused.launches
    got = bucket_sw.sw_score_bucket_fused(_t(prof), _t(subj), gap=2, strip=8)
    want = np.asarray(pallas_sw.sw_score_bucket_fused(_j(prof), _j(subj), gap=2, strip=8, interpret=True))
    assert got.shape == (5,) and np.array_equal(got.numpy(), want)
    # a (C, B, L) stack in one call equals the kernel chunk by chunk
    stack = np.stack([subj, _tiny(16, 5)[2]])
    got3 = bucket_sw.sw_score_bucket_fused(_t(prof), _t(stack), gap=2, strip=8)
    want1 = np.asarray(pallas_sw.sw_score_bucket_fused(_j(prof), _j(stack[1]), gap=2, strip=8, interpret=True))
    assert got3.shape == (2, 5) and np.array_equal(got3[0].numpy(), want) and np.array_equal(got3[1].numpy(), want1)
    assert bucket_sw.sw_score_bucket_fused.launches == before  # the CPU runs the plain version


def test_fast16_wrapper_matches_pallas_fast16():
    _, prof, subj = _tiny(15, 5)
    got = bucket_sw.sw_score_bucket_fast16(_t(prof), _t(subj), gap=2, strip=8, sat=40)
    want = np.asarray(pallas_sw.sw_score_bucket_fast16(_j(prof), _j(subj), gap=2, strip=8, sat=40, interpret=True))
    assert np.array_equal(got.numpy(), want) and (want == 40).any()
    plain = row_sw.sw_score_bucket_fast16(_t(prof), _t(subj), gap=2, strip=8, sat=40)
    assert torch.equal(got, plain)


def test_bucket_wrapper_matches_pallas_bucket():
    _, prof, subj = _tiny(17, 8)
    before = bucket_sw.sw_score_bucket.launches
    got = bucket_sw.sw_score_bucket(_t(prof), _t(subj), gap=3, strip=8)
    want = np.asarray(pallas_sw.sw_score_bucket(_j(prof), _j(subj), gap=3, strip=8, tile_b=8, interpret=True))
    assert np.array_equal(got.numpy(), want)
    assert bucket_sw.sw_score_bucket.launches == before


@pytest.mark.parametrize(
    "prof_shape,prof_dtype,subj_shape,subj_dtype,match",
    [
        ((32, 32), torch.int16, (4, 16), torch.int8, "profile must be"),
        ((30, 32), torch.int8, (4, 16), torch.int8, "multiple of strip"),
        ((32, 32), torch.int8, (4, 16), torch.int32, "subjects must be"),
        ((32, 32), torch.int8, (16,), torch.int8, "subjects must be"),
    ],
)
def test_wrappers_reject_what_the_kernels_do_not_take(prof_shape, prof_dtype, subj_shape, subj_dtype, match):
    prof, subj = torch.zeros(prof_shape, dtype=prof_dtype), torch.zeros(subj_shape, dtype=subj_dtype)
    for fn in (bucket_sw.sw_score_bucket_fused, bucket_sw.sw_score_bucket):
        with pytest.raises(ValueError, match=match):
            fn(prof, subj, gap=2, strip=32)


def test_wrappers_reject_other_devices():
    prof = torch.zeros((32, 32), dtype=torch.int8, device="meta")
    subj = torch.zeros((4, 16), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        bucket_sw.sw_score_bucket(prof, subj, gap=2, strip=32)
    with pytest.raises(ValueError, match="profile on"):
        bucket_sw.sw_score_bucket_fused(torch.zeros((32, 32), dtype=torch.int8), subj, gap=2, strip=32)


def test_band_profile_and_carry_bytes():
    prof = _t(make_profile(np.arange(40, dtype=np.int8) % 25, blosum50_ref(), pad_rows_to=8))  # 40 rows
    banded = bucket_sw._band_profile(prof)
    assert banded.shape == (64, 32) and torch.equal(banded[:40], prof)
    assert (banded[40:] == -16).all()  # PAD_SCORE rows cannot raise a maximum
    assert bucket_sw.carry_bytes(1, 3, 100, 256) == 0
    assert bucket_sw.carry_bytes(2, 3, 100, 256) == 0  # two bands, one pass of the wavefront: no carry
    assert bucket_sw.carry_bytes(17, 3, 100, 256) == 4 * 3 * 100 * 256  # a pass boundary: G is at most 16
