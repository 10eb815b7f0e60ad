"""swtpu_torch.utils.bucketing against swtpu's wave planner and packer.

The port keeps swtpu's layout parameters, so plans and packed buckets must
come out identical: same (width, ids, bt, bpad, n_segs), same transposed
stack, same lane-major id map.
"""

import numpy as np
import pytest

from swtpu.io.fasta import Database as JDatabase
from swtpu.utils import bucketing as jb
from swtpu_torch.io.fasta import Database
from swtpu_torch.ops.profile import PAD_SUBJECT
from swtpu_torch.utils import bucketing as tb


def _dbs(n, lo, hi, seed, zero_every=0):
    r = np.random.default_rng(seed)
    lens = r.integers(lo, hi + 1, n)
    if zero_every:
        lens[::zero_every] = 0
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    residues = r.integers(0, 25, offsets[-1]).astype(np.int8)
    return JDatabase(residues=residues, offsets=offsets), Database(residues=residues, offsets=offsets)


def _swissprot_shaped(n, seed):
    r = np.random.default_rng(seed)
    lens = np.clip(r.lognormal(mean=5.67, sigma=0.62, size=n), 5, 3000).astype(np.int64)
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    residues = r.integers(0, 25, offsets[-1]).astype(np.int8)
    return JDatabase(residues=residues, offsets=offsets), Database(residues=residues, offsets=offsets)


def _same_plan(a, b):
    assert len(a) == len(b)
    for (w1, i1, bt1, bp1, s1), (w2, i2, bt2, bp2, s2) in zip(a, b):
        assert (w1, bt1, bp1, s1) == (w2, bt2, bp2, s2)
        assert np.array_equal(i1, i2)


@pytest.mark.parametrize("chain", [True, False])
@pytest.mark.parametrize("shape", ["short", "swissprot"])
def test_plan_matches_swtpu(chain, shape):
    jdb, tdb = _dbs(6000, 20, 120, seed=11) if shape == "short" else _swissprot_shaped(6000, seed=5)
    plan = tb.plan_wave_buckets(tdb, chain=chain)
    _same_plan(plan, jb.plan_wave_buckets(jdb, chain=chain))
    if chain and shape == "short":
        assert any(s > 1 for *_, s in plan), "chaining should engage at this scale"


def test_plan_skips_zero_length_records():
    jdb, tdb = _dbs(500, 1, 80, seed=2, zero_every=7)
    plan = tb.plan_wave_buckets(tdb)
    _same_plan(plan, jb.plan_wave_buckets(jdb))
    ids = np.concatenate([i for _, i, _, _, _ in plan])
    assert np.array_equal(np.sort(ids), np.nonzero(tdb.lengths > 0)[0])


def test_width_edges_match_swtpu():
    for m in (1, 300, 992, 2016, 5452, 40000):
        assert tb.wave_width_edges(m) == jb.wave_width_edges(m)


@pytest.mark.parametrize("n_segs,width,bpad", [(1, 96, 384), (2, 128, 256), (3, 192, 128)])
def test_pack_wave_group_matches_swtpu(n_segs, width, bpad):
    jdb, tdb = _dbs(300, 1, width // n_segs, seed=n_segs)
    ids = np.argsort(-tdb.lengths, kind="stable").astype(np.int64)
    mine = tb.pack_wave_group(tdb, width, ids, 128, bpad, n_segs)
    ref = jb.pack_wave_group(jdb, width, ids, 128, bpad, n_segs)
    assert np.array_equal(mine.stack.numpy(), np.asarray(ref.stack))
    assert np.array_equal(mine.ids, ref.ids)
    assert (mine.width, mine.lc, mine.bt, mine.n_segs, mine.rows, mine.cells) == (
        ref.width, ref.lc, ref.bt, ref.n_segs, ref.rows, ref.cells,
    )


def test_pack_database_wave_covers_every_record():
    _, tdb = _dbs(800, 0, 200, seed=9)
    packed = tb.pack_database_wave(tdb)
    seen = np.concatenate([g.ids[g.ids >= 0] for g in packed.wave_groups])
    assert np.array_equal(np.sort(seen), np.nonzero(tdb.lengths > 0)[0])
    for g in packed.wave_groups:
        stack = g.stack.numpy()
        assert (stack[g.width :] == PAD_SUBJECT).all()
        for flat in range(0, g.rows, 37):
            i = g.ids[flat]
            lane, seg = divmod(flat, g.n_segs)
            col = stack[seg * g.seg_cols : (seg + 1) * g.seg_cols, lane]
            n = 0 if i < 0 else int(tdb.lengths[i])
            if i >= 0:
                assert np.array_equal(col[:n], tdb.sequence(i))
            assert (col[n:] == PAD_SUBJECT).all()


def test_iter_wave_groups_matches_resident_pack():
    _, tdb = _dbs(600, 1, 150, seed=4)
    streamed = list(tb.iter_wave_groups(tdb))
    resident = tb.pack_database_wave(tdb).wave_groups
    assert len(streamed) == len(resident)
    for a, b in zip(streamed, resident):
        assert np.array_equal(a.stack.numpy(), b.stack.numpy()) and np.array_equal(a.ids, b.ids)
