"""The port's native host runtime (swtpu_torch.native) against swtpu's and
against the port's plain versions, bit for bit.

* ``parse_fasta_bytes`` against ``swtpu.native.parse_fasta_bytes``,
  ``swtpu.io.fasta.parse_database`` (whose default is that native parse)
  and the port's ``parse_database_plain``: swtpu's native test cases, the
  C2 inputs (a header line of ``\\r\\r`` with an empty body keeps its
  record) and a hypothesis strategy over FASTA's bytes;
* the three packers and the signatures against swtpu's native functions and
  the port's NumPy and torch versions, at a few seeds, with empty sequences,
  chained segments and a segment row filled to its last column;
* C2 end to end: both packages' ``parse_database`` and the CLIs' id:score
  dumps on the CPU;
* a compiler that fails raises with its output and leaves no library; bad
  ids, starts and buffers raise.

The host library is built with g++ at first use, here as on the card.
"""

from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from swtpu import native as jnative
from swtpu.io import fasta as jfasta
from swtpu.utils import bucketing as jb
from swtpu_torch import native
from swtpu_torch.io import fasta
from swtpu_torch.ops import _build
from swtpu_torch.ops import prefilter as pf
from swtpu_torch.ops.profile import PAD_SUBJECT
from swtpu_torch.utils import bucketing as tb
from swtpu_torch.utils import segpack

# swtpu's native parse cases (tests/test_native.py), then C2 and its neighbours.
CASES = [
    b"",
    b">a\nMKTA\n",
    b">a\nMKTA",  # no trailing newline
    b">a\r\nMK\r\nTA\r\n>b\r\nWWW\r\n",  # CRLF
    b"garbage before\n>a\nMK TA\n>b\n\n>c\nRRR\n",  # whitespace in body, empty body
    b"ACGTACGT\nTTTT\n",  # headerless file
    b">only-header-no-body",
    b">a\nMK>TA\n>b\nX\n",  # '>' mid-line is body content
    b">\n\n>\n\n",  # empty headers and bodies -> all dropped
    b">a\nM\n>a2\n" + b"WKLM" * 500 + b"\n",
    b">a\nAC\n>\r\r\n>b\nWW\n",  # C2: the \r\r header keeps its empty record
    b">a\nAC\n>\r\r\n\n>b\nWW\n",  # C2 with a blank line after the \r\r header
    b">a\nAC\n>\r\n>b\nWW\n",  # one \r: dropped by both rules
    b">\r\r\r\n>\r\n\r\n",  # headers of \r only at the end of the file
    b"\r\n \t\n",  # headerless whitespace only: no record
    b">a\nAC\n>",  # a '>' as the last byte
]


def _parse_all(data, path):
    path.write_bytes(data)
    return {
        "port native": native.parse_fasta_bytes(data),
        "swtpu native": jnative.parse_fasta_bytes(data),
        "swtpu parse_database": (lambda d: (d.residues, d.offsets))(jfasta.parse_database(path)),
        "port parse_database": (lambda d: (d.residues, d.offsets))(fasta.parse_database(path)),
        "port plain": (lambda d: (d.residues, d.offsets))(fasta.parse_database_plain(path)),
    }


def _all_equal(got):
    res0, off0 = got["swtpu native"]
    for name, (res, off) in got.items():
        assert res.dtype == np.int8 and off.dtype == np.int64, name
        assert np.array_equal(off, off0), f"{name}: offsets {off.tolist()} against {off0.tolist()}"
        assert np.array_equal(res, res0), name


@pytest.mark.parametrize("data", CASES, ids=range(len(CASES)))
def test_parse_matches_swtpu_and_plain(tmp_path, data):
    got = _parse_all(data, tmp_path / "db.fasta")
    _all_equal(got)
    if b"\r\r" in data and data.startswith(b">a\nAC"):  # C2: three records, the middle one empty
        assert got["port native"][1].tolist() == [0, 2, 2, 4]


FASTA_BYTES = st.lists(st.sampled_from([b">", b"\n", b"\r", b"\t", b" ", b"A", b"w", b"K", b"c", b"*", b"Z", b"x"]),
                       max_size=60).map(b"".join)


@settings(max_examples=300, deadline=None)
@given(data=FASTA_BYTES)
def test_parse_matches_on_any_fasta_bytes(tmp_path_factory, data):
    _all_equal(_parse_all(data, tmp_path_factory.mktemp("fuzz") / "db.fasta"))


def test_write_fasta_matches_swtpu_and_round_trips(tmp_path):
    rng = np.random.default_rng(7)
    seqs = ["".join(rng.choice(list("ARNDCQEGHILKMFPSTWYV"), int(n))) for n in rng.integers(0, 200, 40)]
    fasta.write_fasta(tmp_path / "mine.fasta", seqs, width=60)
    jfasta.write_fasta(tmp_path / "ref.fasta", seqs, width=60)
    assert (tmp_path / "mine.fasta").read_bytes() == (tmp_path / "ref.fasta").read_bytes()
    db = fasta.parse_database(tmp_path / "mine.fasta")
    assert db.n == 40 and db.largest_length == max(len(s) for s in seqs)
    assert all(np.array_equal(a, b) for a, b in zip(db.sequences(), fasta.database_from_sequences(seqs).sequences()))
    assert fasta.Query("q", np.zeros(13, np.int8), "").padded_length(8) == 16


def _db(seed, n=300, hi=200):
    """Port and swtpu databases over the same arrays: lengths 0..hi, every
    seventh empty."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, hi + 1, n)
    lens[::7] = 0
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    residues = rng.integers(0, 25, int(offsets[-1])).astype(np.int8)
    return fasta.Database(residues=residues, offsets=offsets), jfasta.Database(residues=residues, offsets=offsets)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_batch_matches_swtpu_and_plain(seed):
    db, _ = _db(seed)
    rng = np.random.default_rng(seed)
    for rows, width in ((256, 256), (300, 128), (512, 64)):  # widths below the longest cut members
        ids = rng.permutation(db.n)[: int(rng.integers(1, rows + 1))].astype(np.int32)
        batch = tb.Batch(ids=ids, rows=rows, width=width)
        mine = tb.pack_batch(db, batch)
        assert np.array_equal(mine, jnative.pack_batch_native(db.residues, db.offsets, ids, rows, width, PAD_SUBJECT))
        assert np.array_equal(mine, tb.pack_batch_plain(db, batch))
        out = np.zeros((2, rows, width), np.int8)
        tb.pack_batch(db, batch, out=out[1])  # in place into a slice of a stack
        assert np.array_equal(out[1], mine) and not out[0].any()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_database_matches_plain_batches(seed):
    db, _ = _db(seed, n=2000, hi=400)
    plan = tb.plan_batches(db.lengths, batch_rows=256, min_width=64)
    packed = tb.pack_database(db, plan)
    for g in packed.groups:
        for c in range(g.chunks):
            ids = g.ids[c][g.ids[c] >= 0]
            want = tb.pack_batch_plain(db, tb.Batch(ids=ids, rows=g.rows, width=g.width))
            assert np.array_equal(g.stack[c].numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_segments_matches_swtpu_and_plain(seed):
    db, _ = _db(seed, hi=150)
    short = np.nonzero((db.lengths > 0) & (db.lengths < 256))[0]
    batches = segpack.plan_segments(db.lengths[short], short, width=256, s_max=4, batch_rows=64)
    assert len(batches) > 1 and max(b.ids.shape[1] for b in batches) == 4
    for batch in batches:
        mine = segpack.pack_segments(db, batch)
        ref = jnative.pack_segments_native(db.residues, db.offsets, batch.ids, batch.starts, batch.width, PAD_SUBJECT)
        assert np.array_equal(mine, ref)
        assert np.array_equal(mine, segpack.pack_segments_plain(db, batch))


def test_segment_rows_filled_to_their_last_column():
    """Row 0: members of 20 and 43 residues with a pad column between them
    (20 + 1 + 43 = 64); row 1: one member of 64."""
    rng = np.random.default_rng(3)
    db = fasta.Database(residues=rng.integers(0, 25, 127).astype(np.int8), offsets=np.array([0, 20, 63, 127]))
    ids, starts = np.array([[0, 1], [2, -1]]), np.array([[0, 21], [0, 0]], np.int32)
    batch = segpack.SegBatch(ids=ids, starts=starts, ends=np.zeros_like(starts), rows=2, width=64, s_max=2)
    mine = segpack.pack_segments(db, batch)
    assert np.array_equal(mine, jnative.pack_segments_native(db.residues, db.offsets, ids, starts, 64, PAD_SUBJECT))
    assert np.array_equal(mine, segpack.pack_segments_plain(db, batch))
    assert np.array_equal(mine[0, 21:], db.sequence(1)) and np.array_equal(mine[1], db.sequence(2))
    assert (mine[0] == PAD_SUBJECT).sum() == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_segs", [1, 2, 3])
def test_pack_bucket_T_matches_swtpu_and_plain(seed, n_segs):
    db, jdb = _db(seed + 10 * n_segs, hi=96 // n_segs)
    width, bpad = 96, 128
    ids = np.argsort(-db.lengths, kind="stable")[: bpad * n_segs - 5].astype(np.int64)  # pad lanes and empty members
    mine = tb.pack_wave_group(db, width, ids, 128, bpad, n_segs)
    ref = jb.pack_wave_group(jdb, width, ids, 128, bpad, n_segs)
    assert np.array_equal(mine.stack.numpy(), np.asarray(ref.stack)) and np.array_equal(mine.ids, ref.ids)
    assert np.array_equal(mine.stack.numpy(), tb.gather_wave_stack(db, width, ids, bpad, n_segs).numpy())
    one = native.pack_bucket_T_native(db.residues, db.offsets, ids[:bpad], 50, bpad, PAD_SUBJECT)  # cut at 50 rows
    assert np.array_equal(one, jnative.pack_bucket_T_native(db.residues, db.offsets, ids[:bpad].astype(np.int32), 50,
                                                            bpad, PAD_SUBJECT))


def test_streamed_wave_buckets_equal_the_plain_gather():
    db, _ = _db(5, n=900, hi=300)
    for g in tb.iter_wave_groups(db):
        members = g.ids[g.ids >= 0]
        assert np.array_equal(g.stack.numpy(), tb.gather_wave_stack(db, g.width, members, g.lanes, g.n_segs).numpy())


@pytest.mark.parametrize("dim", [64, 1024])
@pytest.mark.parametrize("seed", [0, 1])
def test_signatures_match_swtpu_and_plain(seed, dim):
    db, _ = _db(seed, hi=60)  # many records shorter than k = 3 and empty ones
    mine = pf.database_signatures(db, dim)
    assert mine.dtype == np.int8 and mine.shape == (db.n, dim)
    assert np.array_equal(mine, jnative.build_signatures_native(db.residues, db.offsets, dim, pf.K, pf._MIX))
    assert np.array_equal(mine, pf.database_signatures_plain(db, dim, chunk=101))


@pytest.mark.parametrize("k", [2, 4])
def test_signatures_hash_3mers_only(k):
    db, _ = _db(0, n=20)
    with pytest.raises(ValueError, match="3-mers only"):
        native.build_signatures_native(db.residues, db.offsets, 64, k, pf._MIX)


def test_c2_record_kept_by_both_packages_and_both_clis(tmp_path, capsys):
    from swtpu.cli import main as jmain
    from swtpu_torch.cli import main as tmain

    path = tmp_path / "c2.fasta"
    path.write_bytes(b">a\nAC\n>\r\r\n>b\nWW\n")
    mine, ref = fasta.parse_database(path), jfasta.parse_database(path)
    assert mine.offsets.tolist() == ref.offsets.tolist() == [0, 2, 2, 4]
    assert np.array_equal(mine.residues, ref.residues)
    args = ["--query", str(Path(__file__).parent / "data" / "queries" / "P02232.fasta"), "--db", str(path)]
    assert jmain(args) == 0
    ref_out = capsys.readouterr().out.splitlines()
    assert tmain(args + ["--device", "cpu"]) == 0
    mine_out = capsys.readouterr().out.splitlines()

    def dump(lines):
        return [ln for ln in lines if ":" in ln and ln.split(":")[0].isdigit()]

    assert dump(mine_out) == dump(ref_out) and [ln.split(":")[0] for ln in dump(mine_out)] == ["0", "1", "2"]
    assert dump(mine_out)[1] == "1:0"


def test_bad_plans_raise():
    db, _ = _db(0, n=20)
    with pytest.raises(RuntimeError, match="outside the database"):
        native.pack_batch_native(db.residues, db.offsets, np.array([3, 20]), 4, 16, PAD_SUBJECT)
    with pytest.raises(RuntimeError, match="more members than rows"):
        native.pack_bucket_T_native(db.residues, db.offsets, np.arange(5), 16, 4, PAD_SUBJECT)
    with pytest.raises(RuntimeError, match="segment start outside its row"):
        native.pack_segments_native(db.residues, db.offsets, np.array([[1]]), np.array([[17]]), 16, PAD_SUBJECT)
    with pytest.raises(RuntimeError, match="power of two"):
        native.build_signatures_native(db.residues, db.offsets, 1000, 3, pf._MIX)
    with pytest.raises(ValueError, match="out must be"):
        native.pack_batch_native(db.residues, db.offsets, np.array([1]), 4, 16, PAD_SUBJECT, out=np.empty((4, 8), np.int8))
    with pytest.raises(ValueError, match="do not bound"):
        native.pack_batch_native(db.residues[:-1], db.offsets, np.array([1]), 4, 16, PAD_SUBJECT)


def test_a_failing_compiler_raises_and_leaves_no_library(tmp_path, monkeypatch):
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "broken.cpp").write_text("extern \"C\" int broken( { return 0; }\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD", build)
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed on csrc/broken.cpp:\n.*error"):
        _build.load("broken", broken=[])
    assert list(build.iterdir()) == [] and _build._loaded == {}
    # the package's own library, with a compiler that fails: every entry point raises, none returns
    monkeypatch.setattr(_build, "CSRC", _build.PKG / "csrc")
    monkeypatch.setattr(_build, "gxx", lambda: "false")
    with pytest.raises(RuntimeError, match="false failed on csrc/sw_native.cpp"):
        native.parse_fasta_bytes(b">a\nAC\n")
    assert list(build.iterdir()) == [] and _build._loaded == {}
