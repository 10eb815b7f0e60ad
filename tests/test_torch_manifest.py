"""The port's shard manifest (swtpu_torch.io.manifest) against swtpu's.

swtpu's three cases (tests/test_manifest.py) through both packages: the
round trip, resume-or-create and the tiling check; every manifest the port
saves is byte-for-byte the file swtpu saves for the same calls.
"""

import pytest

from swtpu.io import manifest as jm
from swtpu_torch.io import manifest as tm


def _saved(path, m):
    m.save(path)
    return path.read_bytes()


def test_manifest_roundtrip_matches_swtpu(tmp_path):
    m, jmf = tm.ShardManifest.create("db.fasta", 1000, 3), jm.ShardManifest.create("db.fasta", 1000, 3)
    m.validate()
    assert [s["hi"] - s["lo"] for s in m.shards] == [334, 333, 333]
    assert [m.shard_bounds(i) for i in range(3)] == [jmf.shard_bounds(i) for i in range(3)]
    m.mark_completed("P01008")
    jmf.mark_completed("P01008")
    assert _saved(tmp_path / "port.json", m) == _saved(tmp_path / "swtpu.json", jmf)
    m2 = tm.ShardManifest.load(tmp_path / "swtpu.json")  # the port reads swtpu's file
    assert m2 == m
    assert m2.is_completed("P01008") and not m2.is_completed("P02232")


def test_resume_or_create_matches_swtpu(tmp_path):
    p, jp = tmp_path / "m.json", tmp_path / "j.json"
    m1, j1 = tm.resume_or_create(p, "db.fasta", 100, 4), jm.resume_or_create(jp, "db.fasta", 100, 4)
    assert p.read_bytes() == jp.read_bytes()
    m1.mark_completed("q1")
    j1.mark_completed("q1")
    m1.save(p)
    j1.save(jp)
    m2 = tm.resume_or_create(p, "db.fasta", 100, 4)  # resumes
    assert m2.is_completed("q1") and p.read_bytes() == jp.read_bytes()
    m3 = tm.resume_or_create(p, "db.fasta", 200, 4)  # mismatch -> fresh
    jm.resume_or_create(jp, "db.fasta", 200, 4)
    assert not m3.is_completed("q1") and p.read_bytes() == jp.read_bytes()


def test_manifest_validate_rejects_gap_as_swtpu():
    for mod in (tm, jm):
        m = mod.ShardManifest.create("db", 10, 2)
        m.shards[1]["lo"] = 6
        with pytest.raises(ValueError, match="does not tile"):
            m.validate()
    m = tm.ShardManifest.create("db", 10, 2)
    m.shards[1]["hi"] = 9
    with pytest.raises(ValueError, match="cover 9 of 10"):
        m.validate()
