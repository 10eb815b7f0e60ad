"""``parse_database(path, keep_headers=True)`` and ``Database.headers``
against swtpu's.

On the committed subset and on the native parse's edge cases (CRLF, text
before the first '>', empty headers and bodies, a '>' at the end), the
port's headers, residues and offsets equal swtpu's ``keep_headers=True``
parse, through both of the port's parsers.  The exception is D10 (ROADMAP):
a record whose header line is ``\\r`` two or more times and whose body is
empty.  swtpu's header-keeping parse drops it; its native parse and both of
the port's parsers keep it (C2), with the header "".  Headers travel
through ``take`` and ``shard``.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from swtpu.io import fasta as ref_fasta
from swtpu_torch.io import fasta
from swtpu_torch.io.fasta import Database, database_from_sequences

DATA = Path(__file__).resolve().parent / "data"
CASES = [
    b">a\nMKTA\n",
    b">a desc with spaces\nMKTA",
    b">a\r\nMK\r\nTA\r\n>b\r\nWWW\r\n",
    b">a\r\r\nMK\n>b\nWW\n",
    b"garbage before\n>a\nMK TA\n>b\n\n>c\nRRR\n",
    b"ACGTACGT\nTTTT\n",
    b">only-header-no-body",
    b">a\nMK>TA\n>b\nX\n",
    b">\n\n>\n\n",
    b">\nAC\n>b\nWW\n",
    b">a\nAC\n>",
    b">caf\xc3\xa9 \xff\nAC\n",
]
D10 = [
    b">a\nAC\n>\r\r\n>b\nWW\n",
    b">a\nAC\n>\r\r\n\n>b\nWW\n",
    b">\r\r\r\n>\r\n\r\n",
]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(db):
    return [(h, db.sequence(i).tobytes()) for i, h in enumerate(db.headers)]


def _ours(path):
    native, plain = fasta.parse_database(path, keep_headers=True), fasta.parse_database_plain(path, keep_headers=True)
    assert native.headers == plain.headers
    assert np.array_equal(native.offsets, plain.offsets) and np.array_equal(native.residues, plain.residues)
    return native


def test_subset_headers_equal_swtpu():
    ours, theirs = _ours(DATA / "uniprot_subset.fasta"), ref_fasta.parse_database(DATA / "uniprot_subset.fasta", keep_headers=True)
    assert len(ours.headers) == 111 and ours.headers == theirs.headers
    assert np.array_equal(ours.offsets, theirs.offsets) and np.array_equal(ours.residues, theirs.residues)
    assert fasta.parse_database(DATA / "uniprot_subset.fasta").headers is None


@pytest.mark.parametrize("data", CASES, ids=range(len(CASES)))
def test_edge_cases_equal_swtpu(tmp_path, data):
    path = tmp_path / "db.fasta"
    path.write_bytes(data)
    ours, theirs = _ours(path), ref_fasta.parse_database(path, keep_headers=True)
    assert ours.headers == theirs.headers and _records(ours) == _records(theirs)


@pytest.mark.parametrize("data", D10, ids=range(len(D10)))
def test_d10_record_kept_with_an_empty_header(tmp_path, data):
    path = tmp_path / "db.fasta"
    path.write_bytes(data)
    ours = _ours(path)
    theirs = ref_fasta.parse_database(path, keep_headers=True)
    native = ref_fasta.parse_database(path)  # swtpu's native parse: the records the port keeps
    assert np.array_equal(ours.offsets, native.offsets) and np.array_equal(ours.residues, native.residues)
    kept = [(h, s) for h, s in _records(ours) if h or s]
    assert len(kept) < len(ours.headers)  # the port keeps a record swtpu's header parse drops
    assert kept == _records(theirs)


def test_headers_through_take_and_shard():
    ours = _ours(DATA / "uniprot_subset.fasta")
    theirs = ref_fasta.parse_database(DATA / "uniprot_subset.fasta", keep_headers=True)
    ids = np.array([5, 0, 110, 42, 42])
    assert ours.take(ids).headers == theirs.take(ids).headers == [ours.headers[i] for i in ids]
    for count in (1, 2, 3, 7):
        shards = [ours.shard(k, count) for k in range(count)]
        assert [s.headers for s in shards] == [theirs.shard(k, count).headers for k in range(count)]
        assert sum((s.headers for s in shards), []) == ours.headers
    bare = Database(residues=ours.residues, offsets=ours.offsets)
    assert bare.take(ids).headers is None and bare.shard(0, 2).headers is None
    made = database_from_sequences(["AC", "WW"], headers=["x", "y"])
    assert made.headers == ref_fasta.database_from_sequences(["AC", "WW"], headers=["x", "y"]).headers
