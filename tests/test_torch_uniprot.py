"""The port's UniProt .dat preprocessor against swtpu's, byte for byte.

A small flat file written here (AC lines, 60-column ``SQ   SEQUENCE``
blocks, ``//``; a record with several accessions on several AC lines, an
empty SQ block, a record with no AC line, a record with no SQ block and an
unterminated last record) goes through both packages' ``parse_uniprot_dat``,
``convert_dat`` and ``main`` in every mode: length-sorted and file-order
plain lines, and FASTA.
"""

import contextlib
import io

import numpy as np
import pytest
import torch

from swtpu.io import uniprot as ref_uniprot
from swtpu_torch.io import uniprot

MODES = {"sorted": [], "file_order": ["--no-sort"], "fasta": ["--fasta"], "fasta_file_order": ["--fasta", "--no-sort"]}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _record(lines, accs, seq):
    if accs:
        lines.append("ID   ENTRY_%d   Reviewed;   %d AA." % (len(lines), len(seq)))
        for k in range(0, len(accs), 2):
            lines.append("AC   " + " ".join(a + ";" for a in accs[k : k + 2]))
    lines.append("DE   RecName: Full=Something;")
    lines.append("SQ   SEQUENCE   %d AA;  12345 MW;  0123456789ABCDEF CRC64;" % len(seq))
    for k in range(0, len(seq), 60):
        chunk = seq[k : k + 60]
        lines.append("     " + " ".join(chunk[j : j + 10] for j in range(0, len(chunk), 10)))


@pytest.fixture(scope="module")
def dat(tmp_path_factory):
    rng = np.random.default_rng(3)
    letters = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    lines = []
    for i in range(12):
        seq = "".join(rng.choice(letters, int(rng.integers(1, 300))))
        _record(lines, [f"P{i:05d}", f"Q{i:05d}", f"O{i:05d}"][: 1 + i % 3], seq)
        lines.append("//")
    _record(lines, ["E00001"], "")  # an empty SQ block
    lines.append("//")
    _record(lines, [], "MKV" * 7)  # no AC line
    lines.append("//")
    lines += ["ID   NOSEQ", "AC   N00001;", "//"]  # no SQ block: not a record
    _record(lines, ["A00001"], "".join(rng.choice(letters, 61)))  # no closing //: still a record
    path = tmp_path_factory.mktemp("uniprot") / "tiny.dat"
    path.write_text("\n".join(lines) + "\n")
    return path


def test_parse_equals_swtpu(dat):
    got = uniprot.parse_uniprot_dat(dat)
    assert got == ref_uniprot.parse_uniprot_dat(dat)
    assert len(got) == 15 and ("E00001", "") in got and got[-1][0] == "A00001"


@pytest.mark.parametrize("mode", list(MODES))
def test_convert_and_main_byte_identical(dat, tmp_path, mode):
    flags = MODES[mode]
    kw = dict(sort_by_length="--no-sort" not in flags, fasta="--fasta" in flags)
    assert uniprot.convert_dat(dat, tmp_path / "a", **kw) == ref_uniprot.convert_dat(dat, tmp_path / "b", **kw) == 15
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    outs = []
    for main, name in ((uniprot.main, "c"), (ref_uniprot.main, "d")):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main([str(dat), str(tmp_path / name), *flags]) == 0
        outs.append(buf.getvalue().replace(str(tmp_path / name), "DST"))
    assert outs[0] == outs[1] == "wrote 15 sequences to DST\n"
    assert (tmp_path / "c").read_bytes() == (tmp_path / "d").read_bytes() == (tmp_path / "a").read_bytes()
