"""The port's main path end to end on the CPU, held to the goldens and swtpu.

``SearchEngine(SWConfig(), device="cpu")`` runs the same parse -> pack ->
score -> scatter path as on the card, with the kernel's plain version.
Every comparison is exact.
"""

import sys
from pathlib import Path

import numpy as np
import pytest

from swtpu.config import SWConfig as JConfig
from swtpu.io.fasta import database_from_sequences as j_database_from_sequences
from swtpu.io.fasta import parse_database as j_parse_database
from swtpu.models.search import SearchEngine as JEngine
from swtpu.models.search import SearchResult as JResult
from swtpu_torch import synth
from swtpu_torch.config import SWConfig
from swtpu_torch.io.fasta import Query, parse_database, parse_query
from swtpu_torch.models.search import SearchEngine, SearchResult

ROOT = Path(__file__).resolve().parent.parent
DATA = ROOT / "tests" / "data"
SUBSET = DATA / "uniprot_subset.fasta"


def _golden(name):
    return np.array([int(x) for x in (DATA / name).read_text().split()], dtype=np.int32)


@pytest.fixture(scope="module")
def make_goldens():
    sys.path.insert(0, str(ROOT))
    from tools import make_goldens

    return make_goldens


@pytest.mark.parametrize("query", ["P02232", "P01008", "P05013"])
def test_subset_goldens(query):
    res = SearchEngine(SWConfig(), device="cpu").search(
        parse_query(DATA / "queries" / f"{query}.fasta"), parse_database(SUBSET)
    )
    assert res.scores.dtype == np.int32 and res.scores.shape == (111,)
    assert np.array_equal(res.scores, _golden(f"golden_{query}_subset.txt"))


def test_scale10k_golden():
    q = parse_query(DATA / "queries" / "P02232.fasta")
    db = synth.database_from_arrays(synth.synth_scale_db(q.residues))
    res = SearchEngine(SWConfig(), device="cpu").search(q, db)
    golden = _golden("golden_P02232_scale10k.txt")
    assert golden[-1] > 900  # the planted tandem repeat
    assert np.array_equal(res.scores, golden)


def test_saturation_golden():
    query, seqs = synth.synth_sat_case()
    res = SearchEngine(SWConfig(), device="cpu").search(
        Query(name="sat", residues=query, raw=""), synth.database_from_arrays(seqs)
    )
    golden = _golden("golden_sat_case.txt")
    assert golden[0] > 24576 and golden[1] > 3950
    assert np.array_equal(res.scores, golden)


def test_synth_copies_match_tools_generators(make_goldens):
    q = parse_query(DATA / "queries" / "P02232.fasta")
    mine = synth.synth_scale_db(q.residues)
    ref = make_goldens.synth_scale_db(10_000)
    assert len(mine) == len(ref) and all(np.array_equal(a, b) for a, b in zip(mine, ref))
    mq, mseqs = synth.synth_sat_case()
    rq, rseqs = make_goldens.synth_sat_case()
    assert np.array_equal(mq, rq)
    assert len(mseqs) == len(rseqs) and all(np.array_equal(a, b) for a, b in zip(mseqs, rseqs))


def test_synth_database_matches_bench():
    sys.path.insert(0, str(ROOT))
    import bench

    mine, ref = synth.synth_database(3000, seed=0), bench.synth_database(3000, seed=0)
    assert np.array_equal(mine.offsets, ref.offsets)
    assert np.array_equal(mine.residues, ref.residues)


@pytest.mark.parametrize("chain", [True, False])
def test_matches_swtpu_default_engine(chain):
    r = np.random.default_rng(21)
    alphabet = "ARNDCQEGHILKMFPSTWYVBJZX*"
    lens = np.clip(r.lognormal(5.0, 0.7, 400), 1, 900).astype(int)
    lens[::50] = 0  # empty records score 0
    seqs = ["".join(r.choice(list(alphabet), size=n)) for n in lens]
    qres = "".join(r.choice(list(alphabet[:20]), size=77))
    jdb = j_database_from_sequences(seqs)
    from swtpu.io.fasta import Query as JQuery
    from swtpu.alphabet import encode_str

    expect = JEngine(JConfig()).search(JQuery("q", encode_str(qres), qres), jdb).scores
    from swtpu_torch.alphabet import encode_str as t_encode
    from swtpu_torch.io.fasta import database_from_sequences

    res = SearchEngine(SWConfig(wave_chain=chain), device="cpu").search(
        Query("q", t_encode(qres), qres), database_from_sequences(seqs)
    )
    assert np.array_equal(res.scores, expect)
    assert (res.scores[::50] == 0).all()


def test_parse_database_matches_swtpu():
    mine, ref = parse_database(SUBSET), j_parse_database(SUBSET)
    assert np.array_equal(mine.residues, ref.residues)
    assert np.array_equal(mine.offsets, ref.offsets)


def test_matrices_match_swtpu():
    import swtpu.matrices as jm
    import swtpu_torch.matrices as tm

    for name in ("blosum50", "blosum50_ref", "match_mismatch"):
        assert np.array_equal(tm.get_matrix(name), jm.get_matrix(name))


def test_top_k_order_matches_swtpu():
    r = np.random.default_rng(2)
    scores = r.integers(0, 6, 200).astype(np.int32)  # many ties
    mine = SearchResult(scores=scores, metrics=None)
    ref = JResult(scores=scores, metrics=None)
    for k in (0, 1, 7, 50, 200, 500):
        assert mine.top_k(k) == ref.top_k(k)


def test_engine_packs_once_and_counts_cells():
    db = parse_database(SUBSET)
    eng = SearchEngine(SWConfig(), device="cpu")
    q = parse_query(DATA / "queries" / "P02232.fasta")
    first = eng.search(q, db)
    packed = eng._resident_packed(db)
    second = eng.search(q, db)
    assert eng._resident_packed(db) is packed
    assert np.array_equal(first.scores, second.scores)
    assert first.metrics.packed_cells == 160 * packed.total_cells  # qpad 160 for 147 aa
    assert first.metrics.kernel_launches == 0  # the CPU runs the plain version


def test_residency_budget_raises_when_too_small():
    db = parse_database(SUBSET)
    eng = SearchEngine(SWConfig(device_resident_cells=1000), device="cpu")
    with pytest.raises(RuntimeError, match="resident"):
        eng.search(parse_query(DATA / "queries" / "P02232.fasta"), db)


def test_cli_scores_match_swtpu_cli(capsys):
    from swtpu.cli import main as jmain
    from swtpu_torch.cli import main as tmain

    args = ["--query", str(DATA / "queries" / "P01008.fasta"), "--db", str(SUBSET)]
    assert jmain(args) == 0
    ref = capsys.readouterr().out.splitlines()
    assert tmain(args + ["--device", "cpu"]) == 0
    mine = capsys.readouterr().out.splitlines()

    def body(lines):  # "Input buffer" line and the id:score lines
        return [ln for ln in lines if ln.startswith("Input buffer:") or (":" in ln and ln.split(":")[0].isdigit())]

    assert body(mine) == body(ref) and len(body(mine)) == 112
    assert mine[-7:-2] == ref[-7:-2]  # rule, METRICS:, query length, subjects, DB length
    assert mine[-1].startswith("Performance:") and mine[-1].endswith("GCUPS.")


def test_cli_json_metrics(capsys):
    import json

    from swtpu_torch.cli import main

    args = ["--query", str(DATA / "queries" / "P05013.fasta"), "--db", str(SUBSET), "--device", "cpu"]
    assert main(args + ["--json", "--no-scores"]) == 0
    out = capsys.readouterr().out.splitlines()
    d = json.loads(out[-1])
    assert d["n_subjects"] == 111 and d["query_length"] > 0 and "gcups_device" in d
    assert not any(":" in ln and ln.split(":")[0].isdigit() for ln in out)


def test_matrix_file_and_alphabet_match_swtpu(tmp_path):
    import swtpu.alphabet as ja
    import swtpu.matrices as jm
    import swtpu_torch.alphabet as ta
    import swtpu_torch.matrices as tm

    path = tmp_path / "small.mat"
    path.write_text("# comment\n   A  R  U\nA  4 -1  0\nR -1  5  0\nU  0  0  1\n")
    with pytest.warns(UserWarning, match="outside"):
        mine = tm.get_matrix(str(path))
    with pytest.warns(UserWarning, match="outside"):
        ref = jm.get_matrix(str(path))
    assert np.array_equal(mine, ref)
    raw = bytes(range(256))
    assert np.array_equal(ta.encode_bytes(raw), ja.encode_bytes(raw))
