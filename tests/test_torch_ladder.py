"""The row path of swtpu_torch against swtpu: planner, packers, engine, CLI.

* ``utils.bucketing``'s ladder half (``width_edges``, ``plan_batches``,
  ``pack_batch``, ``pack_database``, ``iter_packed``, ``scatter_scores``)
  and ``utils.segpack`` give swtpu's plans and arrays exactly, on the
  committed subset and on a SwissProt-shaped 10k database;
* the engine off the wavefront path (``use_wave=False``, ``use_pallas``,
  ``score_dtype="int16"``, ``segment_packing=False``,
  ``fast_saturating=False``) gives the goldens, and swtpu's engine's scores
  under the same config on a database that saturates every int16 scorer (a
  matrix file whose diagonal scores 100), so every rescore path runs;
* its serving paths equal its single searches; int16 top-K and E-values
  agree with swtpu's; affine gaps off the wavefront path raise as swtpu's
  do; the CLI's row flags print swtpu's lines.

swtpu runs its row path through XLA on the CPU.  Its Pallas kernels run here
only in interpret mode, whose cost grows with the query strip, so the
``use_pallas`` engine is compared with swtpu in interpret mode on one tiny
database at strip 8.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from swtpu.config import SWConfig as JConfig
from swtpu.io.fasta import Database as JDatabase
from swtpu.io.fasta import Query as JQuery
from swtpu.io.fasta import database_from_sequences as j_database_from_sequences
from swtpu.io.fasta import parse_database as j_parse_database
from swtpu.io.fasta import parse_query as j_parse_query
from swtpu.models.search import SearchEngine as JEngine
from swtpu.utils import bucketing as jb
from swtpu.utils import segpack as jseg
from swtpu_torch import synth
from swtpu_torch.alphabet import ALPHABET, encode_str
from swtpu_torch.config import SWConfig
from swtpu_torch.io.fasta import Database, Query, database_from_sequences, parse_database, parse_query
from swtpu_torch.models import search as tsearch
from swtpu_torch.models.search import SearchEngine
from swtpu_torch.ops import bucket_sw
from swtpu_torch.utils import bucketing as tb
from swtpu_torch.utils import segpack as tseg

DATA = Path(__file__).resolve().parent / "data"
SUBSET = DATA / "uniprot_subset.fasta"
QUERIES = ("P02232", "P01008", "P05013")

# The row-path configurations under test.
ROW_CONFIGS = {
    "row": dict(use_wave=False),
    "pallas": dict(use_wave=False, use_pallas=True),
    "int16": dict(score_dtype="int16"),
    "no_segments": dict(use_wave=False, segment_packing=False),
    "exact32": dict(use_wave=False, fast_saturating=False),
}


def _golden(name):
    return np.loadtxt(DATA / name, dtype=np.int64)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads gain nothing here, and next
    to other test workers on the same cores they only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dbs(lengths, seed):
    """The same random database for swtpu and the port."""
    r = np.random.default_rng(seed)
    offsets = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    residues = r.integers(0, 25, offsets[-1]).astype(np.int8)
    return JDatabase(residues=residues, offsets=offsets), Database(residues=residues, offsets=offsets)


@pytest.fixture(scope="module")
def dbs():
    """(swtpu, port) databases: the subset, and 10k SwissProt-shaped lengths."""
    r = np.random.default_rng(7)
    lens = np.clip(r.lognormal(mean=5.67, sigma=0.62, size=10_000), 5, 6000).astype(np.int64)
    lens[::997] = 0
    return {"subset": (j_parse_database(SUBSET), parse_database(SUBSET)), "synth10k": _dbs(lens, 8)}


# --- the ladder planner and packer -----------------------------------------------------------------------


@pytest.mark.parametrize("max_width,quantum,ratio", [(5000, 128, 1.25), (300, 8, 1.25), (20000, 64, 1.5)])
def test_width_edges_and_pow2_match_swtpu(max_width, quantum, ratio):
    assert tb.width_edges(max_width, quantum, ratio) == jb.width_edges(max_width, quantum, ratio)
    for x in (0, 1, 2, 3, 7, 8, 9, 255, 256, 257, 8191):
        assert (tb._pow2_floor(x), tb._pow2_ceil(x)) == (jb._pow2_floor(x), jb._pow2_ceil(x))


PLAN_KW = {
    "defaults": dict(),
    "quantum8": dict(length_quantum=8, batch_rows=64, min_rows=8),
    "narrow_budget": dict(max_batch_cells=1 << 16, min_width=512, min_rows=16, min_bucket_rows=32),
}


def _same_batches(a, b):
    assert (a.n_sequences, a.shapes, a.total_cells, len(a.batches)) == (b.n_sequences, b.shapes, b.total_cells, len(b.batches))
    for x, y in zip(a.batches, b.batches):
        assert (x.rows, x.width, x.n_valid) == (y.rows, y.width, y.n_valid)
        assert np.array_equal(x.ids, y.ids)


@pytest.mark.parametrize("kw", list(PLAN_KW), ids=list(PLAN_KW))
@pytest.mark.parametrize("data", ["subset", "synth10k"])
def test_plan_batches_matches_swtpu(dbs, data, kw):
    jdb, tdb = dbs[data]
    _same_batches(tb.plan_batches(tdb.lengths, **PLAN_KW[kw]), jb.plan_batches(jdb.lengths, **PLAN_KW[kw]))


@pytest.mark.parametrize("data", ["subset", "synth10k"])
def test_pack_database_and_batches_match_swtpu(dbs, data):
    jdb, tdb = dbs[data]
    plan = tb.plan_batches(tdb.lengths, batch_rows=512)
    jplan = jb.plan_batches(jdb.lengths, batch_rows=512)
    for (b, arr), (jbatch, jarr) in zip(tb.iter_packed(tdb, plan), jb.iter_packed(jdb, jplan)):
        assert np.array_equal(arr, jarr) and arr.shape == (b.rows, b.width)
    mine, ref = tb.pack_database(tdb, plan), jb.pack_database(jdb, jplan)
    assert mine.total_cells == ref.total_cells and len(mine.groups) == len(ref.groups)
    for g, h in zip(mine.groups, ref.groups):
        assert (g.rows, g.width, g.chunks) == (h.rows, h.width, h.chunks)
        assert np.array_equal(g.stack.numpy(), h.stack) and np.array_equal(g.ids, h.ids)
    rng = np.random.default_rng(3)
    per_batch = [rng.integers(0, 999, b.rows).astype(np.int32) for b in plan.batches]
    assert np.array_equal(tb.scatter_scores(plan, per_batch), jb.scatter_scores(jplan, per_batch))


# --- segment packing -------------------------------------------------------------------------------------


def _same_seg_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.rows, x.width, x.s_max, x.n_valid) == (y.rows, y.width, y.s_max, y.n_valid)
        for f in ("ids", "starts", "ends"):
            assert np.array_equal(getattr(x, f), getattr(y, f))


@pytest.mark.parametrize("widths", [(512,), (256, 512, 1024)], ids=["one_class", "three_classes"])
@pytest.mark.parametrize("data", ["subset", "synth10k"])
def test_plan_multiclass_matches_swtpu(dbs, data, widths):
    _, tdb = dbs[data]
    lengths = tdb.lengths
    short = np.nonzero((lengths < widths[-1]) & (lengths > 0))[0]
    s_max_for = lambda w: max(2, min(8, widths[0] * 8 // w))  # noqa: E731
    rows_for = lambda w: min(8192, max(256, (1 << 18) // w))  # noqa: E731
    mine = tseg.plan_multiclass(lengths[short], short, widths, s_max_for, rows_for)
    ref = jseg.plan_multiclass(lengths[short], short, widths, s_max_for, rows_for)
    assert [w for w, _ in mine] == [w for w, _ in ref]
    for (_, a), (_, b) in zip(mine, ref):
        _same_seg_batches(a, b)
    with pytest.raises(ValueError, match="does not fit"):
        tseg.plan_multiclass(np.array([600]), np.array([0]), (512,), s_max_for, rows_for)


@pytest.mark.parametrize("data", ["subset", "synth10k"])
def test_segment_groups_match_swtpu(dbs, data):
    jdb, tdb = dbs[data]
    short = np.nonzero((tdb.lengths < 512) & (tdb.lengths > 0))[0]
    mine = tseg.pack_seg_groups(tdb, tdb.lengths[short], short, gap=2, width=512, s_max=8, batch_rows=256)
    ref = jseg.pack_seg_groups(jdb, jdb.lengths[short], short, gap=2, width=512, s_max=8, batch_rows=256)
    assert len(mine) == len(ref)
    for g, h in zip(mine, ref):
        assert (g.rows, g.width, g.s_max, g.sat, g.chunks, g.cells) == (h.rows, h.width, h.s_max, h.sat, h.chunks, h.cells)
        for f in ("stack", "rebases", "ends"):
            assert np.array_equal(getattr(g, f).numpy(), np.asarray(getattr(h, f)))
        _same_seg_batches(g.batches, h.batches)
    batch = mine[0].batches[0]
    rng = np.random.default_rng(4)
    z = rng.integers(0, 5 * (mine[0].sat + 1) * batch.s_max, (batch.rows, batch.s_max))
    for x, y in zip(tseg.extract_scores(batch, z, mine[0].sat), jseg.extract_scores(batch, z, mine[0].sat)):
        assert np.array_equal(x, y)
    assert np.array_equal(tseg.slot_offsets(batch, 100), jseg.slot_offsets(batch, 100))
    assert np.array_equal(tseg.build_rebase(batch, 3, 900), jseg.build_rebase(batch, 3, 900))
    assert np.array_equal(tseg.pack_segments_plain(tdb, batch), jseg.pack_segments(jdb, batch))


def test_seg16_sat_and_row_quantum_match_swtpu():
    for gap, width, s_max in ((2, 512, 8), (1, 1024, 4), (11, 256, 2)):
        assert tseg.seg16_sat(gap, width, s_max) == jseg.seg16_sat(gap, width, s_max)
    for rows in (0, 1, 2, 3, 100, 1024, 1025, 5000):
        for multiple in (1, 8):
            assert tseg._quantise_rows(rows, multiple) == jseg._quantise_rows(rows, multiple)


# --- the engine on the row path ------------------------------------------------------------------------


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("name", list(ROW_CONFIGS))
def test_row_engine_subset_goldens(name, query):
    eng = SearchEngine(SWConfig(**ROW_CONFIGS[name]), device="cpu")
    db = parse_database(SUBSET)
    res = eng.search(parse_query(DATA / "queries" / f"{query}.fasta"), db)
    assert np.array_equal(res.scores, _golden(f"golden_{query}_subset.txt"))
    packed = eng._resident_packed(db)
    assert not packed.wave_groups and packed.groups
    assert bool(packed.seg_groups) == (name in ("row", "pallas"))  # int16 and exact32 pack no segments
    assert res.metrics.kernel_launches == 0  # the CPU runs the plain versions


def test_row_engine_saturation_golden_rescores():
    query, seqs = synth.synth_sat_case()
    eng = SearchEngine(SWConfig(use_wave=False), device="cpu")
    res = eng.search(Query("sat", query, ""), synth.database_from_arrays(seqs))
    assert np.array_equal(res.scores, _golden("golden_sat_case.txt"))
    assert eng.rescored_rows >= 2  # the seg16 and fast16 ceilings were reached


def _hot_matrix_file(path):
    """A matrix whose diagonal scores 100: a 340-residue self-alignment
    passes 32,767, a 60-residue one the segment ceiling."""
    letters = list(ALPHABET)
    rows = ["   " + " ".join(f"{c:>4}" for c in letters)]
    for a in letters:
        rows.append(f"{a}  " + " ".join(f"{100 if a == b else -4:>4}" for b in letters))
    path.write_text("\n".join(rows) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def hot(tmp_path_factory):
    """(matrix path, queries, swtpu database, port database): random
    subjects of 0-900 residues plus copies of the query that saturate the
    segment, fast16 and int16 ceilings in ladder and segment groups."""
    rng = np.random.default_rng(31)
    letters = list(ALPHABET[:20])
    q = "".join(rng.choice(letters, 340))
    lens = rng.integers(0, 900, 70)
    lens[::23] = 0
    seqs = ["".join(rng.choice(letters, int(n))) for n in lens]
    seqs[5] = q  # 34,000 in a segment row or a narrow ladder batch
    seqs[9] = "".join(rng.choice(letters, 130)) + q + "".join(rng.choice(letters, 150))  # a ladder batch
    seqs[40] = q[100:160]  # 6,000: only the segment ceiling
    queries = [q, q[:200], q[50:140], "".join(rng.choice(letters, 61))]
    path = _hot_matrix_file(tmp_path_factory.mktemp("hot") / "hot100.mat")
    return path, queries, j_database_from_sequences(seqs), database_from_sequences(seqs)


@pytest.fixture(scope="module")
def hot_ref(hot):
    """swtpu's scores of the first hot query under each config, computed once."""
    path, queries, jdb, _ = hot
    ref = {}
    for name, kw in list(ROW_CONFIGS.items()) + [("int16_streamed", dict(score_dtype="int16", device_resident=False))]:
        # swtpu's resident Pallas path needs a TPU or interpret mode; its
        # streamed use_pallas path on the CPU scores exactly like the port's.
        if name == "pallas":
            kw = dict(kw, device_resident=False)
        eng = JEngine(JConfig(matrix=path, **kw))
        ref[name] = eng.search(JQuery("q", encode_str(queries[0]), queries[0]), jdb).scores
    return ref


@pytest.mark.parametrize("name", list(ROW_CONFIGS) + ["int16_streamed"])
def test_row_engine_matches_swtpu_through_every_rescore(hot, hot_ref, name):
    path, queries, _, db = hot
    kw = ROW_CONFIGS.get(name, dict(score_dtype="int16", device_resident=False))
    eng = SearchEngine(SWConfig(matrix=path, **kw), device="cpu")
    res = eng.search(Query("q", encode_str(queries[0]), queries[0]), db)
    assert np.array_equal(res.scores, hot_ref[name])
    assert res.scores[[5, 9, 40]].tolist() == [34_000, 34_000, 6_000]
    assert res.scores[[0, 23, 46, 69]].tolist() == [0, 0, 0, 0]  # empty records
    assert (eng.rescored_rows > 0) == (name != "exact32")  # exact int32 everywhere: nothing to rescore


def test_pallas_engine_matches_swtpu_pallas_in_interpret_mode():
    rng = np.random.default_rng(41)
    seqs = ["".join(rng.choice(list(ALPHABET[:20]), int(n))) for n in rng.integers(257, 380, 10)]
    q = "".join(rng.choice(list(ALPHABET[:20]), 21))
    cfg = dict(use_wave=False, use_pallas=True, query_strip=8, segment_packing=False)
    want = JEngine(JConfig(interpret=True, **cfg)).search(JQuery("q", encode_str(q), q), j_database_from_sequences(seqs))
    eng = SearchEngine(SWConfig(**cfg), device="cpu")
    got = eng.search(Query("q", encode_str(q), q), database_from_sequences(seqs))
    assert np.array_equal(got.scores, want.scores)
    assert [g.width for g in eng._resident_packed(database_from_sequences(seqs)).groups] == [384]


@pytest.mark.parametrize("name", ["pallas", "int16"])
def test_row_serving_paths_equal_single_searches(hot, name):
    path, queries, _, db = hot
    qs = [Query(f"q{k}", encode_str(s), s) for k, s in enumerate(queries)]
    eng = SearchEngine(SWConfig(matrix=path, **ROW_CONFIGS[name]), device="cpu")
    singles = [eng.search(q, db).scores for q in qs]
    streamed = SearchEngine(SWConfig(matrix=path, device_resident=False, **ROW_CONFIGS[name]), device="cpu")
    for results in (eng.search_many(qs, db), eng.search_queued(qs, db), streamed.search_many(qs, db)):
        assert len(results) == len(qs)
        for res, want in zip(results, singles):
            assert np.array_equal(res.scores, want)
    many = eng.search_many(qs, db)
    assert all(r.metrics.attributed for r in many) and eng.search_many([], db) == []


def test_row_search_many_is_search_queued(monkeypatch):
    """The row kernels have no query axis: search_many enqueues each query's
    own exactly padded profile, in input order, and syncs once."""
    lengths = [40, 41, 52, 70, 75, 200, 30, 45]
    qs = [Query(f"q{k}", np.zeros(n, np.int8), "") for k, n in enumerate(lengths)]
    db = database_from_sequences(["ACDEFGHIKL" * 3, "MNPQ" * 200])
    eng = SearchEngine(SWConfig(use_wave=False), device="cpu")
    packed = eng._resident_packed(db)
    stacks, syncs = [], []
    real = eng._row_step
    monkeypatch.setattr(eng, "_row_step", lambda prof, packed: stacks.append(tuple(prof.shape)) or real(prof, packed))
    monkeypatch.setattr(eng, "_sync", lambda: syncs.append(1))
    for run in (lambda: eng.search_many(qs, db), lambda: eng.search_many(qs, db, packed)):
        stacks.clear(), syncs.clear()
        run()
        assert stacks == [(-(-n // 32) * 32, 32) for n in lengths] and syncs == [1]


def test_row_topk_evalues_int16_match_swtpu():
    db, jdb = parse_database(SUBSET), j_parse_database(SUBSET)
    for name in QUERIES[:2]:
        q, jq = parse_query(DATA / "queries" / f"{name}.fasta"), j_parse_query(DATA / "queries" / f"{name}.fasta")
        mine = SearchEngine(SWConfig(score_dtype="int16", top_k=10, evalue=True), device="cpu").search(q, db)
        ref = JEngine(JConfig(score_dtype="int16", top_k=10, evalue=True)).search(jq, jdb)
        assert mine.scores is not None  # a row-path pack reduces the top-K on the host, as in swtpu
        assert mine.top_k(10) == ref.top_k(10)
        for g, w in zip(mine.top_k_stats(10), ref.top_k_stats(10)):
            assert (g.id, g.score) == (w.id, w.score)
            assert g.evalue == pytest.approx(w.evalue, rel=0.02) and g.bits == pytest.approx(w.bits, rel=0.02)


def test_row_residency_budget_streams_batch_by_batch():
    db = parse_database(SUBSET)
    eng = SearchEngine(SWConfig(use_wave=False, use_pallas=True, device_resident_cells=1000), device="cpu")
    res = eng.search(parse_query(DATA / "queries" / "P01008.fasta"), db)
    assert eng._resident_packed(db) is None
    assert np.array_equal(res.scores, _golden("golden_P01008_subset.txt"))
    assert res.metrics.phases["pack_and_put"] > 0
    assert res.metrics.packed_cells == 480 * eng.plan(db).total_cells  # qpad 480 for 464 aa


def test_fused_stack_splits_along_chunks_when_the_carry_exceeds_the_budget(monkeypatch):
    rng = np.random.default_rng(5)
    db = database_from_sequences(["".join(rng.choice(list(ALPHABET[:20]), int(n))) for n in rng.integers(520, 640, 40)])
    q = parse_query(DATA / "queries" / "P03435.fasta")  # 18 bands: two passes of the kernel, so a carry
    want = SearchEngine(SWConfig(use_wave=False, use_pallas=True), device="cpu").search(q, db).scores
    calls = []
    real = bucket_sw.sw_score_bucket_fused

    def spy(profile, subjects, **kw):
        calls.append(tuple(subjects.shape))
        return real(profile, subjects, **kw)

    spy.launches = 0
    monkeypatch.setattr(bucket_sw, "sw_score_bucket_fused", spy)
    # two chunks' carry fit, not three (the batch is 8 rows of 640 columns)
    monkeypatch.setattr(tsearch, "scratch_budget_bytes", lambda device: 2 * 4 * 8 * 640)
    eng = SearchEngine(SWConfig(use_wave=False, use_pallas=True, batch_rows=8), device="cpu")
    assert np.array_equal(eng.search(q, db).scores, want)
    assert calls == [(2, 8, 640), (2, 8, 640), (1, 8, 640)]


def test_affine_gaps_off_the_wavefront_path_raise_like_swtpu():
    cfg = dict(gap_open=10, gap_extend=1, use_wave=False)
    with pytest.raises(ValueError, match="wavefront"):
        SearchEngine(SWConfig(**cfg), device="cpu")
    with pytest.raises(ValueError, match="wavefront"):
        JEngine(JConfig(**cfg))


@pytest.mark.parametrize("kw", [dict(length_quantum=0), dict(batch_rows=0), dict(score_dtype="int8")])
def test_row_config_checks_match_swtpu(kw):
    with pytest.raises(ValueError):
        SWConfig(**kw)
    with pytest.raises(ValueError):
        JConfig(**kw)


@pytest.mark.parametrize(
    "device,use_pallas,want", [("cpu", None, False), ("cuda", None, True), ("cuda", False, False), ("cpu", True, True)]
)
def test_use_pallas_resolves_from_the_device(monkeypatch, device, use_pallas, want):
    """Auto: the row kernels K2/K3 on a CUDA device, the PyTorch scorers on
    the CPU; an explicit setting wins on either.  No kernel runs here."""
    monkeypatch.setattr(tsearch, "resolve_device", lambda d=None: torch.device(device))
    eng = SearchEngine(SWConfig(use_wave=False, use_pallas=use_pallas))
    assert eng._use_pallas is want
    assert (eng._group_threshold(640) is None) is want  # K2 is exact int32; fast16 rows are rescored


def test_int16_forces_the_row_path():
    assert not SearchEngine(SWConfig(score_dtype="int16", use_wave=True), device="cpu")._wave_enabled
    assert SearchEngine(SWConfig(), device="cpu")._wave_enabled  # auto: the wavefront path on either device


# --- the CLI -----------------------------------------------------------------------------------------------


def _body(lines):
    """Everything before the METRICS block's rule."""
    return lines[: next(i for i, ln in enumerate(lines) if ln.startswith("=" * 20))]


@pytest.mark.parametrize(
    "flags,ref_flags",
    [
        (["--no-wave"], None),
        # swtpu's CLI runs --pallas only on a TPU; its XLA scorers give the same scores
        (["--no-wave", "--pallas"], ["--no-wave", "--no-pallas"]),
        (["--score-dtype", "int16"], None),
        (["--no-wave", "--batch-rows", "64", "--length-quantum", "8"], None),
    ],
    ids=["no-wave", "pallas", "int16", "ladder-knobs"],
)
def test_cli_row_flags_match_swtpu_cli(capsys, flags, ref_flags):
    from swtpu.cli import main as jmain
    from swtpu_torch.cli import main as tmain

    args = ["--query", str(DATA / "queries" / "P01008.fasta"), "--db", str(SUBSET)]
    assert jmain(args + (ref_flags or flags)) == 0
    ref = capsys.readouterr().out.splitlines()
    assert tmain(args + flags + ["--device", "cpu"]) == 0
    mine = capsys.readouterr().out.splitlines()
    assert _body(mine) == _body(ref) and len(_body(mine)) == 113  # input line, blank, 111 scores


@pytest.mark.parametrize(
    "flags",
    [["--batch-rows", "0"], ["--score-dtype", "int16", "--gap-open", "10", "--gap-extend", "1"],
     ["--no-wave", "--gap-open", "10", "--gap-extend", "1"]],
    ids=["batch-rows", "int16-affine", "row-affine"],
)
def test_cli_row_flag_errors_exit_2(capsys, flags):
    from swtpu_torch.cli import main as tmain

    args = ["--query", str(DATA / "queries" / "P05013.fasta"), "--db", str(SUBSET), "--device", "cpu"]
    assert tmain(args + flags) == 2
    assert "swtpu_torch: error" in capsys.readouterr().err
