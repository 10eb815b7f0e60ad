"""Query-band sharding (swtpu_torch.parallel.query_shard) held to swtpu's on the CPU.

The port's meshes name the CPU n times; swtpu's run on the 8 host devices
of tests/conftest.py.  ``wave_query_sharded_scores`` (the systolic band
pipeline on the kernel's band-carry hand-off, B1d; on CPU tensors its plain
version) is held to swtpu's in interpret mode at tests/test_query_shard.py's
shapes, linear and affine (the F plane crosses every device boundary), and
``query_sharded_scores`` (the u-space version on ``row_sw``) to swtpu's, at
n = 1, 2 and 4; swtpu's results are computed once per module, at n = 4.  The
pipeline is also held to one ``sw_wave`` over the whole profile with fewer
lane tiles than devices, and the engine under ``query_shard`` to the
single-device engine and to swtpu's query-shard engine: scores, top-K hits
with E-values, ``search_many``, ``search_queued`` and the CLI.  Every
comparison is exact.
"""

import numpy as np
import pytest
import torch

from swtpu.alphabet import encode_str as j_encode
from swtpu.config import SWConfig as JConfig
from swtpu.io.fasta import Query as JQuery
from swtpu.io.fasta import database_from_sequences as j_database_from_sequences
from swtpu.matrices import blosum50_ref as j_blosum
from swtpu.models.search import SearchEngine as JEngine
from swtpu.ops import xla_sw
from swtpu.parallel.mesh import make_mesh as j_make_mesh
from swtpu.parallel.query_shard import query_sharded_scores as j_query_sharded_scores
from swtpu.parallel.query_shard import wave_query_sharded_scores as j_wave_query_sharded_scores
from swtpu_torch.alphabet import encode_str
from swtpu_torch.config import SWConfig
from swtpu_torch.io.fasta import Query, database_from_sequences
from swtpu_torch.matrices import blosum50_ref
from swtpu_torch.models.search import SearchEngine
from swtpu_torch.ops import wave_sw
from swtpu_torch.ops.profile import PAD_SUBJECT, make_profile
from swtpu_torch.parallel import query_shard
from swtpu_torch.parallel.mesh import make_mesh
from swtpu_torch.utils.bucketing import pack_database_wave, plan_wave_buckets

ALPHABET = "ARNDCQEGHILKMFPSTWYV"
K = 5
# (query length, B, L, gaps): tests/test_query_shard.py's wavefront cases
WAVE_CASES = {"linear": (200, 200, 120, dict(gap=2)), "affine": (400, 100, 90, dict(gap_open=11, gap_extend=1))}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: intra-op threads gain nothing here and contend with
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cpu_mesh(n):
    return make_mesh(devices=("cpu",) * n)


def _subjects(rng, B, L, lo=5):
    subj = np.full((B, L), xla_sw.PAD_SUBJECT, np.int8)
    for i in range(B):
        m = int(rng.integers(lo, L))
        subj[i, :m] = rng.integers(0, 25, m)
    return subj


@pytest.fixture(scope="module")
def wave_cases():
    """Each case's query, subjects and swtpu's interpret-mode scores at n = 4."""
    out = {}
    for name, (qlen, B, L, gaps) in WAVE_CASES.items():
        rng = np.random.default_rng(qlen)
        q = rng.integers(0, 25, qlen).astype(np.int8)
        subj = _subjects(rng, B, L)
        want = j_wave_query_sharded_scores(j_make_mesh(4), q, subj, j_blosum(), interpret=True, **gaps)
        out[name] = (q, subj, gaps, np.asarray(want))
    return out


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("case", sorted(WAVE_CASES))
def test_wave_query_sharded_scores_match_swtpu(wave_cases, case, n):
    q, subj, gaps, want = wave_cases[case]
    got = query_shard.wave_query_sharded_scores(_cpu_mesh(n), q, subj, blosum50_ref(), **gaps)
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("qlen,B,L", [(300, 40, 96), (500, 5, 200)], ids=["blocks", "tiny"])
def test_query_sharded_scores_match_swtpu(n, qlen, B, L):
    """The u-space pipeline, tests/test_query_shard.py's shapes: more blocks
    than devices, and the latency case of a pipeline shorter than the mesh."""
    rng = np.random.default_rng(qlen + n)
    q = rng.integers(0, 25, qlen).astype(np.int8)
    subj = _subjects(rng, B, L, lo=1)
    want = np.asarray(j_query_sharded_scores(j_make_mesh(n), q, subj, j_blosum(), gap=2))
    got = query_shard.query_sharded_scores(_cpu_mesh(n), q, subj, blosum50_ref(), gap=2)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("gaps", [dict(gap=3), dict(gap_open=10, gap_extend=1)], ids=["linear", "affine"])
@pytest.mark.parametrize("n,tiles", [(4, 1), (3, 5)], ids=["fewer-tiles", "more-tiles"])
def test_pipeline_equals_one_launch(gaps, n, tiles):
    """The step over n band blocks and lane tiles equals one sw_wave over
    the whole profile and bucket; n_bands_local may be more than one."""
    rng = np.random.default_rng(n * 10 + tiles)
    bt, L2 = 128, 96 + wave_sw.W
    prof = make_profile(rng.integers(0, 25, 5 * n * wave_sw.W - 7).astype(np.int8), blosum50_ref(), pad_rows_to=n * wave_sw.W)
    subjT = np.full((L2, tiles * bt), PAD_SUBJECT, np.int8)
    for lane in range(tiles * bt - 3):
        m = int(rng.integers(1, L2 - wave_sw.W))
        subjT[:m, lane] = rng.integers(0, 25, m)
    prof, subjT = torch.from_numpy(prof), torch.from_numpy(subjT)
    step = query_shard.make_wave_query_sharded_step(
        _cpu_mesh(n), n_bands_local=prof.shape[0] // (n * wave_sw.W), n_tiles=tiles, Bt=bt, **gaps
    )
    assert torch.equal(step(prof, subjT), wave_sw.sw_wave_plain(prof, subjT, **gaps))


# --- the engine --------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engine_data():
    """tests/test_query_shard.py's engine case (40 subjects, for swtpu's
    interpret mode), and for the port 700 subjects of 30-70 residues:
    unchained buckets of several 128-lane tiles, so the pipeline runs
    longer than the mesh."""
    rng = np.random.default_rng(12)
    seqs = ["".join(rng.choice(list(ALPHABET), size=int(m))) for m in rng.integers(5, 150, 40)]
    qstrs = ["".join(rng.choice(list(ALPHABET), size=m)) for m in (75, 130, 75)]
    many = ["".join(rng.choice(list(ALPHABET), size=int(m))) for m in rng.integers(30, 70, 700)]
    many[9] = ""
    port = ([Query(f"q{i}", encode_str(s), s) for i, s in enumerate(qstrs)], database_from_sequences(seqs))
    jax_side = ([JQuery(f"q{i}", j_encode(s), s) for i, s in enumerate(qstrs)], j_database_from_sequences(seqs))
    return port, jax_side, database_from_sequences(many)


@pytest.mark.parametrize("gaps", ["linear", "affine"])
def test_engine_query_shard_matches_swtpu_and_single(engine_data, gaps):
    """swtpu's query-shard engine (n = 2, interpret mode) gives the
    single-device scores on its small database; the port's at n = 2 and 3
    gives them on both databases, and its top-K hits and E-values equal the
    single device's full-array fit."""
    (queries, small), (jq, jdb), db = engine_data
    g = dict(gap_open=10, gap_extend=2) if gaps == "affine" else {}
    jeng = JEngine(JConfig(use_wave=True, interpret=True, mesh_shape=(2,), query_shard=True, **g))
    want = np.asarray(jeng.search(jq[0], jdb).scores)
    single = SearchEngine(SWConfig(**g), device="cpu")
    assert np.array_equal(single.search(queries[0], small).scores, want)
    got = SearchEngine(SWConfig(mesh_shape=(2,), query_shard=True, **g), device="cpu").search(queries[0], small)
    assert np.array_equal(got.scores, want)
    ref = SearchEngine(SWConfig(top_k=K, evalue=True, **g), device="cpu")
    for n in (2, 3):
        eng = SearchEngine(SWConfig(mesh_shape=(n,), query_shard=True, **g), device="cpu")
        groups = eng._resident_packed(db).wave_groups
        assert eng._wave_chain is False and all(len(grp.parts) == n and grp.n_segs == 1 for grp in groups)
        assert max(grp.parts[0].shape[0] for grp in groups) > 1  # a pipeline of several lane tiles
        # each device's replica is the unchained single pack, tile-major
        for grp, w in zip(groups, pack_database_wave(db, plan=plan_wave_buckets(db, chain=False)).wave_groups):
            tiles = w.stack.reshape(w.stack.shape[0], -1, grp.bt).permute(1, 0, 2)
            assert np.array_equal(grp.ids, w.ids) and all(torch.equal(part, tiles) for part in grp.parts)
        for q in queries:
            assert np.array_equal(eng.search(q, db).scores, single.search(q, db).scores)
        topk = SearchEngine(SWConfig(mesh_shape=(n,), query_shard=True, top_k=K, evalue=True, **g), device="cpu")
        for got, want_r in zip(topk.search_queued(queries, db), ref.search_queued(queries, db)):
            assert got.top_k(K) == want_r.hits
            assert [h.evalue for h in got.top_k_stats(K)] == [h.evalue for h in want_r.top_k_stats(K)]


@pytest.mark.parametrize("n", [2, 4])
def test_engine_query_shard_serving_paths(engine_data, n):
    """search_many and search_queued run a search a query through the band
    pipeline; the profile pads to the band quantum W x n; warmups are
    no-ops, as in swtpu."""
    (queries, _), _, db = engine_data
    single = SearchEngine(SWConfig(), device="cpu")
    eng = SearchEngine(SWConfig(mesh_shape=(n,), query_shard=True), device="cpu")
    assert eng._profile(queries[0]).shape[0] % (wave_sw.W * n) == 0
    assert eng.warmup(queries, db) == 0.0
    for results in (eng.search_many(queries, db), eng.search_queued(queries, db)):
        for q, got in zip(queries, results):
            assert np.array_equal(got.scores, single.search(q, db).scores)


def test_cli_query_shard_dump_matches_single(capsys):
    from pathlib import Path

    from swtpu_torch.cli import main

    root = Path(__file__).resolve().parent
    base = ["--query", str(root / "data/queries/P02232.fasta"), "--db", str(root / "data/uniprot_subset.fasta"), "--device", "cpu"]

    def dump(argv):
        assert main(argv) == 0
        return [ln for ln in capsys.readouterr().out.splitlines() if ln and ln[0].isdigit()]

    want = dump(base)
    assert len(want) == 111
    assert dump(base + ["--mesh", "2", "--query-shard"]) == want
    assert dump(base + ["--mesh", "1", "--query-shard"]) == want
    assert main(base + ["--mesh", "2", "--query-shard", "--no-wave"]) == 2
    assert "wavefront path" in capsys.readouterr().err
    with pytest.raises(SystemExit):  # the port has no composed dispatch
        main(base + ["--mesh", "2", "--query-shard", "--compose"])
    assert "unrecognized arguments: --compose" in capsys.readouterr().err
