"""The port's lane-sharded mesh (swtpu_torch.parallel) held to swtpu's on the CPU.

The port's meshes here name the CPU n times (``device="cpu"`` with
``mesh_shape=(n,)``), the counterpart of the 8 host devices that
tests/conftest.py forces for JAX.  Each shard's launches run for real on
its lane shard (the kernel's plain version on CPU tensors), and the results
merge as on the card.  The cases:

* ``make_mesh``, ``shard_range`` and ``Database.shard`` against swtpu's;
* the wave plan under a mesh's lane multiple against swtpu's, and the lane
  shards of a pack against the single-device pack, column for column;
* the lane-sharded engine at n = 1, 2, 3 and 8, on a database whose
  buckets put real subjects in every shard, against the port's
  single-device engine and swtpu's mesh engine (its row path; its
  wavefront path in interpret mode at n = 2 on a smaller database):
  ``search``, the device top-K with E-values, ``search_many``,
  ``search_queued``, streaming, ``warmup``, affine gaps;
* the merged top-K when ties span shards;
* ``make_sharded_step`` and ``ShardedSearchEngine`` against swtpu's;
* the CLI's ``--mesh`` dumps against the single-device dump;
* every refused combination, and the four that slice A14b brought (the
  row path, the int16 mode, the prefilter and a streamed database under
  query_shard), which now run (tests/test_torch_mesh_rows.py holds them to
  swtpu's mesh engine).

Scores and hits are exactly equal; E-values are equal to the single-device
engine's (the same integer moments and candidates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.alphabet import encode_str as j_encode
from swtpu.config import SWConfig as JConfig
from swtpu.io.fasta import Query as JQuery
from swtpu.io.fasta import database_from_sequences as j_database_from_sequences
from swtpu.io.fasta import shard_range as j_shard_range
from swtpu.matrices import blosum50_ref as j_blosum
from swtpu.models.search import SearchEngine as JEngine
from swtpu.ops import xla_sw
from swtpu.parallel import mesh as jmesh
from swtpu.parallel.search import ShardedSearchEngine as JShardedEngine
from swtpu.parallel.search import make_sharded_step as j_make_sharded_step
from swtpu.utils.bucketing import plan_wave_buckets as j_plan_wave_buckets
from swtpu_torch.alphabet import encode_str
from swtpu_torch.config import SWConfig
from swtpu_torch.io.fasta import Query, database_from_sequences, shard_range
from swtpu_torch.matrices import blosum50_ref
from swtpu_torch.models import search as tsearch
from swtpu_torch.models.search import SearchEngine
from swtpu_torch.ops.profile import make_profile
from swtpu_torch.parallel import mesh as tmesh
from swtpu_torch.parallel.search import ShardedSearchEngine, make_sharded_step
from swtpu_torch.utils.bucketing import pack_database_wave, plan_wave_buckets

ALPHABET = "ARNDCQEGHILKMFPSTWYV"
MESHES = (1, 2, 3, 8)
K = 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: intra-op threads gain nothing here and contend with
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq(rng, n):
    return "".join(rng.choice(list(ALPHABET), size=int(n)))


@pytest.fixture(scope="module")
def data():
    """600 short subjects (8-70 residues: buckets of hundreds of lanes, so
    every shard of every mesh holds real subjects) and 30 of 100-420, copies
    of the first query's parts far apart (scores that tie across shards),
    one empty record, and three queries."""
    rng = np.random.default_rng(61)
    seqs = [_seq(rng, n) for n in np.concatenate([rng.integers(8, 70, 600), rng.integers(100, 420, 30)])]
    seqs[605] = _seq(rng, 200)
    seqs[7] = seqs[331] = seqs[598] = seqs[605][:60]  # equal scores on ids far apart
    seqs[20] = ""
    qstrs = [seqs[605][:60], _seq(rng, 140), _seq(rng, 33)]
    port = ([Query(f"q{i}", encode_str(s), s) for i, s in enumerate(qstrs)], database_from_sequences(seqs))
    jax_side = ([JQuery(f"q{i}", j_encode(s), s) for i, s in enumerate(qstrs)], j_database_from_sequences(seqs))
    return port, jax_side


@pytest.fixture(scope="module")
def single(data):
    """The port's single-device results: full scores, and top-K hits with
    E-values, per query, linear and affine."""
    (queries, db), _ = data
    out = {}
    for name, gaps in (("linear", {}), ("affine", dict(gap_open=10, gap_extend=2))):
        eng = SearchEngine(SWConfig(**gaps), device="cpu")
        topk = SearchEngine(SWConfig(top_k=K, evalue=True, **gaps), device="cpu")
        out[name] = [(eng.search(q, db).scores, topk.search(q, db)) for q in queries]
    return out


@pytest.fixture(scope="module")
def swtpu_mesh(data):
    """swtpu's mesh engine scores of the three queries on its forced host
    devices (its row path, XLA: exact, and fast at this size) and its top-K
    hits at n = 8."""
    _, (jq, jdb) = data
    out = {}
    for n in MESHES:
        eng = JEngine(JConfig(mesh_shape=(n,)))
        out[n] = [np.asarray(eng.search(q, jdb).scores) for q in jq]
    eng = JEngine(JConfig(mesh_shape=(8,), top_k=K))
    out["hits"] = [eng.search(q, jdb).top_k(K) for q in jq]
    return out


def _mesh_engine(n, **kw):
    return SearchEngine(SWConfig(mesh_shape=(n,), **kw), device="cpu")


def _stats(result):
    return [(h.id, h.score, h.evalue, h.bits) for h in result.top_k_stats(K)]


# --- the mesh and the shard helpers -------------------------------------------------------


def test_make_mesh_takes_cards_and_explicit_devices(monkeypatch):
    mesh = tmesh.make_mesh(devices=("cpu",) * 3, axis="x")
    assert mesh.size == 3 and mesh.axis == "x" and mesh.distinct == (torch.device("cpu"),)
    assert mesh.primary == torch.device("cpu")
    with pytest.raises(ValueError):  # as swtpu's
        jmesh.make_mesh(10_000)
    with pytest.raises(ValueError, match="only"):
        tmesh.make_mesh(10_000)
    with pytest.raises(ValueError, match="2 devices given"):
        tmesh.make_mesh(3, devices=("cpu", "cpu"))
    # One card: mesh_shape=(4,) alone raises, as swtpu's does; naming the
    # card four times is a mesh of four shards on it.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmesh.make_mesh(1).devices == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="requested 4 devices, only 1 available"):
        SearchEngine(SWConfig(mesh_shape=(4,)))
    with pytest.raises(ValueError, match="requested 2 devices"):
        SearchEngine(SWConfig(mesh_shape=(2,)), device="cuda")
    assert tmesh.make_mesh(4, devices=["cuda:0"] * 4).distinct == (torch.device("cuda", 0),)


@pytest.mark.parametrize("n,count", [(0, 1), (10, 1), (10, 3), (11, 4), (5, 8), (59, 8)])
def test_shard_range_and_database_shard_match_swtpu(data, n, count):
    (_, db), (_, jdb) = data
    for i in range(count):
        assert shard_range(n, i, count) == j_shard_range(n, i, count)
    for i in range(count):
        got, want = db.shard(i, count), jdb.shard(i, count)
        assert np.array_equal(got.offsets, want.offsets) and np.array_equal(got.residues, want.residues)
    assert sum(db.shard(i, count).n for i in range(count)) == db.n


@pytest.mark.parametrize("n", MESHES)
def test_lane_multiple_plan_matches_swtpu(data, n):
    """A mesh pads every bucket's lanes to bt x n, as swtpu's planner."""
    (_, db), (_, jdb) = data
    got = plan_wave_buckets(db, lane_multiple=n)
    want = j_plan_wave_buckets(jdb, lane_multiple=n)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g[0], g[2], g[3], g[4]) == (w[0], w[2], w[3], w[4]) and np.array_equal(g[1], w[1])
        assert g[3] % (g[2] * n) == 0


@pytest.mark.parametrize("n", [2, 3])
def test_lane_shards_are_the_single_pack_split(data, n):
    (_, db), _ = data
    plan = plan_wave_buckets(db, lane_multiple=n)
    whole = pack_database_wave(db, plan=plan)
    eng = SearchEngine(SWConfig(mesh_shape=(n,)), device="cpu")
    sharded = eng.pack_to_device(db, plan)
    planned_here = eng.pack_to_device(db)  # plans with the mesh's lane multiple itself
    assert [g.ids.tolist() for g in planned_here.wave_groups] == [g.ids.tolist() for g in sharded.wave_groups]
    for w, s in zip(whole.wave_groups, sharded.wave_groups):
        assert len(w.parts) == 1 and len(s.parts) == n and np.array_equal(s.ids, w.ids)
        assert torch.equal(torch.cat(s.parts, dim=1), w.stack)
        assert all(p.is_contiguous() for p in s.parts)
    # the cases below are only as strong as this: every shard of the widest
    # bucket holds real subjects
    widest = max(sharded.wave_groups, key=lambda g: g.rows)
    assert all((part >= 0).any() for part in np.split(widest.ids, n))


# --- the lane-sharded engine ------------------------------------------------------------------


@pytest.mark.parametrize("n", MESHES)
def test_mesh_search_matches_swtpu_and_single(data, single, swtpu_mesh, n):
    (queries, db), _ = data
    eng = _mesh_engine(n)
    assert (eng.mesh is None) == (n == 1)
    for i, q in enumerate(queries):
        got = eng.search(q, db)
        assert np.array_equal(got.scores, single["linear"][i][0])
        assert np.array_equal(got.scores, swtpu_mesh[n][i])
        assert got.metrics.kernel_launches == 0  # no card: no kernel launched


def test_mesh_matches_swtpu_wavefront_mesh_engine():
    """swtpu's lane-sharded wavefront engine (interpret mode, n = 2, its
    shard_map over lane shards) on a database small enough for interpret
    mode, against the port's at n = 2: scores and top-K hits."""
    rng = np.random.default_rng(62)
    seqs = [_seq(rng, n) for n in rng.integers(10, 300, 50)]
    qs = seqs[7][:60]
    jeng = JEngine(JConfig(mesh_shape=(2,), use_wave=True, interpret=True, top_k=K))
    want = jeng.search(JQuery("q", j_encode(qs), qs), j_database_from_sequences(seqs))
    q, db = Query("q", encode_str(qs), qs), database_from_sequences(seqs)
    got = _mesh_engine(2, top_k=K).search(q, db)
    assert got.hits == want.top_k(K)
    assert np.array_equal(_mesh_engine(2).search(q, db).scores, SearchEngine(SWConfig(), device="cpu").search(q, db).scores)


@pytest.mark.parametrize("n", [2, 3, 8])
def test_mesh_device_topk_with_evalues(data, single, swtpu_mesh, n):
    """Each shard reduces its keys and moments; the merge gives the single
    device's hits and E-values exactly, and swtpu's mesh hits."""
    (queries, db), _ = data
    eng = _mesh_engine(n, top_k=K, evalue=True)
    for i, q in enumerate(queries):
        got = eng.search(q, db)
        want = single["linear"][i][1]
        assert got.scores is None and got.hits == want.hits == swtpu_mesh["hits"][i]
        assert _stats(got) == _stats(want)


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("topk", [False, True], ids=["scores", "topk"])
def test_mesh_search_many_and_queued(data, single, n, topk):
    (queries, db), _ = data
    kw = dict(top_k=K, evalue=True) if topk else {}
    eng = _mesh_engine(n, **kw)
    batch = queries + queries[:2]  # equal padded lengths share a piece
    for results in (eng.search_many(batch, db), eng.search_queued(batch, db)):
        for q, got in zip(batch, results):
            i = queries.index(q)
            if topk:
                assert got.hits == single["linear"][i][1].hits and _stats(got) == _stats(single["linear"][i][1])
            else:
                assert np.array_equal(got.scores, single["linear"][i][0])


@pytest.mark.parametrize("n", [2, 3])
def test_mesh_streaming_matches_single(data, single, n):
    """A non-resident database streams bucket by bucket, each upload split
    into its lane shards."""
    (queries, db), _ = data
    eng = _mesh_engine(n, device_resident=False)
    assert np.array_equal(eng.search(queries[1], db).scores, single["linear"][1][0])
    for i, got in enumerate(eng.search_many(queries, db)):
        assert np.array_equal(got.scores, single["linear"][i][0])
    assert eng._resident is None


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("gaps", ["linear", "affine"])
def test_mesh_fused_matches_single(data, single, n, gaps):
    """The queries fused on every shard: the full array, and the queued
    device top-K with E-values, as one device gives them."""
    (queries, db), _ = data
    g = dict(gap_open=10, gap_extend=2) if gaps == "affine" else {}
    eng = _mesh_engine(n, **g)
    for i, q in enumerate(queries):
        assert np.array_equal(eng.search(q, db).scores, single[gaps][i][0])
    topk = _mesh_engine(n, top_k=K, evalue=True, **g)
    got = topk.search_queued(queries, db)
    assert [r.hits for r in got] == [single[gaps][i][1].hits for i in range(len(queries))]


@pytest.mark.parametrize("n", [2, 8])
def test_mesh_warmups_match_single(data, single, n):
    """``warmup`` dispatches each fused shape on every shard; the searches
    after it answer as one device does."""
    (queries, db), _ = data
    eng = _mesh_engine(n, top_k=K)
    assert eng.warmup(queries, db) > 0
    for i, got in enumerate(eng.search_many(queries, db)):
        assert got.hits == single["linear"][i][1].hits


@pytest.mark.parametrize("n", [2, 3, 8])
def test_mesh_affine_matches_single(data, single, n):
    (queries, db), _ = data
    eng = _mesh_engine(n, gap_open=10, gap_extend=2)
    for i, got in enumerate(eng.search_many(queries, db)):
        assert np.array_equal(got.scores, single["affine"][i][0])
    got = _mesh_engine(n, gap_open=10, gap_extend=2, top_k=K, evalue=True).search(queries[0], db)
    assert got.hits == single["affine"][0][1].hits and _stats(got) == _stats(single["affine"][0][1])


def test_mesh_topk_merge_orders_ties_across_shards():
    """Three shards of four slots: the merged keys give (score desc, id
    asc) across the shard boundaries, and the moments add."""
    eng = _mesh_engine(3)
    ids = [np.array([9, 2, -1, 5]), np.array([0, 7, 3, 11]), np.array([4, 1, 8, -1])]
    flat = [torch.tensor([[7, 7, 0, 3]]), torch.tensor([[7, 1, 7, 7]]), torch.tensor([[2, 7, 3, 0]])]
    bins = [torch.tensor(b) for b in ([0, 1, 2, 2], [1, 0, 0, 1], [0, 0, 1, 2])]
    shards = tuple(
        (4, 4, torch.from_numpy(np.where(i >= 0, tsearch._ID_MASK - i, 0)), (b, 2)) for i, b in zip(ids, bins)
    )
    vals, got, moms = eng._topk_of([[f.int()] for f in flat], (12, 5, None, None, None, shards))
    assert vals.tolist() == [[7, 7, 7, 7, 7]] and got.tolist() == [[0, 1, 2, 3, 9]]
    want = sum(tsearch._null_moments(f.int(), b, 2) for f, b in zip(flat, bins))
    assert torch.equal(moms, want)


# --- the explicit building blocks --------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("mode", ["int32", "k3", "fast16"])
def test_sharded_step_matches_swtpu(n, mode):
    rng = np.random.default_rng(11 + n)
    q = rng.integers(0, 25, 48).astype(np.int8)
    B, L = 8 * n, 128
    subj = np.full((B, L), xla_sw.PAD_SUBJECT, np.int8)
    for i in range(B):
        m = int(rng.integers(5, L))
        subj[i, :m] = rng.integers(0, 25, m)
    subj[3] = subj[B - 2]  # a tie across shards
    jstep = j_make_sharded_step(jmesh.make_mesh(n), gap=2, strip=32, top_k=5, fast16=mode == "fast16")
    jprof = jax.device_put(jnp.asarray(xla_sw.make_profile(q, j_blosum(), pad_rows_to=32)), jmesh.replicated(jmesh.make_mesh(n)))
    jsubj = jax.device_put(jnp.asarray(subj), jmesh.db_sharding(jmesh.make_mesh(n)))
    want = [np.asarray(x) for x in jstep(jprof, jsubj)]
    step = make_sharded_step(
        tmesh.make_mesh(devices=("cpu",) * n), gap=2, strip=32, top_k=5, use_pallas=mode == "k3", fast16=mode == "fast16"
    )
    got = step(torch.from_numpy(make_profile(q, blosum50_ref(), pad_rows_to=32)), torch.from_numpy(subj))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)


def test_sharded_engine_matches_swtpu(data, single):
    (queries, db), (jq, jdb) = data
    scores, hits, metrics = ShardedSearchEngine(tmesh.make_mesh(devices=("cpu",) * 4)).search(queries[0], db, top_k=K)
    jscores, jhits, _ = JShardedEngine(jmesh.make_mesh(4)).search(jq[0], jdb, top_k=K)
    assert np.array_equal(scores, np.asarray(jscores)) and np.array_equal(scores, single["linear"][0][0])
    assert hits == jhits and metrics.n_subjects == db.n


# --- the CLI ---------------------------------------------------------------------------------


def _dump(capsys, argv):
    from swtpu_torch.cli import main

    assert main(argv) == 0
    return [ln for ln in capsys.readouterr().out.splitlines() if ln and ln[0].isdigit()]


@pytest.mark.parametrize("extra", [[], ["--top-k", "5", "--evalue"]], ids=["dump", "evalue"])
def test_cli_mesh_dump_matches_single(capsys, extra):
    from pathlib import Path

    root = Path(__file__).resolve().parent
    base = ["--query", str(root / "data/queries/P02232.fasta"), "--db", str(root / "data/uniprot_subset.fasta"), "--device", "cpu"]
    want = _dump(capsys, base + extra)
    assert len(want) == (5 if extra[:1] == ["--top-k"] else 111)
    assert _dump(capsys, base + extra + ["--mesh", "2"]) == want


# --- refused combinations ------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw,err,match",
    [
        (dict(query_shard=True, wave_chain=True), ValueError, "wave_chain"),
        (dict(query_shard=True, use_wave=False), ValueError, "wavefront path"),
        (dict(mesh_axes=("db", "x")), ValueError, "align"),
        (dict(mesh_shape=(0,), mesh_axes=("db",)), ValueError, ">= 1"),
    ],
)
def test_refused_combinations(kw, err, match):
    kw = {"mesh_shape": (2,), **kw}
    with pytest.raises(err, match=match):
        SWConfig(**kw)


@pytest.mark.parametrize(
    "kw",
    [dict(use_wave=False), dict(score_dtype="int16"), dict(prefilter=0.1, top_k=3), dict(query_shard=True, device_resident=False)],
    ids=["row_path", "int16", "prefilter", "streamed_query_shard"],
)
def test_a14b_combinations_run(data, single, kw):
    """The four combinations that raised NotImplementedError until slice
    A14b now run on a 2-shard mesh and equal the single-device engine."""
    (queries, db), _ = data
    got = _mesh_engine(2, **kw).search(queries[1], db)
    if "prefilter" in kw:
        assert got.hits == SearchEngine(SWConfig(**kw), device="cpu").search(queries[1], db).hits
    else:
        assert np.array_equal(got.scores, single["linear"][1][0])


def test_refused_devices_and_multi_host(data, single):
    (queries, db), _ = data
    with pytest.raises(ValueError, match="sequence of 2 devices"):
        SearchEngine(SWConfig(mesh_shape=(2,)), device="cuda:1")
    with pytest.raises(ValueError, match="needs 2 devices, 3 given"):
        SearchEngine(SWConfig(mesh_shape=(2,)), device=["cpu"] * 3)
    # multi-process bring-up is parallel.distributed's (slice A15): one
    # process needs none, and the mesh module no longer stubs it
    from swtpu_torch.parallel import distributed

    distributed.initialize(num_processes=1)
    assert not torch.distributed.is_initialized() and not hasattr(tmesh, "initialize_distributed")
    # the single-device engine of a one-device list is no mesh
    assert SearchEngine(SWConfig(), device=["cpu"]).mesh is None
    # a query-sharded database over the residency budget streams through the row ladder
    eng = SearchEngine(SWConfig(mesh_shape=(2,), query_shard=True, device_resident_cells=10), device="cpu")
    assert np.array_equal(eng.search(queries[0], db).scores, single["linear"][0][0]) and eng._resident is None
