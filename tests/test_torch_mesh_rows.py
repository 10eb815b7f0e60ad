"""The port's mesh on every path besides the wavefront's, held to swtpu's
mesh engine on its 8 forced host devices.

The port's meshes here name the CPU n times (``device="cpu"`` with
``mesh_shape=(n,)``), as in tests/test_torch_mesh.py.  The cases, each at
n = 2, 3 and 8:

* ``plan(db)`` and the packed groups' shapes and ids under a mesh (ladder
  batches on rows of ``lcm(8, n)``) against swtpu's;
* the row path with every row group split into n row shards, each scored
  on its device and gathered in mesh order: int32 with segment packing
  (fast16 plus seg16, with the exact rescore of rows saturated in some
  shard), without it (the ladder alone), K2's wrapper (``use_pallas``; its
  plain version on the CPU) and the int16 parity mode, resident and
  streamed, and their batched serving, against swtpu's mesh engine (its
  row path, XLA, exact int32 in every mode: one config a mesh size keeps
  the JAX compiles few);
* the prefilter under a mesh (its coarse pass and gathered exact phase on
  the primary; the row path's exact engine on the mesh) against swtpu's
  mesh engine's hits;
* a database over the residency budget under ``query_shard``, through the
  row ladder on the primary, against swtpu's.

Scores and hits are exactly equal.
"""

import numpy as np
import pytest
import torch

from swtpu.alphabet import encode_str as j_encode
from swtpu.config import SWConfig as JConfig
from swtpu.io.fasta import Query as JQuery
from swtpu.io.fasta import database_from_sequences as j_database_from_sequences
from swtpu.models.search import SearchEngine as JEngine
from swtpu_torch.alphabet import encode_str
from swtpu_torch.config import SWConfig
from swtpu_torch.io.fasta import Query, database_from_sequences
from swtpu_torch.models.search import SearchEngine

ALPHABET = "ARNDCQEGHILKMFPSTWYV"
MESHES = (2, 3, 8)
K = 6
# The row-path configurations (the knobs beside mesh_shape), by name.
ROWS = {
    "int32_seg": dict(use_wave=False),
    "int32_ladder": dict(use_wave=False, segment_packing=False),
    "k2": dict(use_wave=False, use_pallas=True),
    "int16": dict(score_dtype="int16"),
}


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
    """240 short subjects (segment-packed rows in every shard), 12 of
    520-700 (ladder groups of their own), one empty record, runs of W that
    a query of W saturates seg16 on (3,950 at gap 2: the exact rescore of
    rows found on the gathered scores), copies tied across shards, and two
    more queries."""
    rng = np.random.default_rng(71)
    seqs = [_seq(rng, n) for n in np.concatenate([rng.integers(8, 200, 240), rng.integers(520, 700, 12)])]
    seqs[30] = ""
    seqs[5], seqs[203] = "W" * 490, "W" * 420
    seqs[7] = seqs[130] = seqs[239] = seqs[245][:60]
    qstrs = ["W" * 270, seqs[245][:60], _seq(rng, 30)]
    port = ([Query(f"q{i}", encode_str(s), s) for i, s in enumerate(qstrs)], database_from_sequences(seqs))
    jax_side = ([JQuery(f"q{i}", j_encode(s), s) for i, s in enumerate(qstrs)], j_database_from_sequences(seqs))
    return port, jax_side


@pytest.fixture(scope="module")
def swtpu_rows(data):
    """swtpu's mesh engine (its row path on the CPU, fast16 and seg16 with
    the exact rescore) at each mesh size: the three queries' scores."""
    _, (jq, jdb) = data
    return {n: [np.asarray(s) for s in (JEngine(JConfig(mesh_shape=(n,))).search(q, jdb).scores for q in jq)] for n in MESHES}


def _engine(n, **kw):
    return SearchEngine(SWConfig(mesh_shape=(n,), **kw), device="cpu")


@pytest.mark.parametrize("n", MESHES)
def test_plan_and_pack_under_a_mesh_match_swtpu(data, n):
    """Ladder batches on rows of lcm(8, n); the packed ladder and segment
    groups have swtpu's shapes and ids, and each splits into n row shards
    that are the one-device pack's rows, metadata included."""
    (_, db), (_, jdb) = data
    for kw in (ROWS["int32_seg"], ROWS["int32_ladder"]):
        eng, jeng = _engine(n, **kw), JEngine(JConfig(mesh_shape=(n,), **kw))
        got, want = eng.plan(db), jeng.plan(jdb)
        assert got.shapes == want.shapes and got.n_sequences == want.n_sequences
        assert [(b.rows, b.width, b.ids.tolist()) for b in got.batches] == [
            (b.rows, b.width, np.asarray(b.ids).tolist()) for b in want.batches
        ]
        assert all(b.rows % (8 * n // np.gcd(8, n)) == 0 for b in got.batches)
        packed, jpacked = eng.pack_to_device(db), jeng.pack_to_device(jdb)
        assert [(g.rows, g.width, g.chunks, g.ids.tolist()) for g in packed.groups] == [
            (g.rows, g.width, g.chunks, np.asarray(g.ids).tolist()) for g in jpacked.groups
        ]
        assert [(g.rows, g.width, g.s_max, g.sat, g.chunks) for g in packed.seg_groups] == [
            (g.rows, g.width, g.s_max, g.sat, g.chunks) for g in jpacked.seg_groups
        ]
        host = _engine(n, **kw)
        host._place_rows = lambda g: g  # the same groups, in one part on the host
        one_groups = host._pack_rows(db, None)
        for g, w in zip(packed.groups, one_groups.groups):
            assert len(g.parts) == n and torch.equal(torch.cat(g.parts, dim=1), w.stack)
        for g, w in zip(packed.seg_groups, one_groups.seg_groups):
            assert len(g.parts) == n
            for i, t in enumerate((w.stack, w.rebases, w.ends)):
                assert torch.equal(torch.cat([p[i] for p in g.parts], dim=1), t)
        assert bool(packed.seg_groups) == kw.get("segment_packing", True), "the cases below need segment groups"


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("name", list(ROWS))
def test_row_path_under_a_mesh_matches_swtpu(data, swtpu_rows, n, name):
    """Resident: every group scored shard by shard, gathered in mesh order;
    then, for the two packs (segment groups and ladder groups alone),
    search_many (the row path's is search_queued) on the same pack."""
    (queries, db), _ = data
    eng = _engine(n, **ROWS[name])
    for i, q in enumerate(queries):
        assert np.array_equal(eng.search(q, db).scores, swtpu_rows[n][i])
    if name == "int32_seg":
        assert eng.rescored_rows > 0, "the case needs saturated rows, rescored on the gathered scores"
    if name in ("int32_seg", "int16"):
        for i, got in enumerate(eng.search_many(queries[1:], db), 1):
            assert np.array_equal(got.scores, swtpu_rows[n][i])


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("name", ["int32_seg", "int16"])
def test_streamed_row_path_under_a_mesh_matches_swtpu(data, swtpu_rows, n, name):
    """Over the residency budget the ladder streams batch by batch on the
    primary, as swtpu's does."""
    (queries, db), _ = data
    eng = _engine(n, device_resident_cells=1000, **ROWS[name])
    for i, got in enumerate(eng.search_queued(queries, db)):
        assert np.array_equal(got.scores, swtpu_rows[n][i])
    assert eng._resident is None


PREFILTER = dict(prefilter=0.2, top_k=K, prefilter_min_candidates=16)


@pytest.fixture(scope="module")
def swtpu_prefilter(data):
    """swtpu's prefiltered hits on its 8-device mesh (its row path: the
    coarse pass unsharded, the candidates searched on the mesh)."""
    _, (jq, jdb) = data
    jeng = JEngine(JConfig(mesh_shape=(8,), **PREFILTER))
    return [jeng.search(q, jdb).hits for q in jq]


@pytest.mark.parametrize("n", MESHES)
@pytest.mark.parametrize("path", ["wave", "rows"])
def test_prefilter_under_a_mesh_matches_swtpu(data, swtpu_prefilter, n, path):
    """The prefilter's hits under a mesh against swtpu's mesh engine's: the
    port on the wavefront path (the coarse pass and the gathered exact phase
    on the primary) and on the row path (the exact engine on the mesh),
    single and batched."""
    (queries, db), _ = data
    want = swtpu_prefilter
    eng = _engine(n, **PREFILTER, **({} if path == "wave" else dict(use_wave=False)))
    assert [eng.search(q, db).hits for q in queries] == want
    assert [r.hits for r in eng.search_many(queries, db)] == want
    if path == "rows":
        assert eng._exact.mesh is not None and eng._exact.mesh.size == n


@pytest.mark.parametrize("n", MESHES)
def test_streamed_query_shard_matches_swtpu(data, swtpu_rows, n):
    """A database that cannot be resident under query_shard: the row ladder
    on the primary, as swtpu's.  Affine gaps there are refused: the row
    ladder scores linear gaps (swtpu's would score the linear gap)."""
    (queries, db), (jq, jdb) = data
    jeng = JEngine(JConfig(mesh_shape=(n,), query_shard=True, use_wave=True, interpret=True, device_resident=False))
    want = np.asarray(jeng.search(jq[1], jdb).scores)
    eng = _engine(n, query_shard=True, device_resident=False)
    assert np.array_equal(eng.search(queries[1], db).scores, want)
    assert np.array_equal(want, swtpu_rows[n][1])
    for i, got in enumerate(eng.search_many(queries, db)):
        assert np.array_equal(got.scores, swtpu_rows[n][i])
    assert eng._resident is None
    affine = _engine(n, query_shard=True, device_resident=False, gap_open=10, gap_extend=2)
    with pytest.raises(ValueError, match="resident"):
        affine.search(queries[0], db)
