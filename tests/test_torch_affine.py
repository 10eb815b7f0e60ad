"""Affine (Gotoh) gaps in the port, held to swtpu on the CPU.

On the CPU the port's ``sw_wave`` runs its plain PyTorch version.  These
cases hold its affine mode exactly to swtpu's wavefront kernel in interpret
mode (a few small shapes, as tests/test_affine.py runs it) and to swtpu's
NumPy oracle everywhere else; the port's copy of that oracle to swtpu's; and
the engine's affine single, top-K, E-value, batched, queued and streamed
paths to swtpu's affine engine and to each other.  Scores and hits are
exact; E-values agree with swtpu's within rel 0.02 (the tolerance of
tests/test_evalue_modes.py) and with the port's own full-array fit within
rel 1e-9.  The CUDA kernel's affine mode is held to the plain version on the
card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.alphabet import encode_str as j_encode
from swtpu.config import SWConfig as JConfig
from swtpu.io.fasta import Query as JQuery
from swtpu.io.fasta import database_from_sequences as j_database_from_sequences
from swtpu.matrices import blosum50_ref
from swtpu.models.search import SearchEngine as JEngine
from swtpu.ops import oracle as joracle
from swtpu.ops import wave_sw as jwave
from swtpu.ops import xla_sw
from swtpu_torch.alphabet import encode_str
from swtpu_torch.config import SWConfig
from swtpu_torch.io.fasta import Query, database_from_sequences
from swtpu_torch.models import search as tsearch
from swtpu_torch.models.search import SearchEngine
from swtpu_torch.ops import oracle as toracle
from swtpu_torch.ops import wave_sw
from swtpu_torch.ops.profile import PAD_SUBJECT, make_profile

MAT = blosum50_ref()
OPEN, EXT = 10, 1
ALPHABET = "ARNDCQEGHILKMFPSTWYV"
K = 5


def _bucket(rng, qlens, qpad, ws, S, B, n_pad_slots=2):
    """Random profiles (a (qpad, 32) profile for one query length, a stack
    for several) and a chained (S*ws + 32, B) bucket whose last slots are
    empty."""
    queries = [rng.integers(0, 25, n).astype(np.int8) for n in qlens]
    profs = [make_profile(q, MAT, pad_rows_to=qpad) for q in queries]
    subjects = [rng.integers(0, 25, int(rng.integers(0, ws + 1))).astype(np.int8) for _ in range(B * S - n_pad_slots)]
    stack = np.full((S * ws + 32, B), PAD_SUBJECT, dtype=np.int8)
    for k, s in enumerate(subjects):
        stack[(k % S) * ws : (k % S) * ws + len(s), k // S] = s
    prof = profs[0] if len(qlens) == 1 else np.stack(profs)
    return queries, prof, stack, subjects


def _affine(prof, stack, S, o=OPEN, e=EXT):
    return wave_sw.sw_wave(torch.from_numpy(prof), torch.from_numpy(stack), n_segs=S, gap_open=o, gap_extend=e).numpy()


# --- the plain version's affine mode ------------------------------------------------


@pytest.mark.parametrize(
    "qlens,qpad,ws,S,B,Lc,o,e",
    [
        ((40,), 64, 112, 1, 8, 48, 11, 1),  # two bands, three column chunks
        ((40,), 64, 32, 2, 8, 32, 12, 2),  # chained, two bands
        ((40, 55, 64), 64, 64, 1, 8, 32, 10, 2),  # a (Q, qpad, 32) profile stack
    ],
    ids=["multiband", "chained", "profile_stack"],
)
def test_plain_affine_matches_swtpu_interpret(qlens, qpad, ws, S, B, Lc, o, e):
    rng = np.random.default_rng(sum(qlens) + S + o)
    queries, prof, stack, subjects = _bucket(rng, qlens, qpad, ws, S, B)
    lhs = np.stack([jwave.build_lhs_banded(p) for p in prof]) if prof.ndim == 3 else jwave.build_lhs_banded(prof)
    expect = np.asarray(
        jwave.sw_wave(jnp.asarray(lhs), jnp.asarray(stack), Lc=Lc, Bt=8, n_segs=S, gap_open=o, gap_extend=e, interpret=True)
    )
    got = _affine(prof, stack, S, o, e)
    assert got.dtype == np.int32 and got.shape == expect.shape
    assert np.array_equal(got, expect)
    last = got if got.ndim == 1 else got[-1]
    for k, s in enumerate(subjects):
        assert last[k] == joracle.sw_affine_score_scalar(queries[-1], s, MAT, o, e)
    assert (last[len(subjects):] == 0).all(), "pad slots must score 0"


@pytest.mark.parametrize(
    "qlen,qpad,ws,S,B",
    [(20, 32, 60, 1, 6), (70, 96, 40, 2, 5), (45, 64, 24, 3, 4), (31, 32, 17, 8, 3)],
)
def test_plain_affine_matches_scalar_oracle(qlen, qpad, ws, S, B):
    rng = np.random.default_rng(2000 + qlen)
    (q,), prof, stack, subjects = _bucket(rng, (qlen,), qpad, ws, S, B, n_pad_slots=1)
    for o, e in ((OPEN, EXT), (7, 3), (4, 0)):
        got = _affine(prof, stack, S, o, e)
        assert got.tolist() == [joracle.sw_affine_score_scalar(q, s, MAT, o, e) for s in subjects] + [0]


@pytest.mark.parametrize("gap", [1, 2, 5])
def test_open_equal_to_extend_is_the_linear_recurrence(gap):
    rng = np.random.default_rng(gap)
    _, prof, stack, _ = _bucket(rng, (60, 50, 33), 64, 48, 2, 9)
    linear = wave_sw.sw_wave(torch.from_numpy(prof), torch.from_numpy(stack), gap=gap, n_segs=2).numpy()
    assert np.array_equal(_affine(prof, stack, 2, gap, gap), linear)


def _chained_and_unchained(rng, n_subj, ws, S):
    """The same subjects laid S to a lane and one to a lane."""
    subjects = [rng.integers(0, 25, int(n)).astype(np.int8) for n in rng.integers(1, ws + 1, n_subj)]
    chained = np.full((S * ws + 32, -(-n_subj // S)), PAD_SUBJECT, dtype=np.int8)
    single = np.full((ws + 32, n_subj), PAD_SUBJECT, dtype=np.int8)
    for k, s in enumerate(subjects):
        chained[(k % S) * ws : (k % S) * ws + len(s), k // S] = s
        single[: len(s), k] = s
    return chained, single


@pytest.mark.parametrize("S", [2, 3, 8])
def test_chained_affine_equals_unchained(S):
    """Chained segments reset E and F: a subject scores the same beside
    others in a lane as alone in one."""
    rng = np.random.default_rng(40 + S)
    chained, single = _chained_and_unchained(rng, 4 * S - 1, 40, S)
    prof = make_profile(rng.integers(0, 25, 50).astype(np.int8), MAT, pad_rows_to=64)
    assert np.array_equal(_affine(prof, chained, S)[: single.shape[1]], _affine(prof, single, 1))


def test_plain_affine_keeps_all_pad_rows_when_pads_score():
    # With a profile whose pad column scores positive, all-pad rows are real
    # work under affine gaps too: the plain version must not drop them.
    prof = np.full((32, 32), 3, dtype=np.int8)
    stack = np.full((40, 2), PAD_SUBJECT, dtype=np.int8)
    assert _affine(prof, stack, 1).tolist() == [24, 24]


def test_affine_cpu_never_launches_the_kernel():
    rng = np.random.default_rng(3)
    _, prof, stack, _ = _bucket(rng, (10, 12), 32, 16, 2, 4)
    before = (wave_sw.sw_wave.launches, wave_sw.sw_wave.affine_launches)
    _affine(prof, stack, 2)
    _affine(prof[0], stack, 2)
    assert (wave_sw.sw_wave.launches, wave_sw.sw_wave.affine_launches) == before


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(gap_open=10), "gap_extend"),
        (dict(gap_extend=1, gap=2), "gap_open"),
        (dict(), "gap="),
        (dict(gap=2, gap_open=10, gap_extend=1), "not both"),
        (dict(gap_open=1, gap_extend=3), "gap_open >= gap_extend"),
        (dict(gap_open=3, gap_extend=-1), "gap_open >= gap_extend"),
        (dict(gap=-1), "gap must be"),
    ],
)
def test_sw_wave_rejects_bad_gap_arguments(kw, match):
    prof = torch.zeros((32, 32), dtype=torch.int8)
    stack = torch.full((64, 4), PAD_SUBJECT, dtype=torch.int8)
    for fn in (wave_sw.sw_wave, wave_sw.sw_wave_plain):
        with pytest.raises(ValueError, match=match):
            fn(prof, stack, **kw)


def test_carry_bytes_counts_both_planes():
    # bands past one pass of either shape: the launch carries a pass boundary
    n = 17  # two passes of 16 bands, or 17 band sweeps
    # The int16x2 kernel's carry (int16 slots) and its rescore's (int32, 8 entries, one block)
    assert wave_sw.carry_bytes(n, 2, 100, 128, affine=True) == 2 * wave_sw.carry_bytes(n, 2, 100, 128) == (
        4 * 200 * 128 + 8 * 100 * 8)
    assert wave_sw.carry_bytes(n, 2, 100, 128, affine=True, int16=False) == 8 * 200 * 128
    assert wave_sw.carry_bytes(1, 2, 100, 128, affine=True) == 0


# --- the oracle copy ----------------------------------------------------------------------


def _pairs(seed, n=6):
    r = np.random.default_rng(seed)
    out = []
    for t in range(n):
        q = r.integers(0, 25, int(r.integers(1, 50))).astype(np.int8)
        s = r.integers(0, 25, int(r.integers(1, 70))).astype(np.int8)
        if t % 2:
            k = min(len(q), len(s))
            s[:k] = q[:k]  # a shared stretch: long alignments
        e = int(r.integers(0, 4))
        out.append((q, s, e + int(r.integers(0, 9)), e))
    return out


@pytest.mark.parametrize(
    "name",
    ["sw_matrix_h", "sw_matrix_h_from", "sw_score_diag", "sw_affine_score_scalar", "sw_affine_score_diag",
     "sw_affine_matrices", "sw_affine_rows_from"],
)
def test_oracle_copy_matches_swtpu(name):
    mine, ref = getattr(toracle, name), getattr(joracle, name)
    for q, s, o, e in _pairs(len(name)):
        if name in ("sw_matrix_h", "sw_score_diag"):
            args = (q, s, MAT, o)
        elif name == "sw_matrix_h_from":
            H = joracle.sw_matrix_h(q, s, MAT, o)
            lo = len(q) // 2
            args = (q, s, MAT, o, H[lo], lo, len(q))
        elif name == "sw_affine_rows_from":
            H, E, F = joracle.sw_affine_matrices(q, s, MAT, o, e)
            lo = len(q) // 2
            args = (q, s, MAT, o, e, H[lo].astype(np.int32), E[lo].clip(joracle.NEG32).astype(np.int32),
                    F[lo].clip(joracle.NEG32).astype(np.int32), lo, len(q))
        else:
            args = (q, s, MAT, o, e)
        got, want = mine(*args), ref(*args)
        if isinstance(want, tuple):
            assert len(got) == len(want) and all(np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(got, want))
        elif isinstance(want, np.ndarray):
            assert np.array_equal(got, want) and got.dtype == want.dtype
        else:
            assert got == want and type(got) is type(want)
    consts = ("FROM_NONE", "FROM_LEFT", "FROM_TOP", "FROM_TOP_LEFT", "NEG32")
    assert [getattr(toracle, c) for c in consts] == [getattr(joracle, c) for c in consts]


# --- config ----------------------------------------------------------------------------------


@pytest.mark.parametrize(
    "kw,exc,match",
    [
        (dict(gap_open=10), ValueError, "together"),
        (dict(gap_extend=1), ValueError, "together"),
        (dict(gap_open=1, gap_extend=5), ValueError, "gap_open >= gap_extend"),
        (dict(gap_open=3, gap_extend=-1), ValueError, "gap_open >= gap_extend"),
        (dict(gap_open=10, gap_extend=1, score_dtype="int16"), ValueError, "int32"),
        (dict(gap_open=10, gap_extend=1, use_wave=False), ValueError, "wavefront"),
    ],
)
def test_config_affine_validation(kw, exc, match):
    """The config refuses the gaps themselves; the engine refuses affine
    gaps off the wavefront path, as swtpu's does."""
    with pytest.raises(exc, match=match):
        SearchEngine(SWConfig(**kw), device="cpu")
    with pytest.raises(ValueError):  # swtpu refuses the same settings
        JEngine(JConfig(**kw))


# --- the engine -------------------------------------------------------------------------------


def _seq(rng, n):
    return "".join(rng.choice(list(ALPHABET), size=int(n)))


@pytest.fixture(scope="module")
def workload():
    rng = np.random.default_rng(31)
    lens = rng.integers(5, 90, 60)
    lens[[4, 40]] = 0  # zero-length records score 0
    seqs = [_seq(rng, n) for n in lens]
    qstrs = [_seq(rng, n) for n in (33, 28, 30, 70)]
    seqs[9] = qstrs[0][:25] + seqs[9]  # a planted homolog
    port = ([Query(f"q{i}", encode_str(s), s) for i, s in enumerate(qstrs)], database_from_sequences(seqs))
    jax = ([JQuery(f"q{i}", j_encode(s), s) for i, s in enumerate(qstrs)], j_database_from_sequences(seqs))
    return port, jax


@pytest.fixture(scope="module")
def swtpu_affine(workload):
    """swtpu's affine engine in interpret mode, on the first query: full
    array with E-value statistics, and the device top-K."""
    _, (queries, db) = workload
    cfg = JConfig(use_wave=True, interpret=True, gap_open=OPEN, gap_extend=EXT, evalue=True)
    return JEngine(cfg).search(queries[0], db), JEngine(cfg.replace(top_k=K)).search(queries[0], db)


@pytest.fixture(scope="module")
def port_single(workload):
    (queries, db), _ = workload
    eng = SearchEngine(SWConfig(gap_open=OPEN, gap_extend=EXT, evalue=True), device="cpu")
    return [eng.search(q, db) for q in queries]


def test_engine_affine_matches_swtpu_and_oracle(workload, swtpu_affine, port_single):
    (queries, db), _ = workload
    full, _ = swtpu_affine
    assert np.array_equal(port_single[0].scores, full.scores)
    for i in range(db.n):
        assert port_single[3].scores[i] == joracle.sw_affine_score_diag(queries[3].residues, db.sequence(i), MAT, OPEN, EXT)
    assert (port_single[0].scores[[4, 40]] == 0).all()


def test_engine_affine_topk_and_evalues_match_swtpu(workload, swtpu_affine, port_single):
    (queries, db), _ = workload
    full, topk = swtpu_affine
    res = SearchEngine(SWConfig(gap_open=OPEN, gap_extend=EXT, top_k=K, evalue=True), device="cpu").search(queries[0], db)
    assert res.scores is None and res.hits == topk.hits == port_single[0].top_k(K)
    assert res.hits[0][0] == 9  # the planted homolog
    got, ref = res.top_k_stats(K), full.top_k_stats(K)
    assert [(h.id, h.score) for h in got] == [(h.id, h.score) for h in ref]
    for g, r in zip(got, ref):
        assert g.evalue == pytest.approx(r.evalue, rel=0.02) and g.bits == pytest.approx(r.bits, rel=0.02)


@pytest.mark.parametrize("path", ["many", "queued", "streamed", "many_topk"])
def test_affine_serving_paths_equal_singles(workload, port_single, path):
    (queries, db), _ = workload
    cfg = SWConfig(gap_open=OPEN, gap_extend=EXT)
    res = {
        "many": lambda: SearchEngine(cfg, device="cpu").search_many(queries, db),
        "queued": lambda: SearchEngine(cfg, device="cpu").search_queued(queries, db),
        "streamed": lambda: SearchEngine(cfg.replace(device_resident=False), device="cpu").search_many(queries, db),
        "many_topk": lambda: SearchEngine(cfg.replace(top_k=K, evalue=True), device="cpu").search_many(queries, db),
    }[path]()
    for r, single in zip(res, port_single):
        if path == "many_topk":
            assert r.hits == single.top_k(K)
            for g, w in zip(r.top_k_stats(K), single.top_k_stats(K)):
                assert (g.id, g.score) == (w.id, w.score)
                assert g.evalue == pytest.approx(w.evalue, rel=1e-9) and g.bits == pytest.approx(w.bits, rel=1e-9)
        else:
            assert np.array_equal(r.scores, single.scores)


@pytest.mark.parametrize("gaps", [(OPEN, EXT), (4, 4)], ids=["affine", "open_eq_extend"])
def test_every_launch_gets_the_affine_gaps(workload, monkeypatch, gaps):
    """The engine passes gap_open/gap_extend (and no linear gap) to every
    launch, even when open == extend, and sizes a piece's carry by both
    planes."""
    (queries, db), _ = workload
    calls = []
    real = wave_sw.sw_wave

    def spy(profile, subjT, **kw):
        calls.append(kw)
        return real(profile, subjT, **kw)

    spy.launches = spy.multi_launches = spy.affine_launches = 0
    monkeypatch.setattr(wave_sw, "sw_wave", spy)
    budgets = []
    real_carry = wave_sw.carry_bytes
    monkeypatch.setattr(wave_sw, "carry_bytes", lambda *a: budgets.append(a) or real_carry(*a))
    eng = SearchEngine(SWConfig(gap_open=gaps[0], gap_extend=gaps[1]), device="cpu")
    eng.search(queries[3], db)
    eng.search_many(queries, db)
    eng.search_queued(queries[:2], db)
    SearchEngine(SWConfig(gap_open=gaps[0], gap_extend=gaps[1], device_resident=False), device="cpu").search(queries[0], db)
    assert calls and all(kw.get("gap_open") == gaps[0] and kw.get("gap_extend") == gaps[1] and "gap" not in kw for kw in calls)
    assert budgets and all(a[-1] is True for a in budgets)


def test_affine_piece_split_counts_both_carry_planes(workload, port_single, monkeypatch):
    (queries, db), _ = workload
    # One band a pass, so the 3-band piece crosses pass boundaries and needs a carry.
    monkeypatch.setattr(wave_sw, "wave_shape", lambda n_bands, lanes, n_segs, affine=False: (1, wave_sw.W))
    groups = SearchEngine(SWConfig(), device="cpu").pack_to_device(db).wave_groups
    n_bands = 96 // wave_sw.W  # queries[3] (70 residues) pads to 96 rows
    widest = max(wave_sw.carry_bytes(n_bands, g.n_segs, g.seg_cols, g.lanes) for g in groups)
    # The budget holds two linear carries of the widest bucket, but only one affine carry.
    monkeypatch.setattr(tsearch, "scratch_budget_bytes", lambda device: 2 * widest)
    calls = []
    real = wave_sw.sw_wave

    def spy(profile, subjT, **kw):
        calls.append(tuple(profile.shape))
        return real(profile, subjT, **kw)

    spy.launches = spy.multi_launches = spy.affine_launches = 0
    monkeypatch.setattr(wave_sw, "sw_wave", spy)
    many = SearchEngine(SWConfig(gap_open=OPEN, gap_extend=EXT), device="cpu").search_many([queries[3]] * 2, db)
    for res in many:
        assert np.array_equal(res.scores, port_single[3].scores)
    assert (1, 96, 32) in calls  # the widest bucket's piece went one query a launch
