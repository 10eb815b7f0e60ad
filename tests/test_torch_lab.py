"""The wavefront lab kernels (K4, K5, K6) and the packed-int16 probe (K9) of the port.

On the CPU the port's wrappers run their plain PyTorch versions; these cases
hold them, exactly, to the JAX lab kernels in interpret mode on the same
numpy inputs: K9's ten tiles to ``tools/probe_i16.py``'s kernels, K4 at
every band height to ``tools/pallas_wave.py``'s V5 wavefront (W = 32: at
W = 16 that kernel's own slicing fails), K5 at two prefetch depths to
``tools/pallas_wave2.py``'s V6 kernel, and K6's "none" to swtpu's
wavefront kernel.  ``pallas_wave2`` imports swtpu's current ``G`` and
``KPAD`` (4 and 384), with which its hard-coded 8-step groups no longer
reshape, so the K5 case sets that module's ``G``, ``KPAD`` and
``build_lhs_banded`` to K4's g = 8 values for the call; nothing under
``tools/`` changes.  K6's other variants are held to numpy statements of
their definitions, at K4's heights and at K5's and K6's sweep height (64
rows over K1's 32-row bands, a tail band where their count is odd); K5 and
K6 take K1's unpadded profile and refuse rows off its 32-row bands; the
lab tools' ``buckets.run`` times in rounds.  The CUDA kernels are held to these plain versions on
the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from swtpu.matrices import blosum50_ref
from swtpu.ops import wave_sw as jwave
from swtpu.ops import xla_sw
from swtpu_torch.ops import i16_probe, wave_lab
from swtpu_torch.ops.profile import make_profile
from tools import pallas_wave, pallas_wave2, probe_i16

GAP = 2
MAT = blosum50_ref()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: intra-op threads gain nothing here, and next
    to other test workers on the same cores they only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- K9 -----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["int16", "int32"])
@pytest.mark.parametrize("op", i16_probe.OPS)
def test_i16_tile_matches_probe_kernel(op, dtype):
    jdt = getattr(jnp, dtype)
    a = jnp.arange(16 * 512, dtype=jdt).reshape(16, 512) % 1000  # probe_i16.run's inputs
    b = (a * 3 + 7) % 997
    kern = getattr(probe_i16, f"k_{op}")
    want = np.asarray(pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct(a.shape, jdt), interpret=True)(a, b))
    got = i16_probe.i16_op(torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b)), op)
    assert got.dtype == getattr(torch, dtype) and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("op", ["add", "sub", "dp_row"])
def test_i16_tile_wraps_like_jax(op):
    """int16 sums past 32,767 wrap as JAX's do (the probe's own inputs never
    get there)."""
    rng = np.random.default_rng(4)
    a = rng.integers(-32768, 32768, (4, 64)).astype(np.int16)
    b = rng.integers(-32768, 32768, (4, 64)).astype(np.int16)
    kern = getattr(probe_i16, f"k_{op}")
    want = np.asarray(pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct(a.shape, jnp.int16), interpret=True)(a, b))
    assert np.array_equal(i16_probe.i16_op(torch.from_numpy(a), torch.from_numpy(b), op).numpy(), want)


def _chain_numpy(x, y, op, links, bits):
    def wrap(v):
        half = 1 << (bits - 1)
        return (v + half) % (2 * half) - half

    x, y = x.astype(np.int64), y.astype(np.int64)
    acc = x.copy()
    for _ in range(links):
        acc = {"max": lambda: np.maximum(acc, y), "add": lambda: wrap(acc + y), "sub": lambda: wrap(acc - y),
               "select": lambda: np.where(acc < y, y, acc), "addmax": lambda: np.maximum(wrap(acc + y), x),
               "max3": lambda: np.maximum(np.maximum(acc, y), x)}[op]()
    return acc


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("op", i16_probe.CHAIN_OPS)
def test_i16_chain_plain_matches_numpy(op, dtype):
    rng = np.random.default_rng(5)
    x = rng.integers(32000, 32768, (32, 8)) if dtype == torch.int16 else rng.integers(0, 1000, (32, 8))
    y = rng.integers(-3, 3000, (32, 8))  # int16 sums wrap within a few links
    got = i16_probe.i16_chain(torch.from_numpy(x).to(dtype), torch.from_numpy(y).to(dtype), op, 3)
    want = _chain_numpy(x, y, op, 3 * i16_probe.UNROLL, 16 if dtype == torch.int16 else 32)
    assert got.dtype == dtype and np.array_equal(got.numpy(), want)


def test_i16_wrappers_check_inputs():
    a = torch.zeros(4, 8, dtype=torch.int16)
    with pytest.raises(ValueError, match="op must be"):
        i16_probe.i16_op(a, a, "mul")
    with pytest.raises(ValueError, match="op must be"):
        i16_probe.i16_chain(a, a, "dp_row", 1)
    with pytest.raises(ValueError, match="int16 or int32"):
        i16_probe.i16_op(a.long(), a.long(), "max")
    with pytest.raises(ValueError, match="int16 or int32"):
        i16_probe.i16_op(a, a[:, :4], "max")
    with pytest.raises(ValueError, match="even column"):
        i16_probe.i16_op(a[:, :3], a[:, :3], "max")
    with pytest.raises(ValueError, match="iters"):
        i16_probe.i16_chain(a, a, "max", -1)
    before = (i16_probe.i16_op.launches, i16_probe.i16_chain.launches)
    i16_probe.i16_op(a, a, "dp_row")
    i16_probe.i16_chain(a, a, "addmax", 1)
    assert (i16_probe.i16_op.launches, i16_probe.i16_chain.launches) == before  # the CPU never launches


# --- K4 and K5 --------------------------------------------------------------------


def _run_case_inputs(B, L, Q, seed=0):
    """``tools/pallas_wave.py::run_case``'s query and (B, L) subjects."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 25, Q).astype(np.int8)
    subj = np.full((B, L), xla_sw.PAD_SUBJECT, np.int8)
    for i in range(B):
        n = int(rng.integers(max(L // 4, 1), L + 1))
        subj[i, :n] = rng.integers(0, 25, n)
    return q, subj


def _lab(fn, q, subjT, pad=wave_lab.K1_HEIGHT, **kw):
    """The port's wrapper ``fn`` on the query's profile (rows padded to a
    multiple of ``pad``) and ``subjT``."""
    prof = torch.from_numpy(make_profile(q, MAT, pad_rows_to=pad))
    return fn(prof, torch.from_numpy(np.ascontiguousarray(subjT)), gap=GAP, **kw).numpy()


@pytest.mark.parametrize("Q", [64, 70])  # 70: three bands of 32, padded to two of 64
def test_k4_every_height_matches_pallas_wave(Q):
    W, Lc, g, Bt = 32, 64, 8, 128
    q, subj = _run_case_inputs(128, 60, Q)
    prof = xla_sw.make_profile(q, MAT, pad_rows_to=W)
    subjT = pallas_wave.prep(subj, W, Lc)  # (128, 128): two chunks of 64
    want = np.asarray(pallas_wave.sw_wave(jnp.asarray(pallas_wave.build_lhs_banded(prof, W, g)), jnp.asarray(subjT),
                                          gap=GAP, W=W, Lc=Lc, g=g, Bt=Bt, interpret=True))
    for h in wave_lab.HEIGHTS:
        for blk in (32, 128):
            got = _lab(wave_lab.sw_wave_band, q, subjT, pad=h, height=h, block=blk)
            assert np.array_equal(got, want), (h, blk)


def test_k5_matches_pallas_wave2(monkeypatch):
    Lc, Bt, g = 64, 128, 8
    monkeypatch.setattr(pallas_wave2, "G", g)
    monkeypatch.setattr(pallas_wave2, "KPAD", pallas_wave._kpad(g))
    monkeypatch.setattr(pallas_wave2, "build_lhs_banded", lambda p: pallas_wave.build_lhs_banded(p, 32, g))
    q, subj = _run_case_inputs(128, 60, 32)
    width = -(-(60 + 32) // 64) * 64 - 32  # pallas_wave2.run's width: two chunks of 64
    subjT = jwave.transpose_pad(subj, width)
    lhsB = pallas_wave2.build_lhs_banded(xla_sw.make_profile(q, MAT, pad_rows_to=32))
    want = np.asarray(pallas_wave2.sw_wave6(jnp.asarray(lhsB), jnp.asarray(subjT), gap=GAP, Lc=Lc, Bt=Bt,
                                            interpret=True))
    for d in (1, 4):
        assert np.array_equal(_lab(wave_lab.sw_wave_prefetch, q, subjT, depth=d), want), d


# --- K6 -----------------------------------------------------------------------------


def _chained_bucket(rng, qlen, ws, S, B):
    q = rng.integers(0, 25, qlen).astype(np.int8)
    stack = np.full((S * ws + 32, B), xla_sw.PAD_SUBJECT, dtype=np.int8)
    for k in range(B * S - 2):  # the last two slots stay empty
        n = int(rng.integers(1, ws + 1))
        stack[(k % S) * ws : (k % S) * ws + n, k // S] = rng.integers(0, 25, n)
    return q, stack


@pytest.mark.parametrize("qlen,qpad,ws,S,B,Lc", [(40, 64, 96, 1, 16, 64), (20, 32, 48, 2, 8, 32)])
def test_k6_none_matches_swtpu_interpret(qlen, qpad, ws, S, B, Lc):
    q, stack = _chained_bucket(np.random.default_rng(qlen * 10 + S), qlen, ws, S, B)
    prof = xla_sw.make_profile(q, MAT, pad_rows_to=qpad)
    want = np.asarray(jwave.sw_wave(jnp.asarray(jwave.build_lhs_banded(prof)), jnp.asarray(stack), gap=GAP, Lc=Lc,
                                    Bt=8, n_segs=S, interpret=True))
    assert np.array_equal(_lab(wave_lab.sw_wave_skip, q, stack, n_segs=S, skip="none"), want)


def _sw_numpy(prof, idx, gap):
    """SW max of every row of ``idx`` (N, L) against the (R, 32) profile,
    zero boundaries: the scalar recurrence, vectorised over rows."""
    N, L = idx.shape
    best = np.zeros(N, np.int64)
    above = np.zeros((N, L), np.int64)
    for r in range(prof.shape[0]):
        row = np.zeros((N, L), np.int64)
        left = np.zeros(N, np.int64)
        for c in range(L):
            diag = above[:, c - 1] if c else np.zeros(N, np.int64)
            left = np.maximum.reduce([np.zeros(N, np.int64), diag + prof[r, idx[:, c]], above[:, c] - gap, left - gap])
            row[:, c] = left
        best = np.maximum(best, row.max(1))
        above = row
    return best


def _skip_numpy(prof, stack, S, height, skip):
    """Each skip variant's result from its definition in csrc/sw_wave_lab.cu."""
    prof = prof.astype(np.int64)
    B, cols = stack.shape[1], (stack.shape[0] - 32) // S
    lane = np.arange(B)[:, None, None]
    column = np.arange(S * cols).reshape(1, S, cols)
    if skip == "subject":
        idx = ((lane + column) & 31).reshape(B * S, cols)
    else:
        idx = stack[: S * cols].T.reshape(B * S, cols).astype(np.int64) & 31
    bands = [prof[b : b + height] for b in range(0, prof.shape[0], height)]
    if skip in ("none", "subject"):
        return _sw_numpy(prof, idx, GAP)
    if skip == "carry":
        return np.max([_sw_numpy(p, idx, GAP) for p in bands], axis=0)
    v, best = np.zeros(idx.shape, np.int64), np.zeros(B * S, np.int64)
    for p in bands:
        v = v + p.max(0)[idx]
        best = np.maximum(best, v.max(1))
    return best


@pytest.mark.parametrize("skip", wave_lab.SKIPS)
@pytest.mark.parametrize("height", [16, 32, 64])
def test_k6_skip_plain_matches_definition(skip, height):
    """At height 64 (K5's and K6's sweep) on K1's profile of three 32-row
    bands: the 64-row split ends in a 32-row band."""
    qlen, pad = (80, 32) if height == 64 else (40, 64)
    q, stack = _chained_bucket(np.random.default_rng(7), qlen, 24, 2, 5)
    prof = make_profile(q, MAT, pad_rows_to=pad)
    assert height != 64 or prof.shape[0] == 96
    got = wave_lab.sw_wave_lab_plain(torch.from_numpy(prof), torch.from_numpy(stack), gap=GAP, n_segs=2,
                                     height=height, skip=skip)
    assert got.dtype == torch.int32 and got.tolist() == _skip_numpy(prof, stack, 2, height, skip).tolist()


# --- the wrappers ---------------------------------------------------------------------


def test_lab_wrappers_run_plain_on_cpu_and_check_inputs():
    q, stack = _chained_bucket(np.random.default_rng(8), 50, 40, 3, 6)
    prof, st = torch.from_numpy(make_profile(q, MAT, pad_rows_to=64)), torch.from_numpy(stack)
    before = (wave_lab.sw_wave_band.launches, wave_lab.sw_wave_prefetch.launches, wave_lab.sw_wave_skip.launches)
    want = wave_lab.sw_wave_lab_plain(prof, st, gap=GAP, n_segs=3)
    assert torch.equal(wave_lab.sw_wave_band(prof, st, gap=GAP, n_segs=3, height=64, block=128), want)
    assert torch.equal(wave_lab.sw_wave_prefetch(prof, st, gap=GAP, n_segs=3, depth=8), want)
    for skip in wave_lab.SKIPS:
        assert torch.equal(wave_lab.sw_wave_skip(prof, st, gap=GAP, n_segs=3, skip=skip),
                           wave_lab.sw_wave_lab_plain(prof, st, gap=GAP, n_segs=3, height=wave_lab.SWEEP_HEIGHT,
                                                      skip=skip))
    assert (wave_lab.sw_wave_band.launches, wave_lab.sw_wave_prefetch.launches,
            wave_lab.sw_wave_skip.launches) == before  # the CPU never launches
    assert wave_lab.pad_profile(prof[:32], 64).shape == (64, 32)
    bad = [
        (lambda: wave_lab.sw_wave_band(prof, st, gap=GAP, n_segs=3, height=48), "height must be"),
        (lambda: wave_lab.sw_wave_band(prof, st, gap=GAP, n_segs=3, block=256), "block must be"),
        (lambda: wave_lab.sw_wave_prefetch(prof, st, gap=GAP, n_segs=3, depth=3), "depth must be"),
        (lambda: wave_lab.sw_wave_skip(prof, st, gap=GAP, n_segs=3, skip="mm"), "skip must be"),
        (lambda: wave_lab.sw_wave_band(prof[:48], st, gap=GAP, n_segs=3, height=32), "multiple of the height"),
        (lambda: wave_lab.sw_wave_band(prof.int(), st, gap=GAP, n_segs=3), "int8"),
        (lambda: wave_lab.sw_wave_band(prof, st.int(), gap=GAP, n_segs=3), "subjT"),
        (lambda: wave_lab.sw_wave_band(prof, st, gap=GAP, n_segs=7), "n_segs"),
        (lambda: wave_lab.sw_wave_band(prof, st, gap=-1, n_segs=3), "gap"),
    ]
    for call, match in bad:
        with pytest.raises(ValueError, match=match):
            call()


@pytest.mark.parametrize("n_bands", [1, 3, 15])
def test_k5_k6_take_k1_profile_unpadded(n_bands):
    """K5 and K6 take K1's profile, rows a multiple of 32: an odd band count
    ends their 64-row sweep in a 32-row band, and every wrapper equals the
    plain version at height 64 on the CPU."""
    rng = np.random.default_rng(n_bands)
    q, stack = _chained_bucket(rng, 32 * n_bands - 5, 20, 2, 4)
    prof, st = torch.from_numpy(make_profile(q, MAT, pad_rows_to=32)), torch.from_numpy(stack)
    assert prof.shape[0] == 32 * n_bands
    want = {skip: wave_lab.sw_wave_lab_plain(prof, st, gap=GAP, n_segs=2, height=wave_lab.SWEEP_HEIGHT, skip=skip)
            for skip in wave_lab.SKIPS}
    assert torch.equal(want["none"], wave_lab.sw_wave_lab_plain(prof, st, gap=GAP, n_segs=2))  # K1's scores
    for d in wave_lab.DEPTHS:
        assert torch.equal(wave_lab.sw_wave_prefetch(prof, st, gap=GAP, n_segs=2, depth=d), want["none"]), d
    for skip in wave_lab.SKIPS:
        assert torch.equal(wave_lab.sw_wave_skip(prof, st, gap=GAP, n_segs=2, skip=skip), want[skip]), skip


def test_k5_k6_refuse_rows_off_k1_bands():
    """A profile whose rows are not a multiple of 32 is refused by K5, K6
    and the plain version at height 64; K4 at height 64 still wants whole
    64-row bands."""
    q, stack = _chained_bucket(np.random.default_rng(3), 40, 20, 1, 4)
    prof, st = torch.from_numpy(make_profile(q, MAT, pad_rows_to=32)), torch.from_numpy(stack)
    for call in (lambda p: wave_lab.sw_wave_prefetch(p, st, gap=GAP), lambda p: wave_lab.sw_wave_skip(p, st, gap=GAP),
                 lambda p: wave_lab.sw_wave_lab_plain(p, st, gap=GAP, height=wave_lab.SWEEP_HEIGHT)):
        with pytest.raises(ValueError, match="multiple of 32"):
            call(prof[:48])
        assert call(prof).shape == (4,)
    with pytest.raises(ValueError, match="multiple of the height 64"):
        wave_lab.sw_wave_band(prof[:32], st, gap=GAP, height=64)


def test_buckets_run_times_in_rounds(monkeypatch):
    """``buckets.run``: every round warms each bucket with the first launch,
    then times every launch once in turns; a bucket's time is the median of
    its rounds, the spread the largest round sum minus the smallest, and
    ``unequal_rounds`` names a variant that differs from the base in any
    round."""
    from swtpu_torch.tools import buckets

    clock = iter([1.0, 2.0, 10.0, 20.0, 3.0, 4.0, 30.0, 40.0, 2.0, 9.0, 20.0, 30.0])  # (bucket, name) in turns
    calls = []
    monkeypatch.setattr(buckets, "events_ms", lambda fn: (next(clock), fn()))

    def launch(name):
        def go(g):
            calls.append((name, g))
            bad = name == "odd" and g == 1 and sum(c == ("odd", 1) for c in calls) == 3  # round 3, bucket 1
            return torch.tensor([g + (1 if bad else 0)])
        return go

    assert buckets.ROUNDS == 3
    res = buckets.run([0, 1], {"base": launch("base"), "odd": launch("odd")})
    assert calls[:5] == [("base", 0), ("base", 0), ("odd", 0), ("base", 1), ("base", 1)]  # warm, then in turns
    assert len(calls) == 3 * 2 * 3
    assert res["times"] == {"base": [2.0, 20.0], "odd": [4.0, 30.0]}
    assert res["round_ms"] == {"base": [11.0, 33.0, 22.0], "odd": [22.0, 44.0, 39.0]}
    assert res["spread_ms"] == {"base": 22.0, "odd": 22.0}
    assert len(res["rounds"]) == 3 and [r["base"] for r in res["rounds"]] == [[torch.tensor([0]), torch.tensor([1])]] * 3
    assert buckets.unequal_rounds(res, ["base", "odd"], "base") == ["odd"]


@pytest.mark.parametrize("tool", ["probe_i16", "probe_breakdown", "wave_lab"])
def test_lab_tools_exit_1_without_cuda(tool, monkeypatch, capsys):
    import importlib

    main = importlib.import_module(f"swtpu_torch.tools.{tool}").main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main() == 1
    assert "no CUDA device" in capsys.readouterr().err


def test_lab_tools_launch_every_variant_at_its_knobs():
    """The lab tools' variants cover every knob, and ``buckets.launches``
    hands each its own height and keywords (each launch equals the plain
    version at that height and skip; those that keep the DP equal K1)."""
    from swtpu_torch import synth
    from swtpu_torch.models.search import SearchEngine
    from swtpu_torch.tools import buckets, probe_breakdown
    from swtpu_torch.tools import wave_lab as wave_lab_tool

    variants = {**wave_lab_tool.VARIANTS, **probe_breakdown.VARIANTS}
    knobs = sorted((fn.__name__, tuple(sorted(kw.items()))) for fn, kw in variants.values())
    assert knobs == sorted([("sw_wave_band", (("block", blk), ("height", h)))
                            for h in wave_lab.HEIGHTS for blk in wave_lab.BLOCKS]
                           + [("sw_wave_prefetch", (("depth", d),)) for d in wave_lab.DEPTHS]
                           + [("sw_wave_skip", (("skip", s),)) for s in wave_lab.SKIPS])
    b = buckets.swissprot_buckets(db=synth.synth_database(200, seed=0), engine=SearchEngine(device="cpu"))
    g = min(b.groups, key=lambda g: g.stack.numel())
    fns = buckets.launches(b, variants)
    assert list(fns) == ["K1", *variants]
    k1 = fns["K1"](g)
    for name, (_, kw) in variants.items():
        want = wave_lab.sw_wave_lab_plain(b.profile(buckets.pad(kw)), g.stack, gap=b.gap, n_segs=g.n_segs,
                                          height=buckets.height(kw), skip=buckets.skip(kw))
        got = fns[name](g)
        assert torch.equal(got, want), name
        if buckets.skip(kw) == "none":
            assert torch.equal(got, k1), name
