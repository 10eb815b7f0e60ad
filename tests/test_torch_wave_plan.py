"""The launch plans of the redesigned kernels, and plain executions of them.

K1 (``csrc/sw_wave.cu``) scores a launch's 32-row bands in passes of G bands
of H rows, a warp wavefront with the band-to-band carry in registers: only a
pass boundary or a hand-off goes through the carry in device memory.  Its
plan is pure Python (``wave_sw.wave_shape``, ``wave_sw.n_passes``,
``wave_sw.carry_bytes``), and here a plain execution of that plan -- band by
band with ``wave_sw._sw_rows``/``_sw_rows_affine``, pass by pass through a
carry -- is held to ``sw_wave_plain`` and, for hand-off chains, to swtpu's
interpret-mode ``sw_wave(top_in, return_carry=True)``.  Every comparison is
exact.  K7's coarse pass (``csrc/int8_mma.cu``) runs on the persistent grid
``int8_mma.coarse_grid`` lays out.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.matrices import blosum50_ref
from swtpu.ops import wave_sw as jwave
from swtpu.ops import xla_sw
from swtpu_torch.config import SWConfig
from swtpu_torch.models import search as tsearch
from swtpu_torch.models.search import SearchEngine
from swtpu_torch.ops import int8_mma, wave_sw
from swtpu_torch.tools.card_fuzz import band_split

W = wave_sw.W
MAT = blosum50_ref()
A32 = 32


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors: intra-op threads gain nothing here and contend with
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bucket(rng, qlen, qpad, ws, S, B):
    prof = xla_sw.make_profile(rng.integers(0, 25, qlen).astype(np.int8), MAT, pad_rows_to=qpad)
    stack = np.full((S * ws + W, B), xla_sw.PAD_SUBJECT, dtype=np.int8)
    for k in range(B * S - 1):  # the last slot stays empty
        n = int(rng.integers(1, ws + 1))
        stack[(k % S) * ws : (k % S) * ws + n, k // S] = rng.integers(0, 25, n)
    return prof, stack


def plan_plain(profile, subjT, n_segs, gaps, g, h, top_in=None):
    """The kernel's plan on the CPU: every pass's bands in order, each band
    of H rows (the last one of a launch maybe 32) run by the band recurrence
    from the band above's bottom row, the pass's first band from the carry
    the previous pass (or ``top_in``) left.  Returns the (B * n_segs,)
    scores and the last band's bottom row as a carry, (cols, B[, 2])."""
    B = subjT.shape[1]
    seg_cols = (subjT.shape[0] - W) // n_segs
    idx = subjT[: n_segs * seg_cols].T.reshape(B * n_segs, seg_cols).long() & (A32 - 1)
    prof = profile.to(torch.int32)
    affine = gaps[1] is not None
    top = None if top_in is None else top_in.transpose(0, 1).reshape(B * n_segs, seg_cols, *top_in.shape[2:])
    best = torch.zeros(B * n_segs, dtype=torch.int32)
    n_rows = profile.shape[0]
    assert wave_sw.n_passes(n_rows // W, g, h) == len(range(0, n_rows, g * h))
    for row0 in range(0, n_rows, g * h):
        carry = top  # what the pass's first band reads: device memory in the kernel
        for r in range(row0, min(row0 + g * h, n_rows), h):
            rows = prof[r : min(r + h, n_rows)]
            if affine:
                b, hh, ff = wave_sw._sw_rows_affine(rows, idx, *gaps, top=carry)
                carry = torch.stack([hh, ff], dim=-1)
            else:
                b, carry = wave_sw._sw_rows(rows, idx, gaps[0], top=carry)
            best = torch.maximum(best, b)
        top = carry
    out = top.reshape(B, n_segs * seg_cols, *top.shape[2:]).transpose(0, 1).contiguous()
    return best, out


# --- the shape and the passes -------------------------------------------------------------


@pytest.mark.parametrize("n_bands", [1, 2, 3, 8, 15, 143])
@pytest.mark.parametrize("lanes,n_segs", [(1, 1), (128, 1), (512, 1), (5376, 6), (40448, 1), (2560, 3), (8704, 2)])
@pytest.mark.parametrize("affine", [False, True])
def test_wave_shape_is_a_compiled_shape(n_bands, lanes, n_segs, affine):
    g, h = wave_sw.wave_shape(n_bands, lanes, n_segs, affine)
    assert (g, h) in wave_sw.SHAPES
    threshold = wave_sw.BAND_THREADS_AFFINE if affine else wave_sw.BAND_THREADS
    if lanes * n_segs >= threshold:  # a bucket of many (lane, segment) pairs: the band sweep
        assert (g, h) == (1, wave_sw.BAND_H[affine])
    else:  # the fewest bands a pass that take the launch in one pass, at most 16
        assert h == W and g == min(16, 1 << (n_bands - 1).bit_length())
        assert wave_sw.n_passes(n_bands, g, h) == -(-n_bands // 16)


@pytest.mark.parametrize("n_bands", [1, 2, 15, 143])
@pytest.mark.parametrize("affine", [False, True])
def test_wave_shape_band_threshold(n_bands, affine):
    """The threshold wave_ab.py moves: from 0 pairs every launch takes the
    band sweep, below a bucket's pairs every launch of more than one band
    takes the wavefront."""
    assert wave_sw.wave_shape(n_bands, 5, 2, affine, band_threads=0) == (1, wave_sw.BAND_H[affine])
    g, h = wave_sw.wave_shape(n_bands, 40448, 6, affine, band_threads=10**9)
    assert (g, h) == ((1, W) if n_bands == 1 else (min(16, 1 << (n_bands - 1).bit_length()), W))
    assert wave_sw.wave_shape(n_bands, 100, 3, affine, band_threads=300) == (1, wave_sw.BAND_H[affine])


@pytest.mark.parametrize(
    "n_bands,g,h,want",
    [
        (15, 16, 32, 1),  # P01008: one pass of 15 bands, one thread of the group idle
        (16, 16, 32, 1),
        (17, 16, 32, 2),  # a second pass of one band
        (3, 4, 32, 1),  # fewer bands than G
        (16, 8, 32, 2),
        (143, 16, 32, 9),  # 4,548 aa: eight pass boundaries
        (7, 2, 32, 4),
        (15, 1, 64, 8),  # the band sweep at H = 64: seven pairs and a 32-row tail band
        (1, 1, 64, 1),  # a one-band rung under H = 64: the tail alone
        (5, 1, 32, 5),
    ],
)
def test_n_passes(n_bands, g, h, want):
    assert wave_sw.n_passes(n_bands, g, h) == want


@pytest.mark.parametrize("args", [(0, 8, 32), (3, 1, 48), (3, 0, 32)])
def test_n_passes_rejects(args):
    with pytest.raises(ValueError):
        wave_sw.n_passes(*args)


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("hand_off", [False, True])
def test_carry_bytes_follow_the_passes(affine, hand_off):
    lanes, n_segs, seg_cols = 96, 3, 40
    g, h = wave_sw.wave_shape(16, lanes, n_segs, affine)
    full = 4 * (2 if affine else 1) * n_segs * seg_cols * lanes
    one_pass, two_passes = g * h // W, g * h // W + 1
    assert one_pass == 16
    # Without a hand-off the int16x2 kernel runs: int16 slots, and its
    # rescore's int32 slots for 8 entries a block of 1,024 (lane, segment)
    # pairs once the rescore's 16-band passes are two.
    rescore = 4 * (2 if affine else 1) * seg_cols * 8 * 1
    assert wave_sw.carry_bytes(1, n_segs, seg_cols, lanes, affine, hand_off) == (full if hand_off else 0)
    assert wave_sw.carry_bytes(one_pass, n_segs, seg_cols, lanes, affine, hand_off) == (full if hand_off else 0)
    assert wave_sw.carry_bytes(two_passes, n_segs, seg_cols, lanes, affine, hand_off) == (
        full if hand_off else full // 2 + rescore)
    assert wave_sw.carry_bytes(two_passes, n_segs, seg_cols, lanes, affine, hand_off, int16=False) == full
    assert wave_sw.carry_bytes(one_pass, n_segs, seg_cols, lanes, affine, hand_off, int16=False) == (
        full if hand_off else 0)


@pytest.mark.parametrize("shape,split", [(None, False), ((1, W), True)])
def test_piece_scratch_split_follows_the_passes(monkeypatch, shape, split):
    """A multi-query piece whose bands fit in one pass needs no carry, so
    even a zero scratch budget keeps it in one launch; with one band a pass
    the same piece needs a carry a query and goes one query a launch."""
    if shape is not None:
        monkeypatch.setattr(wave_sw, "wave_shape", lambda n_bands, lanes, n_segs, affine=False: shape)
    monkeypatch.setattr(tsearch, "scratch_budget_bytes", lambda device: 1)
    rng = np.random.default_rng(5)
    prof = torch.from_numpy(np.stack([_bucket(rng, 60, 96, 40, 1, 8)[0] for _ in range(3)]))
    _, stack = _bucket(rng, 60, 96, 40, 2, 8)
    stack = torch.from_numpy(stack)
    group = type("G", (), dict(parts=(stack,), stack=stack, n_segs=2, seg_cols=40, lanes=8))()
    calls = []
    real = wave_sw.sw_wave

    def spy(profile, subjT, **kw):
        calls.append(tuple(profile.shape))
        return real(profile, subjT, **kw)

    monkeypatch.setattr(wave_sw, "sw_wave", spy)
    eng = SearchEngine(SWConfig(), device="cpu")
    out = eng._packed_step(prof, [group])
    assert calls == ([(1, 96, 32)] * 3 if split else [(3, 96, 32)])
    assert torch.equal(out, wave_sw.sw_wave_plain(prof, group.stack, gap=2, n_segs=2))


# --- a plain execution of K1's plan -------------------------------------------------------

PLAN_CASES = [
    # (qlen, qpad, ws, S, B, g, h)
    (40, 64, 96, 1, 16, 2, 32),  # one pass of two bands
    (70, 96, 48, 2, 8, 1, 64),  # the band sweep, 3 bands: one of 64 and a 32-row tail
    (150, 160, 40, 3, 9, 4, 32),  # 5 bands: a pass of four, then one of one
    (200, 224, 30, 4, 5, 2, 32),  # 7 bands, passes of two, seg_cols 30
    (100, 128, 20, 5, 7, 8, 32),  # four bands of eight, five chained segments
    (33, 64, 5, 6, 11, 8, 32),  # seg_cols 5, shorter than G
    (470, 480, 40, 3, 9, 16, 32),  # P01008's 15 bands in one pass of 16
    (300, 320, 24, 2, 6, 8, 32),  # 10 bands: a pass of 256 rows, then one of 64
    (150, 160, 40, 3, 9, 1, 64),  # the band sweep: bands of 64, 64 and a 32-row tail, each a pass
    (100, 128, 20, 5, 7, 1, 32),  # the band sweep at 32 rows
]


@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("qlen,qpad,ws,S,B,g,h", PLAN_CASES)
def test_plan_plain_equals_sw_wave_plain(affine, qlen, qpad, ws, S, B, g, h):
    gaps = (10, 2) if affine else (2, None)
    kw = dict(gap_open=10, gap_extend=2) if affine else dict(gap=2)
    rng = np.random.default_rng(qlen + ws + affine)
    prof, stack = (torch.from_numpy(a) for a in _bucket(rng, qlen, qpad, ws, S, B))
    best, carry = plan_plain(prof, stack, S, gaps, g, h)
    assert torch.equal(best, wave_sw.sw_wave_plain(prof, stack, n_segs=S, **kw))
    scores, want = wave_sw.sw_wave_plain(prof, stack, n_segs=S, return_carry=True, **kw)
    assert torch.equal(best, scores) and torch.equal(carry, want)


def _to_swtpu_carry(carry, L2, Bt, affine):
    """The port's (cols, B[, 2]) carry as swtpu's (B/Bt, [2,] L2+w, Bt), row
    = column + w; rows of no port column hold H = 0 and F = NEG."""
    cols, B = carry.shape[:2]
    planes = np.moveaxis(carry, -1, 0) if affine else carry[None]
    out = np.zeros((planes.shape[0], L2 + W, B), np.int32)
    if affine:
        out[1] = wave_sw.NEG
    out[:, W : W + cols] = planes
    out = out.reshape(planes.shape[0], L2 + W, B // Bt, Bt).transpose(2, 0, 1, 3)
    return out if affine else out[:, 0]


def _from_swtpu_carry(carry, cols, affine):
    c = np.asarray(carry)
    c = c if affine else c[:, None]
    tiles, n_planes, LT, Bt = c.shape
    planes = c.transpose(1, 2, 0, 3).reshape(n_planes, LT, tiles * Bt)[:, W : W + cols]
    return np.moveaxis(planes, 0, -1) if affine else planes[0]


@pytest.mark.parametrize(
    "gaps,qlen,qpad,ws,S,g,h",
    [
        ("linear", 200, 224, 96, 1, 1, 64),  # 7 bands as slices (2, 2, 2, 1): the last a tail alone under H = 64
        ("affine", 280, 288, 96, 1, 2, 32),  # slices (3, 2, 2, 2): a slice of two passes, then one-pass slices
        ("linear", 150, 160, 48, 2, 2, 32),  # slices (2, 1, 1, 1) on chained segments
    ],
)
def test_plan_plain_hand_off_chain_matches_swtpu(gaps, qlen, qpad, ws, S, g, h):
    """Slice by slice, in query_shard's band split (``card_fuzz.band_split``):
    each slice run through the plan from the previous slice's carry gives
    swtpu's interpret-mode scores and carry from the same top (every column
    but the last of a segment followed by another, where swtpu's separator
    sweep cuts the vertical chain: tests/test_torch_compose.py)."""
    affine = gaps == "affine"
    gap_pair = (10, 1) if affine else (2, None)
    kw = dict(gap_open=10, gap_extend=1) if affine else dict(gap=2)
    rng = np.random.default_rng(qlen + 3 * affine)
    B = 8
    prof, stack = _bucket(rng, qlen, qpad, ws, S, B)
    cols, L2 = S * ws, stack.shape[0]
    carry = wave_sw.virgin_carry(torch.from_numpy(stack), affine)
    sep = [(s + 1) * ws - 1 for s in range(S - 1)]
    rest = np.setdiff1d(np.arange(cols), sep)
    band = 0
    for rung in band_split(qpad // W):
        part = prof[band * W : (band + rung) * W]
        j_top = jnp.asarray(_to_swtpu_carry(carry.numpy(), L2, 8, affine))
        j_scores, j_carry = jwave.sw_wave(
            jnp.asarray(jwave.build_lhs_banded(part)), jnp.asarray(stack), j_top,
            Lc=64 if S == 1 else 32, Bt=8, n_segs=S, interpret=True, return_carry=True, **kw,
        )
        scores, carry = plan_plain(torch.from_numpy(part), torch.from_numpy(stack), S, gap_pair, g, h, top_in=carry)
        assert np.array_equal(scores.numpy(), np.asarray(j_scores))
        got, want = carry.numpy(), _from_swtpu_carry(j_carry, cols, affine)
        assert np.array_equal(got[rest], want[rest]) and (got[sep] >= want[sep]).all()
        band += rung


# --- K7's coarse pass: the grid ------------------------------------------------------------


@pytest.mark.parametrize(
    "n,Q,sms,want",
    [
        (559_228, 1, 132, (132, 1)),  # SwissProt: one block an SM, 4,369 tiles
        (559_228, 17, 132, (132, 1)),
        (1, 1, 132, (1, 1)),  # one tile
        (100_003, 33, 132, (66, 2)),  # two query groups share the SMs
        (4097, 17, 132, (33, 1)),  # fewer tiles than SMs: a block a tile
        (300, 70, 2, (1, 3)),  # more query groups than SMs: one block a group
    ],
)
def test_coarse_grid(n, Q, sms, want):
    grid = int8_mma.coarse_grid(n, Q, sms)
    assert grid == want
    # what the launcher accepts: every query group, one to ceil(n / 128) blocks walking tiles
    assert grid[1] * int8_mma.COARSE_QUERIES >= Q > (grid[1] - 1) * int8_mma.COARSE_QUERIES
    assert 1 <= grid[0] <= -(-n // int8_mma.COARSE_ROWS)
