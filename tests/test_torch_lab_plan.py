"""K4's schedule and K9's launch route, on the CPU.

K4 (``ops/wave_lab.py``) is K1's warp wavefront with two knobs, the band
height and the block.  Its launch follows a pure function,
``band_schedule``: G bands a pass (the next power of two of the bands, at
most 16), lanes a block, blocks, passes and the shared stage.  These cases
pin that function, and hold ``_band_passes`` -- the schedule run
step by step in PyTorch: G bands a pass, the carry only between passes,
chained segments end to end -- exactly to ``sw_wave_lab_plain`` and to
``tools/pallas_wave.py``'s V5 kernel in interpret mode at the W = 32 shape
of ``tests/test_torch_lab.py``.  The CUDA kernel is held to the plain
version on the card (tests/test_torch_gpu.py, chip_smoke.py).

K9's tile kernel (``ops/i16_probe.py``) has ten instantiations, one an
(op, type); its dp_row keeps a window of the 8 columns before each output
column and no row in shared memory, which is exact only if an output column
depends on no earlier column: the plain version shows it does not.  The
launch route's library binding (``_build.Library``, ``_build.load``) is
held to load once and to return a loaded library without its lock.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.matrices import blosum50_ref
from swtpu.ops import xla_sw
from swtpu_torch.ops import _build, i16_probe, wave_lab
from swtpu_torch.ops.profile import PAD_SUBJECT, make_profile
from tools import pallas_wave

GAP = 2
MAT = blosum50_ref()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors and many small steps: intra-op threads gain nothing
    here, and next to other test workers on the same cores they contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- K4's schedule --------------------------------------------------------------------


@pytest.mark.parametrize(
    "n_bands,height,block,lanes,want",
    [
        (1, 32, 32, 7, (1, 32, 1, 1)),  # one band: a thread a lane
        (2, 16, 64, 100, (2, 32, 4, 1)),
        (3, 64, 128, 1000, (4, 32, 32, 1)),
        (15, 32, 128, 40_448, (16, 8, 5056, 1)),  # P01008 at K1's height
        (8, 64, 32, 512, (8, 4, 128, 1)),  # P01008 at H = 64
        (29, 16, 64, 3072, (16, 4, 768, 2)),  # P01008 at H = 16: a last pass of 13 bands
        (143, 32, 128, 300, (16, 8, 38, 9)),  # the suite's longest query
        (285, 16, 32, 1, (16, 2, 1, 18)),
        (72, 64, 64, 33, (16, 4, 9, 5)),
        (16, 32, 64, 0, (16, 4, 0, 1)),
    ],
)
def test_band_schedule(n_bands, height, block, lanes, want):
    sched = wave_lab.band_schedule(n_bands, height, block, lanes)
    assert (sched.g, sched.lanes_per_block, sched.blocks, sched.passes) == want
    assert sched.lanes_per_block * sched.g == block
    assert sched.stage_bytes == 4 * sched.g * (32 * (height + 4) + 4)
    assert (sched.passes - 1) * sched.g < n_bands <= sched.passes * sched.g


def test_band_schedule_follows_k1s_rule_and_refuses_other_knobs():
    from swtpu_torch.ops import wave_sw

    for n in range(1, 200):
        assert wave_lab.band_schedule(n, 32, 128, 10).g == wave_sw.wave_shape(n, 10, 1)[0]
    assert wave_lab.band_schedule(72, 64, 32, 1).stage_bytes == 139_520  # one block an SM at H = 64, G = 16
    for bad in [(0, 32, 64, 1), (4, 48, 64, 1), (4, 32, 256, 1), (4, 32, 64, -1)]:
        with pytest.raises(ValueError, match="no K4 schedule"):
            wave_lab.band_schedule(*bad)


def _band_passes(profile: torch.Tensor, subjT: torch.Tensor, *, gap: int, n_segs: int = 1,
                 height: int = wave_lab.K1_HEIGHT, block: int = wave_lab.K1_BLOCK) -> torch.Tensor:
    """K4's schedule (``wave_lab.band_schedule``) run step by step in PyTorch, on any
    device, every lane at once: a pass is G bands in G threads of a lane;
    at step t thread b computes column t - b of its band and hands its
    bottom row, the column's residue and the segment's running best to
    thread b + 1 for step t + 1; the pass's first band reads the carry
    (the previous pass's last band's bottom row) and its last band writes
    it, between passes only; a lane's segments run end to end, each band
    reset at a segment's first column, and the last band of each pass
    keeps the segment's best (a max with the earlier passes').  A check of
    the schedule, a Python step a (pass, column, band): ``sw_wave``'s
    scores, as ``sw_wave_lab_plain``'s."""
    seg_cols = wave_lab._check(profile, subjT, n_segs, gap, height)
    B = subjT.shape[1]
    total = n_segs * seg_cols
    n_bands = profile.shape[0] // height
    sched = wave_lab.band_schedule(n_bands, height, block, B)
    g, dev = sched.g, subjT.device
    bands = profile.to(torch.int64).view(n_bands, height, wave_lab.A32)
    residues = subjT[:total].long() & (wave_lab.A32 - 1)  # (columns, lanes)
    rebase = gap * torch.arange(height, device=dev).unsqueeze(1)  # (height, 1): u = v + gap * row
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    carry = torch.zeros(total, B, dtype=torch.int64, device=dev)
    out = torch.zeros(B, n_segs, dtype=torch.int64, device=dev)
    for pas in range(sched.passes):
        band0 = pas * g
        nb = min(g, n_bands - band0)
        last = pas + 1 == sched.passes
        put = torch.zeros_like(carry)
        h = [torch.zeros(height, B, dtype=torch.int64, device=dev) for _ in range(nb)]
        best, top_prev = [zero] * nb, [zero] * nb
        col_in_seg, seg = [0] * nb, [0] * nb
        send = [(zero, zero, zero)] * nb  # (residue, bottom, running best) each thread hands on
        for t in range(total + nb - 1):
            recv = send  # the shuffle: thread b reads thread b - 1's step t - 1
            send = list(send)
            for b in range(nb):
                if b == 0:
                    r_res = residues[t] if t < total else send[0][0]
                    r_h = carry[t] if pas > 0 and t < total else zero
                    r_cb = zero
                else:
                    r_res, r_h, r_cb = recv[b - 1]
                c = t - b
                if not 0 <= c < total:
                    send[b] = (r_res, send[b][1], send[b][2])
                    continue
                if col_in_seg[b] == 0:  # a segment's first column: zero left boundary, fresh best
                    h[b] = torch.zeros_like(h[b])
                    best[b], top_prev[b] = zero, zero
                s = bands[band0 + b][:, r_res]  # (height, lanes)
                diag = torch.cat([top_prev[b].unsqueeze(0), h[b][:-1]])
                x = torch.maximum(torch.maximum(diag + s, h[b] - gap), torch.zeros_like(s))
                u = torch.maximum(torch.cummax(x + rebase, 0).values, (r_h - gap).unsqueeze(0))
                h[b] = u - rebase
                best[b] = torch.maximum(best[b], h[b].amax(0))
                top_prev[b] = r_h
                cb = torch.maximum(best[b], r_cb)
                col_in_seg[b] += 1
                if col_in_seg[b] == seg_cols:  # the segment's last column
                    if b == nb - 1:
                        out[:, seg[b]] = cb if pas == 0 else torch.maximum(out[:, seg[b]], cb)
                    col_in_seg[b], seg[b] = 0, seg[b] + 1
                if b == nb - 1 and not last:
                    put[c] = h[b][-1]
                send[b] = (r_res, h[b][-1], cb)
        carry = put
    return out.reshape(-1).to(torch.int32)


def _bucket(rng, qlen, ws, S, B, pad):
    prof = make_profile(rng.integers(0, 25, qlen).astype(np.int8), MAT, pad_rows_to=pad)
    stack = np.full((S * ws + 32, B), PAD_SUBJECT, dtype=np.int8)
    for k in range(B * S - 1):  # the last slot stays empty
        n = int(rng.integers(1, ws + 1))
        stack[(k % S) * ws : (k % S) * ws + n, k // S] = rng.integers(0, 25, n)
    return torch.from_numpy(prof), torch.from_numpy(stack)


@pytest.mark.parametrize("height", wave_lab.HEIGHTS)
@pytest.mark.parametrize(
    "qlen,ws,S,B",
    [(20, 32, 1, 7), (70, 40, 3, 9), (300, 24, 2, 5), (1100, 12, 2, 3), (529, 17, 4, 4)],
)
def test_schedule_run_step_by_step_equals_plain(qlen, ws, S, B, height):
    """One pass and several (a last pass of fewer bands than G at every
    height for 1100 and 529 residues), chained segments of odd widths."""
    prof, stack = _bucket(np.random.default_rng(qlen + S), qlen, ws, S, B, height)
    got = _band_passes(prof, stack, gap=GAP, n_segs=S, height=height, block=64)
    want = wave_lab.sw_wave_lab_plain(prof, stack, gap=GAP, n_segs=S, height=height)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def _run_case_inputs(B, L, Q, seed=0):
    """``tools/pallas_wave.py::run_case``'s query and (B, L) subjects."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 25, Q).astype(np.int8)
    subj = np.full((B, L), xla_sw.PAD_SUBJECT, np.int8)
    for i in range(B):
        n = int(rng.integers(max(L // 4, 1), L + 1))
        subj[i, :n] = rng.integers(0, 25, n)
    return q, subj


@pytest.mark.parametrize("Q", [64, 70])
def test_schedule_run_step_by_step_equals_pallas_wave(Q):
    """The V5 wavefront in interpret mode at W = 32 (its W = 16 slicing
    fails), Lc = 64, g = 8, Bt = 128: the shape of tests/test_torch_lab.py."""
    W, Lc, g, Bt = 32, 64, 8, 128
    q, subj = _run_case_inputs(128, 60, Q)
    subjT = pallas_wave.prep(subj, W, Lc)
    want = np.asarray(pallas_wave.sw_wave(
        jnp.asarray(pallas_wave.build_lhs_banded(xla_sw.make_profile(q, MAT, pad_rows_to=W), W, g)),
        jnp.asarray(subjT), gap=GAP, W=W, Lc=Lc, g=g, Bt=Bt, interpret=True))
    for h in wave_lab.HEIGHTS:
        prof = torch.from_numpy(make_profile(q, MAT, pad_rows_to=h))
        got = _band_passes(prof, torch.from_numpy(np.ascontiguousarray(subjT)), gap=GAP, height=h)
        assert np.array_equal(got.numpy(), want), h


# --- K9 ---------------------------------------------------------------------------------


def test_tile_instances_are_every_op_and_type():
    assert len(i16_probe.TILE_INSTANCES) == 10
    assert sorted(i16_probe.TILE_INSTANCES, key=str) == sorted(
        ((op, dt) for op in i16_probe.OPS for dt in (torch.int16, torch.int32)), key=str)
    assert [i16_probe._CODE[op] for op in i16_probe.OPS] == list(range(5))  # the kernel table's op index


@pytest.mark.parametrize("dtype", i16_probe.DTYPES)
@pytest.mark.parametrize("c", [0, 3, 7, 8, 9, 40, 63])
def test_dp_row_column_reads_only_eight_columns_back(dtype, c):
    """dp_row's column c is a function of a's columns c - 8 .. c and b's
    c - 7 .. c (and the row's start): the window the tile kernel loads."""
    rng = np.random.default_rng(c)
    lo, hi = (-32768, 32768) if dtype == torch.int16 else (-(2**31), 2**31)
    a, b = (torch.from_numpy(rng.integers(lo, hi, (3, 64))).to(dtype) for _ in range(2))
    want = i16_probe.i16_op_plain(a, b, "dp_row")[:, c]
    a2, b2 = a.clone(), b.clone()
    a2[:, : max(c - 8, 0)] = torch.from_numpy(rng.integers(lo, hi, (3, max(c - 8, 0)))).to(dtype)
    b2[:, : max(c - 7, 0)] = torch.from_numpy(rng.integers(lo, hi, (3, max(c - 7, 0)))).to(dtype)
    a2[:, c + 1 :], b2[:, c + 1 :] = 0, 0
    assert torch.equal(i16_probe.i16_op_plain(a2, b2, "dp_row")[:, c], want)


@pytest.mark.parametrize("dtype", i16_probe.DTYPES)
def test_dp_row_window_is_needed(dtype):
    """Column c - 8 of a does reach column c (d shifts a by one column, and
    three max steps reach 7 more), and column c - 9 does not: the window is
    no narrower and no wider than it needs to be."""
    a = torch.full((1, 16), -10000, dtype=dtype)
    b = torch.full((1, 16), -10000, dtype=dtype)
    base = i16_probe.i16_op_plain(a, b, "dp_row")[0, 12]
    a[0, 4] = 20000  # d at column 5 is a[4]: t[5] = d + b rises, and column 12 takes the max of t[5 .. 12]
    assert i16_probe.i16_op_plain(a, b, "dp_row")[0, 12] > base
    a[0, 4], a[0, 3] = -10000, 20000
    assert i16_probe.i16_op_plain(a, b, "dp_row")[0, 12] == base


# --- the launch route ------------------------------------------------------------------------


def test_library_binds_once_and_skips_the_lock_once_loaded():
    from swtpu_torch import native

    first = native._lib()  # the host library (g++ builds it here), bound with all its entry points
    assert native._lib() is first and _build.load("sw_native") is first
    got = []
    with _build._load_lock:  # a loaded library comes back while another thread holds the lock
        t = threading.Thread(target=lambda: got.append(_build.load("sw_native")))
        t.start()
        t.join(timeout=10)
    assert got == [first]


def test_module_libraries_are_bound_at_import():
    from swtpu_torch.ops import bucket_sw, int8_mma, rows_lab, wave_sw

    for mod in (bucket_sw, int8_mma, rows_lab, wave_sw, wave_lab, i16_probe):
        assert isinstance(mod._kernel_lib, _build.Library)
        assert mod._kernel_lib.entries and mod._kernel_lib.name == {
            "bucket_sw": "sw_rows", "int8_mma": "int8_mma", "rows_lab": "sw_rows_lab", "wave_sw": "sw_wave",
            "wave_lab": "sw_wave_lab", "i16_probe": "i16_probe"}[mod.__name__.rsplit(".", 1)[1]]
    assert wave_lab._kernel_lib.entries["sw_wave_lab_launch"][-2:] == [wave_lab.ctypes.c_int, wave_lab.ctypes.c_void_p]
    assert len(wave_lab._kernel_lib.entries["sw_wave_lab_launch"]) == 16  # g before the device and the stream
