"""K10's schedule on K2's warp wavefront, on the CPU.

``sw_rows_v2``, ``sw_rows_v3``, ``sw_rows_v4`` and ``sw_rows_v41``
(``ops/rows_lab.py``) run a copy of K2's warp wavefront
(``csrc/sw_rows_lab.cu``: ``sw_rows_wave_lab_kernel<H, ILP, ROLL, BLOCK>``).
Their launch follows a pure function, ``wave_schedule``: G bands a pass (the
fewest power of two at least the bands, at most 16 at 32-row bands and 32
at 16-row bands), passes, rows a block (the variant's threads a block over
G, times ILP), blocks and the shared stage.  These cases pin that function,
and hold ``_wave_rows`` -- the schedule run step by step in PyTorch: G bands
of 16 or 32 rows a pass, ILP rows a thread group, the carry only between
passes -- exactly to ``rows_lab_plain`` and to ``tools/pallas_lab.py``'s
``sw_v2``, ``sw_v3``, ``sw_v4`` and ``sw_v41`` in interpret mode.  The CUDA
kernel is held to the plain version, and its launch to ``wave_schedule``,
on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swtpu.matrices import blosum50_ref
from swtpu.ops import xla_sw
from swtpu_torch.ops import rows_lab
from swtpu_torch.ops.profile import PAD_SUBJECT, make_profile
from tools import pallas_lab

MAT = blosum50_ref()
WAVE_INSTANCES = list(rows_lab.INSTANCES)  # every instantiation runs the wavefront


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small tensors and many small steps: intra-op threads gain nothing
    here, and next to other test workers on the same cores they contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --- the schedule ---------------------------------------------------------------------


@pytest.mark.parametrize(
    "variant,n_rows,strip,ilp,B,want",
    [
        ("v4", 480, 32, 2, 64, (16, 15, 1, 16, 4)),  # P01008's profile, a 64-row group: 8 / ILP blocks
        ("v4", 480, 32, 4, 64, (16, 15, 1, 32, 2)),
        ("v4", 480, 32, 4, 1408, (16, 15, 1, 32, 44)),
        ("v41", 480, 16, 1, 1408, (32, 30, 1, 8, 176)),  # P01008 at 16-row bands: one pass at G = 32
        ("v41", 464, 16, 1, 64, (32, 29, 1, 8, 8)),  # its 464 rows unpadded: 29 bands
        ("v41", 480, 32, 1, 64, (16, 15, 1, 8, 8)),  # K2's shape
        ("v41", 528, 16, 1, 9, (32, 32, 2, 8, 2)),  # 33 16-row bands: a last pass of one band
        ("v4", 544, 32, 2, 37, (16, 16, 2, 16, 3)),  # 17 32-row bands; 37 rows, 16 a block
        ("v4", 480, 32, 4, 33, (16, 15, 1, 32, 2)),  # one row past a whole block at ILP 4
        ("v4", 20, 32, 4, 5, (1, 1, 1, 512, 1)),  # one band: a thread a group of 4 rows
        ("v41", 40, 16, 1, 300, (4, 3, 1, 64, 5)),
        ("v41", 4548, 16, 1, 19, (32, 32, 9, 8, 3)),  # the suite's longest query: 285 bands
        ("v41", 4548, 32, 1, 19, (16, 16, 9, 8, 3)),
        ("v4", 100, 32, 2, 0, (4, 4, 1, 64, 0)),
        ("v2", 480, 32, 1, 64, (16, 15, 1, 2, 32)),  # P01008, a 64-row group: one-warp blocks on 32 SMs
        ("v2", 480, 16, 1, 64, (32, 30, 1, 1, 64)),  # at 16-row bands a row a block: 64 SMs
        ("v2", 480, 16, 1, 1, (32, 30, 1, 1, 1)),
        ("v2", 20, 32, 1, 40, (1, 1, 1, 32, 2)),  # one band: a thread a row
        ("v3", 480, 16, 1, 1408, (32, 30, 1, 16, 88)),  # 16 rows a stage: 512 threads at G = 32
        ("v3", 480, 32, 1, 1408, (16, 15, 1, 16, 88)),  # 256 threads at G = 16
        ("v3", 480, 32, 1, 64, (16, 15, 1, 16, 4)),
        ("v3", 480, 16, 1, 17, (32, 30, 1, 16, 2)),  # one row past a whole block
        ("v3", 528, 16, 1, 9, (32, 32, 2, 16, 1)),  # 33 16-row bands: a last pass of one band
    ],
)
def test_wave_schedule(variant, n_rows, strip, ilp, B, want):
    sched = rows_lab.wave_schedule(variant, n_rows, strip, ilp, B)
    assert (sched.g, sched.pass_bands, sched.passes, sched.rows_per_block, sched.blocks) == want
    n_bands = -(-n_rows // strip)
    assert (sched.passes - 1) * sched.g < n_bands <= sched.passes * sched.g
    assert sched.rows_per_block == rows_lab.BLOCK_THREADS[variant, strip] // sched.g * ilp
    assert (sched.blocks - 1) * sched.rows_per_block < B <= sched.blocks * sched.rows_per_block or B == 0
    assert sched.stage_bytes == 4 * sched.g * (32 * (strip + 4) + 4)


def test_wave_schedule_follows_k2s_rule_and_records_the_stage():
    from swtpu_torch.ops import bucket_sw

    for n in range(2, 200):  # K2's wavefront rule at 32-row bands (rows_shape below its band-sweep threshold)
        assert rows_lab.wave_schedule("v41", 32 * n, 32, 1, 8).g == bucket_sw.rows_shape(n, 8)[0]
    stages = {(v, s, i): rows_lab.wave_schedule(v, 480, s, i, 64) for v, s, i in WAVE_INSTANCES}
    assert {k: (x.stage_bytes, x.smem_blocks_per_sm, x.rows_per_block) for k, x in stages.items()} == {
        ("v2", 16, 1): (82_432, 2, 1), ("v2", 32, 1): (73_984, 3, 2),  # a warp a block: 32 / G rows a stage
        ("v3", 16, 1): (82_432, 2, 16), ("v3", 32, 1): (73_984, 3, 16),  # 16 rows a stage
        ("v4", 32, 2): (73_984, 3, 16), ("v4", 32, 4): (73_984, 3, 32),  # K2's 74 KB stage at G = 16, 8 x ILP rows
        ("v41", 16, 1): (82_432, 2, 8), ("v41", 32, 1): (73_984, 3, 8)}  # K2's 8 rows a stage
    for bad in [("v2", 480, 16, 2, 8), ("v2", 480, 64, 1, 8), ("v3", 480, 32, 4, 8), ("v3", 480, 8, 1, 8),
                ("v4", 480, 16, 2, 8), ("v4", 480, 32, 1, 8), ("v41", 480, 32, 2, 8), ("v41", 0, 16, 1, 8),
                ("v41", 480, 16, 1, -1), ("v3", 0, 32, 1, 8), ("v2", 480, 32, 1, -1)]:
        with pytest.raises(ValueError, match="no wavefront schedule"):
            rows_lab.wave_schedule(*bad)


@pytest.mark.parametrize(
    "variant,n_rows,strip,ilp,want",
    [("v41", 480, 16, 1, 0), ("v41", 480, 32, 1, 0), ("v4", 480, 32, 4, 0),  # P01008: one pass at either height
     ("v41", 528, 16, 1, 8 * 3 * 64 * 100), ("v4", 544, 32, 2, 8 * 3 * 64 * 100),  # two passes: one carry
     ("v3", 480, 16, 1, 0), ("v2", 480, 32, 1, 0),  # P01008 on the wavefront: one pass, no carry
     ("v2", 528, 16, 1, 8 * 3 * 64 * 100), ("v3", 544, 32, 1, 8 * 3 * 64 * 100)],  # two passes: one carry
)
def test_carry_bytes_follow_the_schedule(variant, n_rows, strip, ilp, want):
    assert rows_lab.carry_bytes(variant, n_rows, strip, 3, 64, 100, ilp=ilp) == want


def test_launch_entry_keeps_its_signature():
    entries = rows_lab._kernel_lib.entries
    assert entries["sw_rows_lab_launch"] == [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    assert entries["sw_rows_lab_schedule"] == [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]


# --- the schedule, run step by step ---------------------------------------------------


def _wave_rows(profile: torch.Tensor, stack: torch.Tensor, *, gap: int, variant: str, strip: int,
               ilp: int) -> torch.Tensor:
    """``wave_schedule`` run step by step in PyTorch over a (C, B, L) stack:
    block k's group j of G threads holds rows (k * groups + j) * ilp .. + ilp
    - 1 (rows past B read row B - 1 and store nothing); a pass is G bands of
    ``strip`` rows; at step t thread b computes column t - b of its band for
    each of its rows and hands its bottom row, the column's residue and the
    row's running best to thread b + 1 for step t + 1; the pass's first band
    reads the carry (the previous pass's last band's bottom row) and its last
    band writes it, between passes only, and keeps the row's best (a max with
    the earlier passes').  A check of the schedule, a Python step a (pass,
    column, band): ``rows_lab_plain``'s scores."""
    prof = rows_lab.pad_profile(profile, strip)
    C, B, L = stack.shape
    sched = rows_lab.wave_schedule(variant, prof.shape[0], strip, ilp, B)
    g, n_bands = sched.g, prof.shape[0] // strip
    groups = rows_lab.BLOCK_THREADS[variant, strip] // g
    k, j, i = torch.meshgrid(torch.arange(sched.blocks), torch.arange(groups), torch.arange(ilp), indexing="ij")
    slot = ((k * groups + j) * ilp + i).reshape(-1)  # the kernel's b0 + i, block by block, group by group
    assert torch.equal(slot.sort().values, torch.arange(slot.numel()))  # every slot once
    assert slot.numel() >= B and slot.numel() - B < sched.rows_per_block
    rows = slot.sort().values.clamp(max=max(B - 1, 0))
    res = stack.long()[:, rows] & (rows_lab.A32 - 1)  # (C, slots, L)
    bands = prof.long().view(n_bands, strip, rows_lab.A32)
    rebase = gap * torch.arange(strip)  # u = v + gap * row
    zero = torch.zeros(C, rows.numel(), dtype=torch.int64)
    out = zero.clone()
    carry = torch.zeros(C, rows.numel(), L, dtype=torch.int64)
    for pas in range(sched.passes):
        band0 = pas * g
        nb = min(g, n_bands - band0)
        last = pas + 1 == sched.passes
        put = torch.zeros_like(carry)
        h = [torch.zeros(C, rows.numel(), strip, dtype=torch.int64) for _ in range(nb)]
        best, top_prev = [zero] * nb, [zero] * nb
        send = [(zero, zero, zero)] * nb  # (residue, bottom, running best) each thread hands on
        for t in range(L + nb - 1):
            recv = send  # the shuffle: thread b reads thread b - 1's step t - 1
            send = list(send)
            for b in range(nb):
                if b == 0:
                    r_res = res[:, :, t] if t < L else zero
                    r_h = carry[:, :, t] if pas > 0 and t < L else zero
                    r_cb = zero
                else:
                    r_res, r_h, r_cb = recv[b - 1]
                c = t - b
                if not 0 <= c < L:
                    send[b] = (r_res, send[b][1], send[b][2])
                    continue
                s = bands[band0 + b][:, r_res].permute(1, 2, 0)  # (C, slots, strip)
                diag = torch.cat([top_prev[b].unsqueeze(-1), h[b][..., :-1]], -1)
                x = torch.maximum(torch.maximum(diag + s, h[b] - gap), torch.zeros_like(s))
                u = torch.maximum(torch.cummax(x + rebase, -1).values, (r_h - gap).unsqueeze(-1))
                h[b] = u - rebase
                best[b] = torch.maximum(best[b], h[b].amax(-1))
                top_prev[b] = r_h
                cb = torch.maximum(best[b], r_cb)
                if b == nb - 1:
                    if c == L - 1:
                        out = cb if pas == 0 else torch.maximum(out, cb)
                    if not last:
                        put[:, :, c] = h[b][..., -1]
                send[b] = (r_res, h[b][..., -1], cb)
        carry = put
    return out[:, :B].to(torch.int32)  # only the slots of real rows store


def _stack(rng, qlen, C, B, L, pad):
    prof = make_profile(rng.integers(0, 25, qlen).astype(np.int8), MAT, pad_rows_to=pad)
    stack = np.full((C, B, L), PAD_SUBJECT, dtype=np.int8)
    for c in range(C):
        for b in range(B - (c == C - 1)):  # the last row of the last chunk stays empty
            n = int(rng.integers(1, L + 1))
            stack[c, b, :n] = rng.integers(0, 25, n)
    return torch.from_numpy(prof), torch.from_numpy(stack)


@pytest.mark.parametrize("variant,strip,ilp", WAVE_INSTANCES)
@pytest.mark.parametrize(
    "qlen,C,B,L,pad",
    [(20, 2, 9, 30, 32),  # one pass of one or two bands
     (530, 2, 5, 23, 1),  # 34 16-row and 17 32-row bands: two passes at each height, a query tail
     (37, 1, 33, 40, 1),  # a tail of 5 (16-row) or 5 (32-row) rows; 33 rows, off every rows-a-block
     (100, 3, 3, 1, 32)],  # one column
)
def test_schedule_run_step_by_step_equals_plain(qlen, C, B, L, pad, variant, strip, ilp):
    prof, stack = _stack(np.random.default_rng(qlen + B), qlen, C, B, L, pad)
    for gap in (2, 120):
        got = _wave_rows(prof, stack, gap=gap, variant=variant, strip=strip, ilp=ilp)
        want = rows_lab.rows_lab_plain(prof, stack, gap=gap)
        assert got.shape == (C, B) and torch.equal(got, want), gap


def _jax_inputs(B, L, Q, seed):
    """``tools/pallas_lab.py``'s inputs, as tests/test_torch_rows_lab.py
    builds them: subjects of L/4 to L residues."""
    rng = np.random.default_rng(seed)
    q = rng.integers(0, 25, Q).astype(np.int8)
    subj = np.full((B, L), PAD_SUBJECT, np.int8)
    for b in range(B):
        n = int(rng.integers(L // 4, L + 1))
        subj[b, :n] = rng.integers(0, 25, n)
    return q, subj


@pytest.mark.parametrize("variant,strip,ilp", WAVE_INSTANCES)
def test_schedule_run_step_by_step_equals_pallas_lab(variant, strip, ilp):
    """``sw_v2`` (tile_b 8) and ``sw_v3`` (tile_b 16) on the block-diagonal
    lhs, ``sw_v4`` (its ILP the port's) and ``sw_v41`` (tile_b 16) with the
    gap folded into the int8 lhs, in interpret mode at JAX strip 8, on a
    16-row bucket of 64 columns and a 40-residue query: the same scores as
    the port's schedule at its own band height."""
    B, L, Q, gap = 16, 64, 40, 2
    q, subj = _jax_inputs(B, L, Q, seed=B + L + Q)
    prof = xla_sw.make_profile(q, MAT, pad_rows_to=8)
    reb = jnp.broadcast_to((jnp.arange(L, dtype=jnp.int32) * gap)[None, :], (B, L))
    lhs = jnp.asarray(pallas_lab.expand_profile_blockdiag(prof + np.int8(gap), 8, 8))
    plain_lhs = jnp.asarray(pallas_lab.expand_profile_blockdiag(prof, 8, 8))
    if variant == "v2":
        want = pallas_lab.sw_v2(plain_lhs, jnp.asarray(subj), reb, gap=gap, strip=8, tile_b=8, interpret=True)
    elif variant == "v3":
        want = pallas_lab.sw_v3(plain_lhs, jnp.asarray(subj), reb, gap=gap, strip=8, tile_b=16, interpret=True)
    elif variant == "v4":
        want = pallas_lab.sw_v4(lhs, jnp.asarray(subj), reb, gap=gap, strip=8, tile_b=16, n_ilp=ilp, interpret=True)
    else:
        want = pallas_lab.sw_v41(lhs, jnp.asarray(subj), reb, gap=gap, strip=8, tile_b=16, interpret=True)
    got = _wave_rows(torch.from_numpy(prof), torch.from_numpy(subj)[None], gap=gap, variant=variant, strip=strip,
                     ilp=ilp)
    assert np.array_equal(got[0].numpy(), np.asarray(want))


def test_pallas_lab_tool_reads_the_kernels_launch(monkeypatch):
    """``--swissprot``'s schedule lines: each instantiation's launch on each
    group as the kernel reports it, which must be ``wave_schedule``'s, the
    SMs the group's blocks fill, and its carry bytes."""
    from swtpu_torch.tools import pallas_lab as tool

    def card(v, n_rows, strip, ilp, B, device):  # the card's report, without a card: the schedule, 2 blocks an SM
        s = rows_lab.wave_schedule(v, n_rows, strip, ilp, B)
        return s.g, s.passes, s.rows_per_block, s.blocks, s.stage_bytes, 2

    monkeypatch.setattr(rows_lab, "card_schedule", card)
    shapes = [(1, 64, 6144), (4, 8192, 896)]
    sched = tool.schedules(480, shapes, sms=132)
    assert list(sched) == list(tool.VARIANTS) and len(sched) == 8
    assert sched["v41/S16"]["launches"][0] == dict(g=32, passes=1, rows_per_block=8, blocks=8, stage_bytes=82_432,
                                                   blocks_per_sm=2, warps_per_sm=16, sms=8)
    assert sched["v2/S16"]["launches"][0] == dict(g=32, passes=1, rows_per_block=1, blocks=64, stage_bytes=82_432,
                                                  blocks_per_sm=2, warps_per_sm=2, sms=64)  # a warp a block
    assert sched["v3/S32"]["launches"][1] == dict(g=16, passes=1, rows_per_block=16, blocks=512,
                                                  stage_bytes=73_984, blocks_per_sm=2, warps_per_sm=16, sms=132)
    assert all(s["carry_bytes"] == 0 for s in sched.values())  # P01008: one pass at either height
    assert len(tool.schedule_lines(sched, shapes)) == 8
    monkeypatch.setattr(rows_lab, "card_schedule", lambda *a: (8,) + card(*a)[1:])
    with pytest.raises(AssertionError, match="not wave_schedule's"):
        tool.schedules(480, shapes, sms=132)
