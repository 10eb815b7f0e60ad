"""Wavefront Smith-Waterman scoring of one or Q queries against a transposed bucket.

Counterpart of ``swtpu.ops.wave_sw.sw_wave`` in its linear and affine
(Gotoh) modes, for one query or Q, and in its band-carry hand-off.  A
bucket is a ``(L2, B)`` int8 array of subjects laid along lanes (``L2 =
width + W``, the last ``W`` columns pad); with ``n_segs > 1``
each lane holds ``n_segs`` subjects end to end in equal segments of
``seg_cols = (L2 - W) / n_segs`` columns.  The result is the exact int32
Smith-Waterman maximum of each (lane, segment), flat and lane-major:
``out[lane * n_segs + seg]``.  A ``(Q, qpad, 32)`` stack of profiles scores Q
queries in one launch (swtpu's 4-D ``lhsB``) and gives ``(Q, B * n_segs)``.
Gaps are linear (``gap=``) or affine (``gap_open=``, ``gap_extend=``: a
length-L gap costs ``gap_open + (L-1) * gap_extend``).

Band-carry hand-off (one query): a query's bands can be scored as a chain of
calls, each on a group of its profile's bands.  ``top_in`` seeds band 0's top
boundary with a previous call's carry instead of H = 0 (and F = NEG), and
``return_carry`` returns this call's last band's bottom row as the next
call's ``top_in``.  The carry is ``(n_segs * seg_cols, B)`` int32 H, or
``(n_segs * seg_cols, B, 2)`` int32 (H, F) under affine gaps, row = the
bucket column (swtpu's ``(B/Bt, L2+w, Bt)`` tiles with row = column + w are
a TPU layout); ``virgin_carry`` makes the one a chain starts from.  A call
overwrites ``top_in`` in place with the new carry, and with ``return_carry``
returns that same tensor.

``sw_wave`` launches the hand-written CUDA kernels (``csrc/sw_wave.cu``) for
tensors on the card and runs ``sw_wave_plain`` for tensors on the CPU.  It
never swaps one for the other: a CUDA tensor either reaches the kernels or
raises.  The kernels score a launch's bands in passes of G bands of H rows
(``wave_shape`` picks (G, H) per launch unless ``shape=`` forces one of
``SHAPES``; ``n_passes`` counts the passes): a warp wavefront with the
band-to-band carry in registers, or, on a bucket of many (lane, segment)
pairs and for a single band, a sweep of one band at a time (G = 1).  Only a pass boundary or a hand-off goes through the carry in
device memory.

A launch without a hand-off, whose gaps are at most ``I16_GAP_MAX``, runs
the int16x2 kernel (two cells a 32-bit register, Hopper's DPX
instructions), which flags every (query, lane, segment) whose int16 best
passed 32,640 (below that nothing can have wrapped), and then the int32
rescore of the flagged entries on the card, before anything reads the
scores: no host sync, one launch more.  The rescore adds its count to a
running total on the device (``rescore_counter``).  A hand-off, whose carry
is an int32 contract with its caller, and larger gaps run the int32 kernel.
Either way the scores are exact int32.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from ..alphabet import PADDED_ALPHABET_SIZE as A32
from . import _build
from .profile import PAD_SUBJECT

W = 32  # query rows per band, and the trailing pad columns of every bucket
NEG = -(1 << 30)  # minus infinity of the affine E and F boundaries (swtpu's NEG)

# --- Bucket layout parameters -----------------------------------------------
# These are TPU-derived (the Pallas kernel's chunk ladder and lane tiles,
# measured on a TPU v5e) and a later PR re-tunes them for Hopper.  They shape
# the buckets, not the scores; keeping them makes the packed layout identical
# to swtpu's so the two packages can be compared bucket for bucket.
LC_LADDER = (256, 224, 192, 160, 128, 96, 64)
BT_SPEED = {512: 1.0, 256: 0.96, 128: 0.88}


def has_lc(need: int) -> bool:
    """True iff a padded length `need` = width + w divides by a ladder Lc."""
    return any(need % lc == 0 for lc in LC_LADDER)


def pick_lc(width: int, w: int = W) -> int:
    """Column-chunk size of the TPU kernel for a bucket of width `width`."""
    need = width + w
    for lc in LC_LADDER:
        if need % lc == 0:
            return lc
    return 64


def pick_bt_div(n_rows: int, w: int = W) -> int:
    """Largest lane tile that exactly divides a padded lane count."""
    cap = 512 if w <= 32 else 256
    for bt in (512, 256, 128):
        if bt <= cap and n_rows % bt == 0:
            return bt
    raise ValueError(f"lane count {n_rows} is not a multiple of 128")


def pick_lanes(n_rows: int, lane_multiple: int = 1, w: int = W):
    """(Bt, padded lane count) maximising modeled true-cell throughput."""
    best = None
    for bt in (512, 256, 128):
        quant = bt * lane_multiple
        bpad = -(-max(n_rows, 1) // quant) * quant
        bt_eff = pick_bt_div(bpad // lane_multiple, w)
        eff = n_rows / bpad * BT_SPEED[bt_eff]
        if best is None or eff > best[0]:
            best = (eff, bt_eff, bpad)
    return best[1], best[2]


# --- Scoring ------------------------------------------------------------------

# (gap, None) for linear gaps, (gap_open, gap_extend) for affine ones.
Gaps = Tuple[int, Optional[int]]


def gap_model(gap: Optional[int], gap_open: Optional[int], gap_extend: Optional[int]) -> Gaps:
    """Validate the gap arguments of sw_wave: ``gap=`` alone (linear) or
    ``gap_open=`` with ``gap_extend=`` (affine), as swtpu's sw_wave takes
    them; the affine plain version needs ``gap_open >= gap_extend >= 0``."""
    if gap_open is None:
        if gap_extend is not None:
            raise ValueError("gap_extend requires gap_open")
        if gap is None:
            # A silently defaulted 0 would score every alignment with free gaps.
            raise ValueError("sw_wave requires gap= (linear) or gap_open/gap_extend (affine)")
        if gap < 0:
            raise ValueError("gap must be >= 0")
        return gap, None
    if gap_extend is None:
        raise ValueError("gap_open requires gap_extend")
    if gap is not None:
        raise ValueError("pass gap= (linear) or gap_open/gap_extend (affine), not both")
    if not gap_open >= gap_extend >= 0:
        raise ValueError("affine gaps need gap_open >= gap_extend >= 0")
    return gap_open, gap_extend


def _check(profile: torch.Tensor, subjT: torch.Tensor, n_segs: int) -> int:
    """Validate the kernel's contract; returns seg_cols."""
    if profile.dtype != torch.int8 or profile.dim() not in (2, 3) or profile.shape[-1] != A32:
        raise ValueError(
            f"profile must be (qpad, {A32}) or (Q, qpad, {A32}) int8, got {tuple(profile.shape)} {profile.dtype}"
        )
    if profile.shape[-2] == 0 or profile.shape[-2] % W:
        raise ValueError(f"profile rows {profile.shape[-2]} must be a positive multiple of {W}")
    if profile.dim() == 3 and profile.shape[0] == 0:
        raise ValueError("a profile stack needs at least one query")
    if subjT.dtype != torch.int8 or subjT.dim() != 2:
        raise ValueError(f"subjT must be (L2, B) int8, got {tuple(subjT.shape)} {subjT.dtype}")
    if profile.device != subjT.device:
        raise ValueError(f"profile on {profile.device} but subjT on {subjT.device}")
    if not (profile.is_contiguous() and subjT.is_contiguous()):
        raise ValueError("profile and subjT must be contiguous")
    cols = subjT.shape[0] - W
    if n_segs < 1 or cols < n_segs or cols % n_segs:
        raise ValueError(f"n_segs={n_segs} must divide the column count {cols}")
    return cols // n_segs


def _carry_shape(subjT: torch.Tensor, affine: bool) -> Tuple[int, ...]:
    cols, lanes = subjT.shape[0] - W, subjT.shape[1]
    return (cols, lanes, 2) if affine else (cols, lanes)


def _check_hand_off(profile, subjT, top_in, return_carry: bool, affine: bool) -> None:
    if top_in is None and not return_carry:
        return
    if profile.dim() == 3:
        raise ValueError("top_in / return_carry band-carry hand-off requires a single query")
    if top_in is None:
        return
    want = _carry_shape(subjT, affine)
    if top_in.dtype != torch.int32 or tuple(top_in.shape) != want:
        raise ValueError(f"top_in must be {want} int32, got {tuple(top_in.shape)} {top_in.dtype}")
    if top_in.device != subjT.device:
        raise ValueError(f"top_in on {top_in.device} but subjT on {subjT.device}")
    if not top_in.is_contiguous() or top_in.data_ptr() % 8:
        raise ValueError("top_in must be contiguous and 8-byte aligned")


def virgin_carry(subjT: torch.Tensor, affine: bool = False) -> torch.Tensor:
    """The carry a chain starts from, on subjT's device: no band above, so
    H = 0 and, under affine gaps, F = NEG (no gap may start above band 0)."""
    carry = torch.zeros(_carry_shape(subjT, affine), dtype=torch.int32, device=subjT.device)
    if affine:
        carry[..., 1] = NEG
    return carry


def sw_wave(
    profile: torch.Tensor,
    subjT: torch.Tensor,
    top_in: Optional[torch.Tensor] = None,
    *,
    gap: Optional[int] = None,
    n_segs: int = 1,
    gap_open: Optional[int] = None,
    gap_extend: Optional[int] = None,
    return_carry: bool = False,
    shape: Optional[Tuple[int, int]] = None,
):
    """Exact int32 SW max of one or Q query profiles vs every (lane, segment).

    Args:
      profile: (qpad, 32) int8 query profile (swtpu_torch.ops.profile), or a
        (Q, qpad, 32) stack of Q equal-length profiles; qpad % W == 0.
      subjT: (L2, B) int8 transposed bucket, pads PAD_SUBJECT.
      top_in: a previous band group's carry (module docstring), read as
        band 0's top boundary and overwritten; one query only.
      gap: linear gap penalty.
      n_segs: subjects chained per lane.
      gap_open, gap_extend: affine (Gotoh) gaps instead of ``gap``: a
        length-L gap costs gap_open + (L-1) * gap_extend.
      return_carry: also return the last band's bottom row, the next band
        group's ``top_in`` (``top_in`` itself when given); one query only.
      shape: the kernel's (G, H), one of ``SHAPES``, instead of
        ``wave_shape``'s choice (swtpu's explicit ``Lc``/``Bt``); it changes
        no score.  ValueError for any other.

    Returns:
      (B * n_segs,) int32 on the inputs' device, lane-major; (Q, B * n_segs)
      for a profile stack; with return_carry, a (scores, carry) tuple.
    """
    gaps = gap_model(gap, gap_open, gap_extend)
    seg_cols = _check(profile, subjT, n_segs)
    _check_hand_off(profile, subjT, top_in, return_carry, gaps[1] is not None)
    check_shape(shape, SHAPES)
    if subjT.device.type == "cpu":
        return _plain(profile, subjT, gaps, n_segs, seg_cols, top_in, return_carry)
    if subjT.device.type != "cuda":
        raise ValueError(f"sw_wave runs on CPU or CUDA tensors, not {subjT.device}")
    return _sw_wave_cuda(profile, subjT, gaps, n_segs, seg_cols, top_in, return_carry, shape)


sw_wave.launches = 0  # kernel launches since the count was last set to 0
sw_wave.multi_launches = 0  # of those, launches with a (Q, qpad, 32) profile stack
sw_wave.affine_launches = 0  # of those, launches with affine gaps
sw_wave.carry_launches = 0  # of those, launches with top_in or return_carry


sw_wave.int16_launches = 0  # of those, launches of the int16x2 kernel (each followed by its rescore)
sw_wave.rescore_launches = 0  # rescore launches after the int16x2 kernel, one each


_kernel_lib = _build.Library(
    "sw_wave",
    sw_wave_launch=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p],
    sw_wave_affine_launch=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
    sw_wave16_launch=[ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
    sw_wave16_affine_launch=[ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p],
)

# The int16x2 kernel's reach: gaps up to I16_GAP_MAX keep its E and F
# sentinels (-16384) from wrapping; a best above SAT16 may have wrapped and
# is rescored in int32 (csrc/sw_wave.cu).
I16_GAP_MAX = 16383
SAT16 = 32767 - 127
# The rescore: a block scans RESCORE_SPAN (lane, segment) entries of a
# query's output and scores what it finds RESCORE_SLOTS at a time, on the
# int32 wavefront at RESCORE_G bands a pass.
RESCORE_SPAN, RESCORE_SLOTS, RESCORE_G = 1024, 8, 16

_counters: dict = {}
_counters_lock = threading.Lock()


def rescore_counter(device) -> torch.Tensor:
    """The device's running total of entries the int16x2 path rescored in
    int32: a one-element int64 tensor on ``device``, created at 0 on first
    use, to which every rescore launch on that device adds its count."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _counters_lock:
        if dev not in _counters:
            _counters[dev] = torch.zeros(1, dtype=torch.int64, device=dev)
        return _counters[dev]


def uses_int16(gaps: Gaps, hand_off: bool) -> bool:
    """Whether a CUDA launch runs the int16x2 kernel: no hand-off, and every
    gap penalty at most I16_GAP_MAX."""
    return not hand_off and max(g for g in gaps if g is not None) <= I16_GAP_MAX


def rescore_blocks(lanes: int, n_segs: int) -> int:
    """Blocks a query of the rescore launch: one each RESCORE_SPAN entries."""
    return max(1, -(-lanes * n_segs // RESCORE_SPAN))


# (G, H) shapes of the kernel (csrc/sw_wave.cu SW_WAVE_SHAPES): G bands a
# pass, H query rows a band; G = 1 is the band sweep, a thread per (lane,
# segment) and every band a pass.
SHAPES = ((16, 32), (8, 32), (4, 32), (2, 32), (1, 32), (1, 64))
# From this many (lane, segment) pairs a launch takes the band sweep: the
# midpoint of the interval in which the two schedules of the int16x2 kernel
# crossed on an H100, on SwissProt-shaped buckets (wave_ab.py --dtypes
# --buckets; PERF.md gives every bucket): 11,776 to 12,288 pairs under
# linear gaps (P01008's buckets; the suite's batch agrees), 12,288 to 17,408
# under affine ones (the suite's batch and the 16 length strata of the
# single searches; P01008 alone would put it past 29,696).  The int32
# kernel's crossover, 12,288 to 17,408 pairs (linear), serves its launches:
# the hand-offs and gaps past I16_GAP_MAX.  The band sweep's H, (linear,
# affine).
BAND_THREADS = 12_032
BAND_THREADS_AFFINE = 14_848
BAND_THREADS_INT32 = 14_848
BAND_H = (64, 32)


def check_shape(shape: Optional[Tuple[int, int]], shapes: Tuple[Tuple[int, int], ...]) -> None:
    """Refuse a forced (G, H) that is not one of the compiled ``shapes``
    (None: the wrapper picks)."""
    if shape is not None and tuple(shape) not in shapes:
        raise ValueError(f"shape {shape} is not a compiled (G, H): {shapes}")


def wave_shape(n_bands: int, lanes: int, n_segs: int, affine: bool = False,
               band_threads: Optional[int] = None) -> Tuple[int, int]:
    """(G, H) of a launch of ``n_bands`` 32-row bands on a bucket of
    ``lanes`` lanes of ``n_segs`` segments: the band sweep (G = 1) on a
    bucket of ``band_threads`` (lane, segment) pairs or more (None: the
    int16x2 kernel's crossover for the gap model, ``BAND_THREADS`` or
    ``BAND_THREADS_AFFINE``), else the warp wavefront with the fewest
    power-of-two G >= n_bands (at most 16) bands of 32 rows a pass, the band
    sweep for a single band."""
    if band_threads is None:
        band_threads = BAND_THREADS_AFFINE if affine else BAND_THREADS
    if lanes * n_segs >= band_threads:
        return 1, BAND_H[affine]
    g = min(16, 1 << max(n_bands - 1, 0).bit_length())
    return g, W


def n_passes(n_bands: int, g: int, h: int) -> int:
    """Passes of the kernel over a launch's ``n_bands`` 32-row bands: G
    bands of H rows a pass, the last pass what remains (under H = 64 an odd
    band count ends in a 32-row tail band: csrc/sw_wave.cu)."""
    if n_bands < 1 or h % W or g < 1:
        raise ValueError(f"n_bands={n_bands} must be >= 1, h={h} a multiple of {W}, g={g} >= 1")
    return -(-n_bands * W // (g * h))


def carry_bytes(
    n_bands: int, n_segs: int, seg_cols: int, lanes: int, affine: bool = False, hand_off: bool = False, *,
    shape: Optional[Tuple[int, int]] = None, int16: bool = True,
) -> int:
    """Device bytes of one query's scratch in a launch at ``shape`` (G, H),
    or at ``wave_shape``'s when None.  A hand-off (``hand_off``: top_in or
    return_carry) runs the int32 kernel: the bottom H row, one int32 per
    column and lane, and in affine mode the bottom F row beside it.  Any
    launch that runs the int16x2 kernel (``int16``, as ``uses_int16``
    says) needs its carry, int16 H (and F), when the bands take more than
    one pass, and its rescore's carry (``_rescore_bytes``); one that runs
    the int32 kernel for its gaps, the int32 carry when they take more than
    one pass."""
    planes = 2 if affine else 1
    passes = n_passes(n_bands, *(shape or wave_shape(n_bands, lanes, n_segs, affine)))
    if hand_off or (not int16 and passes > 1):
        return 4 * planes * n_segs * seg_cols * lanes
    if not int16:
        return 0
    return _carry16_bytes(passes, n_segs, seg_cols, lanes, affine) + _rescore_bytes(n_bands, n_segs, seg_cols, lanes, affine)


def _carry16_bytes(passes: int, n_segs: int, seg_cols: int, lanes: int, affine: bool) -> int:
    """One query's int16 carry: an int16 H (and F) a column and lane, when
    the launch takes more than one pass."""
    return 2 * (2 if affine else 1) * n_segs * seg_cols * lanes if passes > 1 else 0


def _rescore_bytes(n_bands: int, n_segs: int, seg_cols: int, lanes: int, affine: bool) -> int:
    """One query's rescore carry: an int32 H (and F) a column of a segment
    for each of RESCORE_SLOTS entries a block, when a query of ``n_bands``
    takes more than one pass of the rescore's wavefront."""
    if n_passes(n_bands, RESCORE_G, W) == 1:
        return 0
    return 4 * (2 if affine else 1) * seg_cols * RESCORE_SLOTS * rescore_blocks(lanes, n_segs)


def _sw_wave_cuda(profile, subjT, gaps: Gaps, n_segs, seg_cols, top_in, return_carry, shape=None, int32=False,
                  rescore=True):
    """Launch on the card: the int16x2 kernel and its rescore where
    ``uses_int16`` allows and ``int32`` is False, else the int32 kernel.
    ``rescore=False`` leaves the int16x2 kernel's flagged entries at -1."""
    hand_off = top_in is not None or return_carry
    if int32 or not uses_int16(gaps, hand_off):
        return _sw_wave_int32_cuda(profile, subjT, gaps, n_segs, seg_cols, top_in, return_carry, shape)
    lib = _kernel_lib()
    dev = subjT.device
    multi = profile.dim() == 3
    affine = gaps[1] is not None
    prof3 = profile if multi else profile[None]
    n_q, n_bands = prof3.shape[0], prof3.shape[1] // W
    B = subjT.shape[1]
    shape = tuple(shape or wave_shape(n_bands, B, n_segs, affine))
    out = torch.empty(n_q, B * n_segs, dtype=torch.int32, device=dev)
    scores = out if multi else out[0]
    if B == 0:
        return scores
    # One scratch buffer a launch: each query's int16 carry, then each
    # query's rescore carry (int32 slots, 16-byte aligned).
    carry16 = n_q * _carry16_bytes(n_passes(n_bands, *shape), n_segs, seg_cols, B, affine)
    at = -(-carry16 // 16) * 16
    scratch = torch.empty(at + n_q * _rescore_bytes(n_bands, n_segs, seg_cols, B, affine), dtype=torch.uint8,
                          device=dev)
    counter = rescore_counter(dev)
    blocks = rescore_blocks(B, n_segs) if rescore else 0
    args = (prof3.data_ptr(), subjT.data_ptr(), scratch.data_ptr(), scratch.data_ptr() + at, out.data_ptr(),
            counter.data_ptr(), n_q, n_bands, B, n_segs, seg_cols)
    if affine:
        rc = lib.sw_wave16_affine_launch(*args, gaps[0], gaps[1], *shape, blocks, *_build.where(dev))
    else:
        rc = lib.sw_wave16_launch(*args, gaps[0], *shape, blocks, *_build.where(dev))
    _build.check(rc, lib.sw_wave_error_string, "sw_wave int16x2 kernel launch")
    sw_wave.launches += 1
    sw_wave.multi_launches += int(multi)
    sw_wave.affine_launches += int(affine)
    sw_wave.int16_launches += 1
    sw_wave.rescore_launches += int(rescore)
    return scores


def _sw_wave_int32_cuda(profile, subjT, gaps: Gaps, n_segs, seg_cols, top_in, return_carry, shape=None):
    lib = _kernel_lib()
    dev = subjT.device
    multi = profile.dim() == 3
    affine = gaps[1] is not None
    hand_off = top_in is not None or return_carry
    prof3 = profile if multi else profile[None]
    n_q, n_bands = prof3.shape[0], prof3.shape[1] // W
    B = subjT.shape[1]
    shape = tuple(shape or wave_shape(n_bands, B, n_segs, affine, BAND_THREADS_INT32))
    out = torch.empty(n_q, B * n_segs, dtype=torch.int32, device=dev)
    if top_in is not None:
        carry = top_in  # read as band 0's top, then overwritten in place
    elif return_carry:
        carry = torch.empty(_carry_shape(subjT, affine), dtype=torch.int32, device=dev)
    else:
        # Each query has its own carry slice: blocks of different queries run at once.
        carry = torch.empty(n_q * carry_bytes(n_bands, n_segs, seg_cols, B, affine, shape=shape, int16=False) // 4,
                            dtype=torch.int32, device=dev)
    scores = out if multi else out[0]
    if B == 0:
        return (scores, carry) if return_carry else scores
    args = (prof3.data_ptr(), subjT.data_ptr(), carry.data_ptr(), out.data_ptr(), n_q, n_bands, B, n_segs, seg_cols)
    # A hand-off always writes the last band's bottom: top_in then holds the new carry.
    tail = (int(top_in is not None), int(hand_off), *shape)
    if affine:
        rc = lib.sw_wave_affine_launch(*args, gaps[0], gaps[1], *tail, *_build.where(dev))
    else:
        rc = lib.sw_wave_launch(*args, gaps[0], *tail, *_build.where(dev))
    _build.check(rc, lib.sw_wave_error_string, "sw_wave kernel launch")
    sw_wave.launches += 1
    sw_wave.multi_launches += int(multi)
    sw_wave.affine_launches += int(affine)
    sw_wave.carry_launches += int(hand_off)
    return (scores, carry) if return_carry else scores


def _sw_wave_route(profile, subjT, *, gap=None, n_segs=1, gap_open=None, gap_extend=None, shape=None, int32=False,
                   rescore=True):
    """sw_wave without a hand-off on the card, by a route the program does
    not take by itself: ``int32=True`` runs the int32 kernel (the A/B lab's
    and the card tests' counterpart), ``rescore=False`` the int16x2 kernel
    alone, its flagged entries left at -1."""
    gaps = gap_model(gap, gap_open, gap_extend)
    seg_cols = _check(profile, subjT, n_segs)
    check_shape(shape, SHAPES)
    if subjT.device.type != "cuda":
        raise ValueError(f"the kernel routes run on CUDA tensors, not {subjT.device}")
    if not int32 and not uses_int16(gaps, False):
        raise ValueError(f"gaps {gaps} are past the int16x2 kernel's {I16_GAP_MAX}")
    return _sw_wave_cuda(profile, subjT, gaps, n_segs, seg_cols, None, False, shape, int32=int32, rescore=rescore)


def sw_wave_plain(
    profile: torch.Tensor,
    subjT: torch.Tensor,
    top_in: Optional[torch.Tensor] = None,
    *,
    gap: Optional[int] = None,
    n_segs: int = 1,
    gap_open: Optional[int] = None,
    gap_extend: Optional[int] = None,
    return_carry: bool = False,
):
    """Plain PyTorch version of the kernel, on any device (same arguments).

    Un-chains the bucket into (B * n_segs, seg_cols) rows and runs a row
    recurrence vectorised over rows and columns with torch.cummax, one
    query after another for a profile stack: the u-space recurrence of
    swtpu.ops.xla_sw.sw_score_bucket for linear gaps, the closed-form Gotoh
    row of swtpu.ops.oracle.sw_affine_matrices for affine ones.  When pads
    score <= 0 (every profile from make_profile) and no carry is handed on,
    rows that hold no residue score 0 and trailing all-pad columns cannot
    raise a max, under either gap model, so both are dropped before the
    recurrence; a carry is an output (or input) at every column, so with
    ``top_in`` or ``return_carry`` nothing is dropped.
    """
    gaps = gap_model(gap, gap_open, gap_extend)
    seg_cols = _check(profile, subjT, n_segs)
    _check_hand_off(profile, subjT, top_in, return_carry, gaps[1] is not None)
    return _plain(profile, subjT, gaps, n_segs, seg_cols, top_in, return_carry)


def _plain(profile, subjT, gaps: Gaps, n_segs: int, seg_cols: int, top_in=None, return_carry=False):
    if profile.dim() == 3:
        return torch.stack([_plain_one(p, subjT, gaps, n_segs, seg_cols) for p in profile])
    if top_in is None and not return_carry:
        return _plain_one(profile, subjT, gaps, n_segs, seg_cols)
    return _plain_hand_off(profile, subjT, gaps, n_segs, seg_cols, top_in, return_carry)


def _plain_one(profile: torch.Tensor, subjT: torch.Tensor, gaps: Gaps, n_segs: int, seg_cols: int) -> torch.Tensor:
    B = subjT.shape[1]
    rows = subjT[: n_segs * seg_cols].T.reshape(B * n_segs, seg_cols)
    idx = rows.long() & (A32 - 1)
    out = torch.zeros(B * n_segs, dtype=torch.int32, device=subjT.device)
    prof = profile.to(torch.int32)
    keep = None
    if int(prof[:, PAD_SUBJECT].max()) <= 0:
        real = idx != PAD_SUBJECT
        keep = real.any(1).nonzero().squeeze(1)
        cols = real.any(0).nonzero()
        if keep.numel() == 0:
            return out
        idx = idx[keep, : int(cols.max()) + 1]
    best = _sw_rows(prof, idx, gaps[0])[0] if gaps[1] is None else _sw_rows_affine(prof, idx, *gaps)[0]
    if keep is None:
        return best
    out[keep] = best
    return out


def _plain_hand_off(profile, subjT, gaps: Gaps, n_segs, seg_cols, top_in, return_carry):
    """One query with a carry handed in or out, every row and column kept.
    The carry's (n_segs * seg_cols, B) columns map to the un-chained rows
    as the bucket's subjects do: row lane * n_segs + seg, column c of
    segment seg = carry row seg * seg_cols + c."""
    B = subjT.shape[1]
    n_rows = B * n_segs
    idx = subjT[: n_segs * seg_cols].T.reshape(n_rows, seg_cols).long() & (A32 - 1)
    prof = profile.to(torch.int32)
    affine = gaps[1] is not None
    top = None if top_in is None else top_in.transpose(0, 1).reshape(n_rows, seg_cols, *top_in.shape[2:])
    if affine:
        best, h, f = _sw_rows_affine(prof, idx, *gaps, top=top)
        carry = torch.stack([h, f], dim=-1)
    else:
        best, carry = _sw_rows(prof, idx, gaps[0], top=top)
    carry = carry.reshape(B, n_segs * seg_cols, *carry.shape[2:]).transpose(0, 1)
    if top_in is not None:
        top_in.copy_(carry)  # the kernel's in-place hand-off
        carry = top_in
    return (best, carry.contiguous()) if return_carry else best


def _sw_rows(prof: torch.Tensor, idx: torch.Tensor, gap: int, top: Optional[torch.Tensor] = None):
    """SW of a (qpad, 32) int32 profile vs (N, L) index rows: the (N,)
    int32 max, and the (N, L) int32 H of the last query row.

    u[j] = H[j] + gap*j turns the in-row recurrence H[j] = max(T[j],
    H[j-1] - gap) into u = cummax(T + gap*j); the max of H is the max of
    t_u - gap*j over all rows.  ``top``, (N, L) int32, is the H row above
    the first query row (zeros when None); it enters the recurrence and not
    the max.
    """
    N, L = idx.shape
    rebase = torch.arange(L, dtype=torch.int32, device=idx.device) * gap
    prof_g = prof + gap
    edge = torch.full((N, 1), -gap, dtype=torch.int32, device=idx.device)  # column -1: H = 0
    bestu = rebase.expand(N, L)
    u = bestu if top is None else top + rebase
    for i in range(prof.shape[0]):
        diag = torch.cat([edge, u[:, :-1]], dim=1)
        t = torch.maximum(torch.maximum(diag + prof_g[i][idx], u - gap), rebase)
        u = torch.cummax(t, dim=1).values
        bestu = torch.maximum(bestu, t)
    return (bestu - rebase).amax(dim=1).to(torch.int32), u - rebase


def _sw_rows_affine(
    prof: torch.Tensor, idx: torch.Tensor, gap_open: int, gap_extend: int, top: Optional[torch.Tensor] = None
):
    """Gotoh SW of a (qpad, 32) int32 profile vs (N, L) index rows: the (N,)
    int32 max, and the (N, L) int32 H and F of the last query row.

    Per query row: F = max(H_up - open, F_up - ext) elementwise from the
    previous row; T = max(0, diag + s, F); and, because open >= ext, the
    in-row E chain is closed-form: E[c] = max over k <= c of (V[k] + ext*k)
    - open - ext*c, with V[0] = 0 (the left boundary's H) and V[k] = T[k-1],
    which is one cummax; H = max(T, E).  ``top``, (N, L, 2) int32, holds the
    H and F rows above the first query row (H = 0, F = NEG when None); it
    enters the recurrence and not the max.
    """
    N, L = idx.shape
    dev = idx.device
    ramp = torch.arange(L, dtype=torch.int32, device=dev) * gap_extend
    zero = torch.zeros((N, 1), dtype=torch.int32, device=dev)
    best = torch.zeros((N, L), dtype=torch.int32, device=dev)
    if top is None:
        h, f = best, torch.full((N, L), NEG, dtype=torch.int32, device=dev)  # F above row 0
    else:
        h, f = top[..., 0], top[..., 1]
    for i in range(prof.shape[0]):
        f = torch.maximum(h - gap_open, f - gap_extend)
        diag = torch.cat([zero, h[:, :-1]], dim=1)
        t = torch.maximum(diag + prof[i][idx], f).clamp_min_(0)
        u = torch.cummax(torch.cat([zero, t[:, :-1]], dim=1) + ramp, dim=1).values
        h = torch.maximum(t, u - ramp - gap_open)
        best = torch.maximum(best, h)
    return best.amax(dim=1).to(torch.int32), h, f
