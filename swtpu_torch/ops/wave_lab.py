"""K4, K5 and K6: lab variants of the wavefront kernel, one query, linear gaps.

Counterparts of three TPU lab kernels, as knobs of one CUDA kernel
(``csrc/sw_wave_lab.cu``, whose note defines each variant):

* ``sw_wave_band`` (K4, ``tools/pallas_wave.py:208``): K1's warp wavefront
  with ``height`` query rows a band (16, 32, 64) and ``block`` threads a
  block (32, 64, 128), on every bucket (``band_schedule`` gives the launch's
  bands a pass, lanes a block, blocks and passes);
* ``sw_wave_prefetch`` (K5, ``tools/pallas_wave2.py:201``): K1's linear band
  sweep (``SWEEP_HEIGHT`` = 64 rows a band), subject residues and carry tops
  loaded ``depth`` columns ahead (1, 2, 4, 8);
* ``sw_wave_skip`` (K6, ``tools/probe_breakdown.py:199``): the same sweep with
  one stage dropped, ``skip`` = "none", "subject", "carry" or "dp", each
  with an exact result over its 64-row bands.

They take ``wave_sw.sw_wave``'s one-query contract: an int8 profile of 32
columns -- for K4 (n_bands * height) rows (``pad_profile`` pads one to a
multiple of the height), for K5 and K6 K1's own profile, rows a multiple of
32, whose last sweep band is 32 rows when that count of 32-row bands is odd
-- a (L2, B) int8 transposed bucket of ``n_segs`` chained segments (``L2 =
n_segs * seg_cols + 32``) and a linear ``gap``, and return (B * n_segs,)
int32, lane-major.  Every variant but the skips "subject", "carry" and "dp"
computes ``sw_wave``'s scores.

For tensors on the card each wrapper launches its variant of the kernel and
counts it on its own ``launches``; for tensors on the CPU it runs
``sw_wave_lab_plain``.  A CUDA tensor reaches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..alphabet import PADDED_ALPHABET_SIZE as A32
from . import _build
from .profile import PAD_SCORE, PAD_SUBJECT
from .wave_sw import BAND_H, W, _plain_one, _sw_rows

HEIGHTS = (16, 32, 64)  # K4's band heights
BLOCKS = (32, 64, 128)  # K4's block sizes
DEPTHS = (1, 2, 4, 8)  # K5's prefetch depths
SKIPS = ("none", "subject", "carry", "dp")  # K6's dropped stage
# K1's wavefront band height and its band sweep's block (sw_wave.cu): K4 runs
# at them by default.
K1_HEIGHT, K1_BLOCK = 32, 64
SWEEP_HEIGHT = BAND_H[False]  # K1's linear band sweep's rows a band: K5 and K6 run it, at K1_BLOCK threads a block
MAX_G = 16  # K4's most bands a pass: half a warp a lane
STAGE_INTS = {h: 32 * (h + 4) + 4 for h in HEIGHTS}  # int32 a band of the shared stage (csrc: Stage<H>::BAND)
SWEEP_STAGE_BYTES = 4 * STAGE_INTS[SWEEP_HEIGHT]  # K5's and K6's one band of dynamic shared memory


_kernel_lib = _build.Library("sw_wave_lab",
                             sw_wave_lab_launch=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p],
                             sw_wave_lab_blocks_per_sm=[ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])


class Schedule(NamedTuple):
    """K4's launch: ``g`` bands a pass in ``g`` threads a lane,
    ``lanes_per_block`` lanes a block of ``block`` threads, ``blocks`` blocks
    and ``passes`` passes (the carry goes through device memory between
    passes only), ``stage_bytes`` of dynamic shared memory a block."""

    g: int
    lanes_per_block: int
    blocks: int
    passes: int
    stage_bytes: int


def band_schedule(n_bands: int, height: int, block: int, lanes: int) -> Schedule:
    """K4's schedule for a profile of ``n_bands`` bands of ``height`` rows
    on a bucket of ``lanes`` lanes: G is the next power of two of the bands,
    at most ``MAX_G`` (``wave_sw.wave_shape``'s rule at H = 32), whatever the
    bucket's size."""
    if height not in HEIGHTS or block not in BLOCKS or n_bands < 1 or lanes < 0:
        raise ValueError(f"no K4 schedule for n_bands={n_bands}, height={height}, block={block}, lanes={lanes}")
    g = min(MAX_G, 1 << (n_bands - 1).bit_length())
    per_block = block // g
    return Schedule(g=g, lanes_per_block=per_block, blocks=-(-lanes // per_block), passes=-(-n_bands // g),
                    stage_bytes=4 * g * STAGE_INTS[height])


def blocks_per_sm(height: int, block: int, g: int, device, depth: int = 1, skip: str = "none") -> int:
    """Blocks an SM on ``device`` (a CUDA device), by the runtime's
    occupancy calculator (registers, threads, shared stage): of K4's
    (height, block) wavefront at ``g`` bands a pass, or for ``g = 0`` of
    the band sweep's (``depth``, ``skip``) instantiation at (SWEEP_HEIGHT,
    K1_BLOCK)."""
    lib = _kernel_lib()
    blocks = ctypes.c_int(0)
    rc = lib.sw_wave_lab_blocks_per_sm(height, block, depth, SKIPS.index(skip), g,
                                       _build.where(torch.device(device))[0], ctypes.byref(blocks))
    _build.check(rc, lib.sw_wave_lab_error_string, "sw_wave_lab occupancy query")
    return blocks.value


def pad_profile(profile: torch.Tensor, height: int) -> torch.Tensor:
    """The profile with PAD_SCORE rows appended up to a multiple of
    ``height``: pad rows score below every real cell, so no maximum moves."""
    extra = -profile.shape[0] % height
    if not extra:
        return profile
    pad = torch.full((extra, profile.shape[1]), PAD_SCORE, dtype=profile.dtype, device=profile.device)
    return torch.cat([profile, pad])


def _check(profile: torch.Tensor, subjT: torch.Tensor, n_segs: int, gap: int, height: int,
           unit: int = 0) -> int:
    """Validate the kernel's contract, the profile's rows a multiple of
    ``unit`` (the height unless given: the band sweep takes K1's 32-row
    bands, its last band a tail); returns seg_cols."""
    if height not in HEIGHTS:
        raise ValueError(f"height must be one of {HEIGHTS}, got {height}")
    if profile.dtype != torch.int8 or profile.dim() != 2 or profile.shape[1] != A32:
        raise ValueError(f"profile must be (qpad, {A32}) int8, got {tuple(profile.shape)} {profile.dtype}")
    unit = unit or height
    if profile.shape[0] == 0 or profile.shape[0] % unit:
        what = f"the height {height}" if unit == height else f"{unit}, K1's band"
        raise ValueError(f"profile rows {profile.shape[0]} must be a positive multiple of {what}")
    if subjT.dtype != torch.int8 or subjT.dim() != 2:
        raise ValueError(f"subjT must be (L2, B) int8, got {tuple(subjT.shape)} {subjT.dtype}")
    if profile.device != subjT.device or subjT.device.type not in ("cpu", "cuda"):
        raise ValueError(f"CPU or CUDA tensors on one device, not {profile.device} and {subjT.device}")
    if not (profile.is_contiguous() and subjT.is_contiguous()):
        raise ValueError("profile and subjT must be contiguous")
    if gap < 0:
        raise ValueError("gap must be >= 0")
    cols = subjT.shape[0] - W
    if n_segs < 1 or cols < n_segs or cols % n_segs:
        raise ValueError(f"n_segs={n_segs} must divide the column count {cols}")
    return cols // n_segs


def _run(profile, subjT, gap, n_segs, height, block, depth, skip, counter, wave=False) -> torch.Tensor:
    """One launch: K4's wavefront (``wave``, ``height`` rows a band) or K1's
    band sweep of K5 and K6 (``SWEEP_HEIGHT`` rows a band over K1's 32-row
    bands, ``n_bands`` counting those)."""
    seg_cols = _check(profile, subjT, n_segs, gap, height, unit=height if wave else W)
    if subjT.device.type == "cpu":
        return _plain(profile, subjT, gap, n_segs, seg_cols, height, skip)
    B = subjT.shape[1]
    n_bands = profile.shape[0] // (height if wave else W)
    out = torch.empty(B * n_segs, dtype=torch.int32, device=subjT.device)
    if B == 0:
        return out
    if wave:
        sched = band_schedule(n_bands, height, block, B)
        g, needs_carry = sched.g, sched.passes > 1
    else:
        g, needs_carry = 0, profile.shape[0] > height and skip != "carry"  # more than one sweep band
    carry = torch.empty(n_segs * seg_cols * B if needs_carry else 0, dtype=torch.int32, device=subjT.device)
    lib = _kernel_lib()
    rc = lib.sw_wave_lab_launch(profile.data_ptr(), subjT.data_ptr(), carry.data_ptr(), out.data_ptr(), n_bands, B,
                                n_segs, seg_cols, gap, height, block, depth, SKIPS.index(skip), g,
                                *_build.where(subjT.device))
    _build.check(rc, lib.sw_wave_lab_error_string, "sw_wave_lab kernel launch")
    counter.launches += 1
    return out


def sw_wave_band(profile: torch.Tensor, subjT: torch.Tensor, *, gap: int, n_segs: int = 1, height: int = K1_HEIGHT,
                 block: int = K1_BLOCK) -> torch.Tensor:
    """K4: SW max of each (lane, segment) on K1's warp wavefront with
    ``height`` query rows a band and ``block`` threads a block
    (``band_schedule``); ``sw_wave``'s scores at every setting."""
    if block not in BLOCKS:
        raise ValueError(f"block must be one of {BLOCKS}, got {block}")
    return _run(profile, subjT, gap, n_segs, height, block, 1, "none", sw_wave_band, wave=True)


def sw_wave_prefetch(profile: torch.Tensor, subjT: torch.Tensor, *, gap: int, n_segs: int = 1,
                     depth: int = 1) -> torch.Tensor:
    """K5: SW max of each (lane, segment) on K1's band sweep over K1's
    profile, residues and carry tops loaded ``depth`` columns ahead;
    ``sw_wave``'s scores at every depth."""
    if depth not in DEPTHS:
        raise ValueError(f"depth must be one of {DEPTHS}, got {depth}")
    return _run(profile, subjT, gap, n_segs, SWEEP_HEIGHT, K1_BLOCK, depth, "none", sw_wave_prefetch)


def sw_wave_skip(profile: torch.Tensor, subjT: torch.Tensor, *, gap: int, n_segs: int = 1,
                 skip: str = "none") -> torch.Tensor:
    """K6: K1's band sweep over K1's profile with the ``skip`` stage dropped
    (``sw_wave_lab_plain(..., height=SWEEP_HEIGHT)`` defines each result);
    "none" gives ``sw_wave``'s scores."""
    if skip not in SKIPS:
        raise ValueError(f"skip must be one of {SKIPS}, got {skip!r}")
    return _run(profile, subjT, gap, n_segs, SWEEP_HEIGHT, K1_BLOCK, 1, skip, sw_wave_skip)


sw_wave_band.launches = 0  # kernel launches since the count was last set to 0
sw_wave_prefetch.launches = 0
sw_wave_skip.launches = 0


def sw_wave_lab_plain(profile: torch.Tensor, subjT: torch.Tensor, *, gap: int, n_segs: int = 1,
                      height: int = K1_HEIGHT, skip: str = "none") -> torch.Tensor:
    """Plain PyTorch version of every variant, on any device.  The block and
    the prefetch depth change no result; ``height`` and ``skip`` do.  The
    bands are ``height`` rows of the profile, whose rows are a multiple of
    ``min(height, 32)``: at height 64 (K5, K6) over K1's profile the last
    band is 32 rows where the count of 32-row bands is odd.

    * "none": the SW maximum, run band by band with the bottom row of each
      band as the next one's top (the kernel's carry): ``sw_wave``'s scores;
    * "subject": the same over synthetic subjects, residue (lane + c) & 31
      at bucket column c;
    * "carry": the largest SW maximum of a band alone (zero top);
    * "dp": m_b(c), the largest profile score of band b's rows against
      column c's residue; v_b(c) = m_0(c) + ... + m_b(c); the result is
      max(0, every v_b(c)) over the segment's columns.
    """
    if skip not in SKIPS:
        raise ValueError(f"skip must be one of {SKIPS}, got {skip!r}")
    seg_cols = _check(profile, subjT, n_segs, gap, height, unit=min(height, W))
    return _plain(profile, subjT, gap, n_segs, seg_cols, height, skip)


def _plain(profile, subjT, gap: int, n_segs: int, seg_cols: int, height: int, skip: str) -> torch.Tensor:
    B = subjT.shape[1]
    prof = profile.to(torch.int32)
    bands = prof.split(height)
    if skip == "carry":
        return torch.stack([_plain_one(p, subjT, (gap, None), n_segs, seg_cols) for p in bands]).amax(0)
    if skip == "none":
        return _plain_banded(bands, subjT, gap, n_segs, seg_cols)
    # rows lane * n_segs + seg, columns j of the segment: bucket column seg * seg_cols + j
    if skip == "subject":
        lane = torch.arange(B, device=subjT.device).view(B, 1, 1)
        column = torch.arange(n_segs * seg_cols, device=subjT.device).view(1, n_segs, seg_cols)
        idx = ((lane + column) & (A32 - 1)).reshape(B * n_segs, seg_cols)
        return _sw_rows(prof, idx, gap)[0]
    idx = subjT[: n_segs * seg_cols].T.reshape(B * n_segs, seg_cols).long() & (A32 - 1)
    reach = torch.stack([p.amax(0) for p in bands]).cumsum(0).amax(0)  # (32,): the largest v_b over bands
    return reach[idx].amax(1).clamp_min(0).to(torch.int32)


def _plain_banded(bands, subjT, gap: int, n_segs: int, seg_cols: int) -> torch.Tensor:
    """The SW maximum, band by band.  As in ``wave_sw._plain_one``: rows
    that hold no residue score 0 and trailing all-pad columns cannot raise a
    maximum when pads score <= 0, so both are dropped."""
    B = subjT.shape[1]
    idx = subjT[: n_segs * seg_cols].T.reshape(B * n_segs, seg_cols).long() & (A32 - 1)
    out = torch.zeros(B * n_segs, dtype=torch.int32, device=subjT.device)
    keep = None
    if max(int(p[:, PAD_SUBJECT].max()) for p in bands) <= 0:
        real = idx != PAD_SUBJECT
        keep = real.any(1).nonzero().squeeze(1)
        if keep.numel() == 0:
            return out
        idx = idx[keep, : int(real.any(0).nonzero().max()) + 1]
    best, top = None, None
    for p in bands:
        band_best, top = _sw_rows(p, idx, gap, top=top)
        best = band_best if best is None else torch.maximum(best, band_best)
    if keep is None:
        return best
    out[keep] = best
    return out
