"""Row-parallel SW kernels K2 and K3 (counterpart of ``swtpu.ops.pallas_sw``).

* ``sw_score_bucket_fused`` -- K2: one query profile against a ``(B, L)``
  bucket, or a whole ``(C, B, L)`` stack of same-shape buckets in one
  launch; exact int32 Smith-Waterman maxima, ``(B,)`` or ``(C, B)``.
* ``sw_score_bucket_fast16`` -- the fast16 contract over K2: scores exact
  below ``sat`` and clamped at it.
* ``sw_score_bucket`` -- K3: one ``(B, L)`` bucket, any B: K2's launch at
  C = 1, counted as K3's.

For tensors on the card these launch the hand-written CUDA kernel of
``csrc/sw_rows.cu`` (one ``__global__`` template, one C entry point; plain
C ABI, built by ``_build``); for tensors on the CPU they run the plain
version, ``row_sw.sw_score_stack`` / ``row_sw.sw_score_bucket``.  A CUDA
tensor reaches its kernel or raises.  Each wrapper counts its kernel
launches in ``.launches``.

The kernel scores a launch's bands in passes of G bands of H rows
(``rows_shape`` picks (G, H) per launch unless a wrapper's ``shape=`` forces
one of ``SHAPES``; ``wave_sw.n_passes`` counts the passes): a warp wavefront with the band-to-band carry in registers, or, for
a single band and for launches of many rows, a sweep of one band at a time
(G = 1).  Only a pass boundary goes through the carry in device memory.

The TPU kernels take widths up to ``MAX_PALLAS_WIDTH = 4096`` (a VMEM
limit); these take every width.  The bound of both kernels is int32
operations, about 6 a padded cell (see the source note).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..alphabet import PADDED_ALPHABET_SIZE as A32
from . import _build, row_sw
from .profile import PAD_SCORE
from .wave_sw import check_shape, n_passes

W = 32  # query rows per band of the CUDA kernel

# (G, H) shapes of the kernel (csrc/sw_rows.cu SW_ROWS_SHAPES): G bands a
# pass, H query rows a band; G = 1 is the band sweep, a thread a subject row
# and every band a pass.
SHAPES = ((16, 32), (8, 32), (4, 32), (2, 32), (1, 32), (1, 64))
# From this many subject rows a launch (rows x C) takes the band sweep, at
# BAND_H rows a band: the midpoint of the interval, 8,193 to 32,768 rows, in
# which the two schedules crossed on P01008's K2 groups, K3 batches and int16
# launches on an H100 (swtpu_torch.tools.rows_ab --schedules; PERF.md gives
# every group); H = 64 beat H = 32 on every launch of the band sweep there.
BAND_ROWS = 20_480
BAND_H = 64


def _check(profile: torch.Tensor, subjects: torch.Tensor, strip: int, dims) -> None:
    if profile.dtype != torch.int8 or profile.dim() != 2 or profile.shape[1] != A32:
        raise ValueError(f"profile must be (qpad, {A32}) int8, got {tuple(profile.shape)} {profile.dtype}")
    if profile.shape[0] == 0 or strip < 1 or profile.shape[0] % strip:
        raise ValueError(f"profile rows {profile.shape[0]} must be a positive multiple of strip {strip}")
    if subjects.dtype != torch.int8 or subjects.dim() not in dims:
        raise ValueError(f"subjects must be {' or '.join(f'{d}-D' for d in dims)} int8, got {tuple(subjects.shape)} {subjects.dtype}")
    if profile.device != subjects.device:
        raise ValueError(f"profile on {profile.device} but subjects on {subjects.device}")
    if subjects.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the row kernels run on CPU or CUDA tensors, not {subjects.device}")


def rows_shape(n_bands: int, rows: int, band_rows: int = BAND_ROWS) -> Tuple[int, int]:
    """(G, H) of a launch of ``n_bands`` 32-row bands over ``rows`` subject
    rows (rows x C of a stack): the band sweep (G = 1) for a single band,
    at BAND_H rows a band from ``band_rows`` rows on, else the warp
    wavefront with the fewest power-of-two G >= n_bands (at most 16) bands
    of 32 rows a pass."""
    if n_bands <= 1:
        return 1, W
    if rows >= band_rows:
        return 1, BAND_H
    return min(16, 1 << (n_bands - 1).bit_length()), W


def carry_bytes(n_bands: int, chunks: int, rows: int, width: int, *, shape: Optional[Tuple[int, int]] = None) -> int:
    """Device bytes of a launch's band carry at ``shape`` (G, H), or at
    ``rows_shape``'s of its chunks x rows when None: the bottom H row of a
    pass, one int32 per column and subject.  A launch whose bands fit in one
    pass needs none."""
    passes = n_passes(n_bands, *(shape or rows_shape(n_bands, chunks * rows)))
    return 4 * chunks * rows * width if passes > 1 else 0


_kernel_lib = _build.Library("sw_rows", sw_rows_launch=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p])


def _band_profile(profile: torch.Tensor) -> torch.Tensor:
    """The profile padded to whole bands with all-PAD_SCORE rows (a row of
    negative scores cannot raise a maximum), contiguous."""
    extra = (-profile.shape[0]) % W
    if extra:
        profile = torch.cat([profile, torch.full((extra, A32), PAD_SCORE, dtype=torch.int8, device=profile.device)])
    return profile.contiguous()


def _launch(wrapper, profile: torch.Tensor, stack: torch.Tensor, gap: int, shape=None) -> torch.Tensor:
    """Run the kernel on a (C, B, L) stack on the card, in ``shape`` or
    rows_shape's (G, H); (C, B) int32.  Counts the launch on ``wrapper``."""
    if gap < 0:
        raise ValueError("gap must be >= 0")
    C, B, L = stack.shape
    dev = stack.device
    out = torch.zeros(C, B, dtype=torch.int32, device=dev)
    if C == 0 or B == 0 or L == 0:
        return out  # nothing to score: every maximum is 0
    if C > 65535:
        raise ValueError(f"a stack of {C} buckets exceeds the kernel's grid (65535)")
    lib = _kernel_lib()
    prof = _band_profile(profile)
    stack = stack.contiguous()
    n_bands = prof.shape[0] // W
    g, h = shape or rows_shape(n_bands, C * B)
    carry = torch.empty(max(carry_bytes(n_bands, C, B, L, shape=(g, h)) // 4, 1), dtype=torch.int32, device=dev)
    rc = lib.sw_rows_launch(prof.data_ptr(), stack.data_ptr(), carry.data_ptr(), out.data_ptr(), C, n_bands, B, L,
                            gap, g, h, *_build.where(dev))
    _build.check(rc, lib.sw_rows_error_string, "sw_rows kernel launch")
    wrapper.launches += 1
    return out


def sw_score_bucket_fused(
    profile: torch.Tensor, subjects: torch.Tensor, *, gap: int, strip: int = 32, shape: Optional[Tuple[int, int]] = None
) -> torch.Tensor:
    """K2: exact int32 scoring (the contract of row_sw.sw_score_bucket).

    profile: (qpad, 32) int8, qpad % strip == 0.  subjects: (B, L) int8, or
    a (C, B, L) stack scored in one launch; pads PAD_SUBJECT.  shape: the
    kernel's (G, H), one of ``SHAPES``, instead of ``rows_shape``'s choice;
    it changes no score (ValueError for any other).  Returns (B,) or (C, B)
    int32.
    """
    _check(profile, subjects, strip, (2, 3))
    check_shape(shape, SHAPES)
    stack = subjects if subjects.dim() == 3 else subjects[None]
    if stack.device.type == "cpu":
        out = row_sw.sw_score_stack(profile, stack, gap=gap, strip=strip)
    else:
        out = _launch(sw_score_bucket_fused, profile, stack, gap, shape)
    return out if subjects.dim() == 3 else out[0]


sw_score_bucket_fused.launches = 0  # kernel launches since the count was last set to 0


def sw_score_bucket_fast16(
    profile: torch.Tensor, subjects: torch.Tensor, *, gap: int, strip: int = 32, sat: int,
    shape: Optional[Tuple[int, int]] = None,
) -> torch.Tensor:
    """fast16 contract over K2: the exact scores, clamped at ``sat`` (as
    row_sw.sw_score_bucket_fast16 gives every score below it exactly)."""
    return torch.clamp_max(sw_score_bucket_fused(profile, subjects, gap=gap, strip=strip, shape=shape), sat)


def sw_score_bucket(
    profile: torch.Tensor, subjects: torch.Tensor, *, gap: int, strip: int = 32, shape: Optional[Tuple[int, int]] = None
) -> torch.Tensor:
    """K3: max SW score of one query vs a (B, L) bucket, any B (exact int32;
    the contract of row_sw.sw_score_bucket): K2's kernel at C = 1, at
    ``shape`` as K2's.  Returns (B,) int32."""
    _check(profile, subjects, strip, (2,))
    check_shape(shape, SHAPES)
    if subjects.device.type == "cpu":
        return row_sw.sw_score_bucket(profile, subjects, gap=gap, strip=strip)
    return _launch(sw_score_bucket, profile, subjects[None], gap, shape)[0]


sw_score_bucket.launches = 0  # kernel launches since the count was last set to 0
