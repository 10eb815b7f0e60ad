"""Row-parallel SW kernels K2 and K3 (counterpart of ``swtpu.ops.pallas_sw``).

* ``sw_score_bucket_fused`` -- K2: one query profile against a ``(B, L)``
  bucket, or a whole ``(C, B, L)`` stack of same-shape buckets in one
  launch; exact int32 Smith-Waterman maxima, ``(B,)`` or ``(C, B)``.
* ``sw_score_bucket_fast16`` -- the fast16 contract over K2: scores exact
  below ``sat`` and clamped at it.
* ``sw_score_bucket`` -- K3: one ``(B, L)`` bucket, any B.

For tensors on the card these launch the hand-written CUDA kernels of
``csrc/sw_rows.cu`` (plain C ABI, built by ``_build``); for tensors on the
CPU they run the plain version, ``row_sw.sw_score_stack`` /
``row_sw.sw_score_bucket``.  A CUDA tensor reaches its kernel or raises.
Each wrapper counts its kernel launches in ``.launches``.

The TPU kernels take widths up to ``MAX_PALLAS_WIDTH = 4096`` (a VMEM
limit); these take every width.  The bound of both kernels is int32
operations, about 6 a padded cell (see the source note).
"""

from __future__ import annotations

import ctypes

import torch

from ..alphabet import PADDED_ALPHABET_SIZE as A32
from . import _build, row_sw
from .profile import PAD_SCORE

W = 32  # query rows per band of the CUDA kernels


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


def carry_bytes(n_bands: int, chunks: int, rows: int, width: int) -> int:
    """Device bytes of a launch's band carry: the bottom H row of a band,
    one int32 per column and subject.  A single band needs none."""
    return 4 * chunks * rows * width if n_bands > 1 else 0


def _kernel_lib() -> ctypes.CDLL:
    return _build.load(
        "sw_rows",
        sw_rows_fused_launch=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
        sw_rows_launch=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    )


def _band_profile(profile: torch.Tensor) -> torch.Tensor:
    """The profile padded to whole bands with all-PAD_SCORE rows (a row of
    negative scores cannot raise a maximum), contiguous."""
    extra = (-profile.shape[0]) % W
    if extra:
        profile = torch.cat([profile, torch.full((extra, A32), PAD_SCORE, dtype=torch.int8, device=profile.device)])
    return profile.contiguous()


def _launch(entry: str, profile: torch.Tensor, stack: torch.Tensor, gap: int) -> torch.Tensor:
    """Run K2 (entry "fused", (C, B, L) stack) or K3 ("bucket", C == 1) on
    the card; (C, B) int32."""
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
    carry = torch.empty(max(carry_bytes(n_bands, C, B, L) // 4, 1), dtype=torch.int32, device=dev)
    ptrs = (prof.data_ptr(), stack.data_ptr(), carry.data_ptr(), out.data_ptr())
    if entry == "fused":
        rc = lib.sw_rows_fused_launch(*ptrs, C, n_bands, B, L, gap, *_build.where(dev))
    else:
        rc = lib.sw_rows_launch(*ptrs, n_bands, B, L, gap, *_build.where(dev))
    _build.check(rc, lib.sw_rows_error_string, "sw_rows kernel launch")
    (sw_score_bucket_fused if entry == "fused" else sw_score_bucket).launches += 1
    return out


def sw_score_bucket_fused(profile: torch.Tensor, subjects: torch.Tensor, *, gap: int, strip: int = 32) -> torch.Tensor:
    """K2: exact int32 scoring (the contract of row_sw.sw_score_bucket).

    profile: (qpad, 32) int8, qpad % strip == 0.  subjects: (B, L) int8, or
    a (C, B, L) stack scored in one launch; pads PAD_SUBJECT.  Returns (B,)
    or (C, B) int32.
    """
    _check(profile, subjects, strip, (2, 3))
    stack = subjects if subjects.dim() == 3 else subjects[None]
    if stack.device.type == "cpu":
        out = row_sw.sw_score_stack(profile, stack, gap=gap, strip=strip)
    else:
        out = _launch("fused", profile, stack, gap)
    return out if subjects.dim() == 3 else out[0]


sw_score_bucket_fused.launches = 0  # kernel launches since the count was last set to 0


def sw_score_bucket_fast16(
    profile: torch.Tensor, subjects: torch.Tensor, *, gap: int, strip: int = 32, sat: int
) -> torch.Tensor:
    """fast16 contract over K2: the exact scores, clamped at ``sat`` (as
    row_sw.sw_score_bucket_fast16 gives every score below it exactly)."""
    return torch.clamp_max(sw_score_bucket_fused(profile, subjects, gap=gap, strip=strip), sat)


def sw_score_bucket(profile: torch.Tensor, subjects: torch.Tensor, *, gap: int, strip: int = 32) -> torch.Tensor:
    """K3: max SW score of one query vs a (B, L) bucket, any B (exact int32;
    the contract of row_sw.sw_score_bucket).  Returns (B,) int32."""
    _check(profile, subjects, strip, (2,))
    if subjects.device.type == "cpu":
        return row_sw.sw_score_bucket(profile, subjects, gap=gap, strip=strip)
    return _launch("bucket", profile, subjects[None], gap)[0]


sw_score_bucket.launches = 0  # kernel launches since the count was last set to 0
