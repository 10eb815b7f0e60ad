"""K10: the row-parallel lab kernels of ``tools/pallas_lab.py`` on the card.

Counterparts of the four TPU lab kernels, as compile-time variants of one
CUDA kernel (``csrc/sw_rows_lab.cu``, whose note defines each one), one warp
a subject row, its lanes 32 columns, the horizontal gap as a max-scan over
the lanes in u-space:

* ``sw_rows_v2`` (``sw_v2``, ``tools/pallas_lab.py:102``): each warp stages
  its own subject's scores on the tensor cores; ``strip`` 16 or 32;
* ``sw_rows_v3`` (``sw_v3``, :206): a block of 8 warps stages one column of
  its 8 subjects an mma; ``strip`` 16 or 32;
* ``sw_rows_v4`` (``sw_v4``, :304): v3 with ``ilp`` (2 or 4) subjects a
  warp, their chains interleaved, the gap folded into the staging; ``strip``
  32;
* ``sw_rows_v41`` (``sw_v41``, :389): v3 with the gap folded and the scan's
  shifts as rotations under hoisted lane masks; ``strip`` 16 or 32.

They take K2's contract (``bucket_sw.sw_score_bucket_fused``): a (qpad, 32)
int8 profile, a (B, L) bucket or (C, B, L) stack of int8 subjects (pads
PAD_SUBJECT) and a linear ``gap``, and return (B,) or (C, B) exact int32
Smith-Waterman maxima.  ``strip`` is the kernel's query rows a strip (the
TPU kernels' strip 8 is 16 here: an mma's M); no strip changes a score.

For tensors on the card each wrapper launches its variant and counts it on
its own ``launches``; for tensors on the CPU it runs ``rows_lab_plain``.  A
CUDA tensor reaches the kernel or raises.  Every wrapper checks its knobs
first, on either device.
"""

from __future__ import annotations

import ctypes

import torch

from ..alphabet import PADDED_ALPHABET_SIZE as A32
from . import _build, row_sw
from .wave_lab import pad_profile

VARIANTS = ("v2", "v3", "v4", "v41")  # sw_rows_lab.cu's variant codes, in order
STRIPS = {"v2": (16, 32), "v3": (16, 32), "v4": (32,), "v41": (16, 32)}
ILPS = (2, 4)  # v4's subjects a warp
# Every instantiation of the kernel: (variant, strip, ilp).
INSTANCES = tuple((v, s, ilp) for v in VARIANTS for s in STRIPS[v] for ilp in (ILPS if v == "v4" else (1,)))


_kernel_lib = _build.Library("sw_rows_lab",
                             sw_rows_lab_launch=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p])


def _check(variant: str, profile: torch.Tensor, subjects: torch.Tensor, gap: int, strip: int, ilp: int) -> None:
    if strip not in STRIPS[variant]:
        raise ValueError(f"{variant}: strip must be one of {STRIPS[variant]}, got {strip}")
    if ilp not in (ILPS if variant == "v4" else (1,)):
        raise ValueError(f"{variant}: ilp must be one of {ILPS if variant == 'v4' else (1,)}, got {ilp}")
    if profile.dtype != torch.int8 or profile.dim() != 2 or profile.shape[1] != A32 or profile.shape[0] == 0:
        raise ValueError(f"profile must be (qpad, {A32}) int8, got {tuple(profile.shape)} {profile.dtype}")
    if subjects.dtype != torch.int8 or subjects.dim() not in (2, 3):
        raise ValueError(f"subjects must be (B, L) or (C, B, L) int8, got {tuple(subjects.shape)} {subjects.dtype}")
    if profile.device != subjects.device or subjects.device.type not in ("cpu", "cuda"):
        raise ValueError(f"CPU or CUDA tensors on one device, not {profile.device} and {subjects.device}")
    if gap < 0:
        raise ValueError("gap must be >= 0")


def _run(variant: str, profile: torch.Tensor, subjects: torch.Tensor, gap: int, strip: int, ilp: int,
         counter) -> torch.Tensor:
    _check(variant, profile, subjects, gap, strip, ilp)
    stack = subjects if subjects.dim() == 3 else subjects[None]
    if stack.device.type == "cpu":
        out = rows_lab_plain(profile, stack, gap=gap)
    else:
        out = _launch(variant, profile, stack, gap, strip, ilp, counter)
    return out if subjects.dim() == 3 else out[0]


def _launch(variant, profile, stack, gap, strip, ilp, counter) -> torch.Tensor:
    C, B, L = stack.shape
    dev = stack.device
    out = torch.zeros(C, B, dtype=torch.int32, device=dev)
    if C == 0 or B == 0 or L == 0:
        return out  # nothing to score: every maximum is 0
    if C > 65535:
        raise ValueError(f"a stack of {C} buckets exceeds the kernel's grid (65535)")
    prof = pad_profile(profile, strip).contiguous()
    stack = stack.contiguous()
    n_strips = prof.shape[0] // strip
    carry = torch.empty(C * B * L if n_strips > 1 else 1, dtype=torch.int32, device=dev)
    lib = _kernel_lib()
    rc = lib.sw_rows_lab_launch(prof.data_ptr(), stack.data_ptr(), carry.data_ptr(), out.data_ptr(), C, n_strips, B,
                                L, gap, VARIANTS.index(variant), strip, ilp, *_build.where(dev))
    _build.check(rc, lib.sw_rows_lab_error_string, f"sw_rows_lab {variant} strip {strip} ilp {ilp} launch")
    counter.launches += 1
    return out


def carry_bytes(n_strips: int, chunks: int, rows: int, width: int) -> int:
    """Carry traffic of one launch: every strip but the last writes its
    bottom row of u (an int32 a column) and the next strip reads it."""
    return 8 * (n_strips - 1) * chunks * rows * width


def sw_rows_v2(profile: torch.Tensor, subjects: torch.Tensor, *, gap: int, strip: int = 32) -> torch.Tensor:
    """K10 v2: each warp stages its own subject's scores."""
    return _run("v2", profile, subjects, gap, strip, 1, sw_rows_v2)


def sw_rows_v3(profile: torch.Tensor, subjects: torch.Tensor, *, gap: int, strip: int = 32) -> torch.Tensor:
    """K10 v3: 8 subjects a block share the staging."""
    return _run("v3", profile, subjects, gap, strip, 1, sw_rows_v3)


def sw_rows_v4(profile: torch.Tensor, subjects: torch.Tensor, *, gap: int, strip: int = 32,
               ilp: int = 2) -> torch.Tensor:
    """K10 v4: v3 with ``ilp`` interleaved subjects a warp, the gap folded."""
    return _run("v4", profile, subjects, gap, strip, ilp, sw_rows_v4)


def sw_rows_v41(profile: torch.Tensor, subjects: torch.Tensor, *, gap: int, strip: int = 32) -> torch.Tensor:
    """K10 v41: v3 with the gap folded and the scan as masked rotations."""
    return _run("v41", profile, subjects, gap, strip, 1, sw_rows_v41)


sw_rows_v2.launches = 0  # kernel launches since the count was last set to 0
sw_rows_v3.launches = 0
sw_rows_v4.launches = 0
sw_rows_v41.launches = 0
WRAPPERS = {"v2": sw_rows_v2, "v3": sw_rows_v3, "v4": sw_rows_v4, "v41": sw_rows_v41}


def rows_lab_plain(profile: torch.Tensor, stack: torch.Tensor, *, gap: int) -> torch.Tensor:
    """Plain PyTorch version of every variant, on any device: the u-space
    recurrence that ``tools/pallas_lab.py`` computes (t = max(j*gap, diag_u +
    s + gap, u_prev - gap), diag filled with -gap at column 0, u the running
    max of t, the score the max of t - j*gap), which is exactly
    ``row_sw.sw_score_stack`` (a ``torch.cummax`` a query row).  (B,) for a
    (B, L) bucket, (C, B) for a (C, B, L) stack."""
    return row_sw.sw_score_stack(profile, stack, gap=gap, strip=1)
