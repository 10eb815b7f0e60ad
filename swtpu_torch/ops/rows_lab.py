"""K10: the row-parallel lab kernels of ``tools/pallas_lab.py`` on the card.

Counterparts of the four TPU lab kernels behind one CUDA entry point
(``csrc/sw_rows_lab.cu``, whose note defines each one), in one design: a
copy of K2's warp wavefront (``csrc/sw_rows.cu``: G threads a subject row,
thread g holding band g of ``strip`` query rows, a block staging each pass
of the profile once for its rows, the carry through device memory only
between passes), with each TPU knob as a knob of that schedule:

* ``sw_rows_v2`` (``sw_v2``, ``tools/pallas_lab.py:102``): each subject's own
  copy of the profile as a block of one warp that stages its own pass (2
  rows a stage at ``strip`` 32, 1 at 16);
* ``sw_rows_v3`` (``sw_v3``, :206): one profile shared by 16 subjects as 16
  rows a stage (256-thread blocks at ``strip`` 32, 512 at 16);
* ``sw_rows_v4`` (``sw_v4``, :304): the interleaved chains as ``ilp`` (2 or
  4) rows a thread group at ``strip`` 32;
* ``sw_rows_v41`` (``sw_v41``, :389): the rotate as the hand-off
  ``shfl.sync.idx`` from a hoisted source lane, at ``strip`` 16 (16-row
  bands, up to 32 a pass) or 32 (K2's shape).

``wave_schedule`` gives each launch: G, passes, rows a block, blocks and the
shared stage.

They take K2's contract (``bucket_sw.sw_score_bucket_fused``): a (qpad, 32)
int8 profile, a (B, L) bucket or (C, B, L) stack of int8 subjects (pads
PAD_SUBJECT) and a linear ``gap``, and return (B,) or (C, B) exact int32
Smith-Waterman maxima.  ``strip`` is the kernel's query rows a band (the TPU
kernels' strip 8 is 16 here); no band height changes a score.

For tensors on the card each wrapper launches its variant and counts it on
its own ``launches``; for tensors on the CPU it runs ``rows_lab_plain``.  A
CUDA tensor reaches the kernel or raises.  Every wrapper checks its knobs
first, on either device.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from ..alphabet import PADDED_ALPHABET_SIZE as A32
from . import _build, row_sw
from .wave_lab import pad_profile

VARIANTS = ("v2", "v3", "v4", "v41")  # sw_rows_lab.cu's variant codes, in order
STRIPS = {"v2": (16, 32), "v3": (16, 32), "v4": (32,), "v41": (16, 32)}
ILPS = (2, 4)  # v4's rows a thread group
# Every instantiation of the kernel: (variant, strip, ilp).
INSTANCES = tuple((v, s, ilp) for v in VARIANTS for s in STRIPS[v] for ilp in (ILPS if v == "v4" else (1,)))
# Threads a block of each (variant, strip), as csrc/sw_rows_lab.cu instantiates it: v2 one warp, staging its
# own pass; v3 16 rows a stage at the widest pass; v4 K2's 128; v41 8 rows a stage at the widest pass, as K2.
BLOCK_THREADS = {("v2", 16): 32, ("v2", 32): 32, ("v3", 16): 512, ("v3", 32): 256, ("v4", 32): 128,
                 ("v41", 16): 256, ("v41", 32): 128}
WAVE_MAX_G = {16: 32, 32: 16}  # most bands a pass, by band height: K2's 16 at 32 rows
STAGE_INTS = {h: 32 * (h + 4) + 4 for h in WAVE_MAX_G}  # int32 a band of the shared stage (csrc: Stage<H>::BAND)
SM_SHARED_BYTES = 233_472  # an H100 SM's shared memory, 228 KB
BLOCK_RESERVED_BYTES = 1_024  # shared memory the runtime reserves a block


_kernel_lib = _build.Library("sw_rows_lab",
                             sw_rows_lab_launch=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
                             sw_rows_lab_schedule=[ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)])


class WaveSchedule(NamedTuple):
    """A K10 launch on one bucket: ``g`` bands a pass in ``g`` threads a
    row group, ``pass_bands`` bands in the first pass, ``passes`` passes
    (the carry goes through device memory between passes only),
    ``rows_per_block`` rows a block, ``blocks`` blocks a bucket,
    ``stage_bytes`` of dynamic shared memory a block, and the blocks an SM
    that shared memory alone allows."""

    g: int
    pass_bands: int
    passes: int
    rows_per_block: int
    blocks: int
    stage_bytes: int
    smem_blocks_per_sm: int


def wave_schedule(variant: str, n_rows: int, strip: int, ilp: int, B: int) -> WaveSchedule:
    """The launch of ``variant`` for a profile of ``n_rows`` rows (padded
    to whole bands of ``strip`` rows) on a bucket of ``B`` rows: G is the
    fewest power of two at least the bands, at most ``WAVE_MAX_G[strip]``
    (K2's rule, ``bucket_sw.rows_shape``, at 32-row bands), a block holds
    ``BLOCK_THREADS[variant, strip] / G`` groups of ``ilp`` rows.
    ``sw_rows_lab.cu``'s launch computes the same (``card_schedule``)."""
    if (variant, strip, ilp) not in INSTANCES or n_rows < 1 or B < 0:
        raise ValueError(f"no wavefront schedule for {variant} n_rows={n_rows} strip={strip} ilp={ilp} B={B}")
    n_bands = -(-n_rows // strip)
    g = min(WAVE_MAX_G[strip], 1 << (n_bands - 1).bit_length())
    per_block = BLOCK_THREADS[variant, strip] // g * ilp
    stage = 4 * g * STAGE_INTS[strip]
    return WaveSchedule(g=g, pass_bands=min(g, n_bands), passes=-(-n_bands // g), rows_per_block=per_block,
                        blocks=-(-B // per_block), stage_bytes=stage,
                        smem_blocks_per_sm=SM_SHARED_BYTES // (stage + BLOCK_RESERVED_BYTES))


def card_schedule(variant: str, n_rows: int, strip: int, ilp: int, B: int, device) -> Tuple[int, ...]:
    """The kernel's own launch on ``device`` (a CUDA device) for the same
    arguments as ``wave_schedule``: (G, passes, rows a block, blocks a
    bucket, stage bytes, blocks an SM by the runtime's occupancy calculator:
    registers, threads and stage)."""
    wave_schedule(variant, n_rows, strip, ilp, B)  # the same checks
    lib = _kernel_lib()
    sched = (ctypes.c_int * 6)()
    rc = lib.sw_rows_lab_schedule(VARIANTS.index(variant), strip, ilp, -(-n_rows // strip), B,
                                  _build.where(torch.device(device))[0], sched)
    _build.check(rc, lib.sw_rows_lab_error_string, f"sw_rows_lab {variant} strip {strip} ilp {ilp} schedule")
    return tuple(sched)


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
    multi = wave_schedule(variant, prof.shape[0], strip, ilp, B).passes > 1
    carry = torch.empty(C * B * L if multi else 1, dtype=torch.int32, device=dev)
    lib = _kernel_lib()
    rc = lib.sw_rows_lab_launch(prof.data_ptr(), stack.data_ptr(), carry.data_ptr(), out.data_ptr(), C, n_strips, B,
                                L, gap, VARIANTS.index(variant), strip, ilp, *_build.where(dev))
    _build.check(rc, lib.sw_rows_lab_error_string, f"sw_rows_lab {variant} strip {strip} ilp {ilp} launch")
    counter.launches += 1
    return out


def carry_bytes(variant: str, n_rows: int, strip: int, chunks: int, rows: int, width: int, ilp: int = 1) -> int:
    """Carry traffic of one launch on a profile of ``n_rows`` rows: every
    pass (``wave_schedule``) but the last writes its bottom row (an int32 a
    column) and the next one reads it."""
    return 8 * (wave_schedule(variant, n_rows, strip, ilp, rows).passes - 1) * chunks * rows * width


def sw_rows_v2(profile: torch.Tensor, subjects: torch.Tensor, *, gap: int, strip: int = 32) -> torch.Tensor:
    """K10 v2: K2's wavefront in one-warp blocks, each staging its own pass."""
    return _run("v2", profile, subjects, gap, strip, 1, sw_rows_v2)


def sw_rows_v3(profile: torch.Tensor, subjects: torch.Tensor, *, gap: int, strip: int = 32) -> torch.Tensor:
    """K10 v3: K2's wavefront with one staged pass shared by 16 rows."""
    return _run("v3", profile, subjects, gap, strip, 1, sw_rows_v3)


def sw_rows_v4(profile: torch.Tensor, subjects: torch.Tensor, *, gap: int, strip: int = 32,
               ilp: int = 2) -> torch.Tensor:
    """K10 v4: K2's warp wavefront with ``ilp`` interleaved rows a thread group."""
    return _run("v4", profile, subjects, gap, strip, ilp, sw_rows_v4)


def sw_rows_v41(profile: torch.Tensor, subjects: torch.Tensor, *, gap: int, strip: int = 32) -> torch.Tensor:
    """K10 v41: K2's warp wavefront with the hand-off as a rotate, bands of ``strip`` rows."""
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
