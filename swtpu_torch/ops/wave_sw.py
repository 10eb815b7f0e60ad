"""Wavefront Smith-Waterman scoring of one or Q queries against a transposed bucket.

Counterpart of ``swtpu.ops.wave_sw.sw_wave`` in its linear and affine
(Gotoh) modes.  A bucket is a ``(L2, B)`` int8 array of subjects laid along
lanes (``L2 = width + W``, the last ``W`` columns pad); with ``n_segs > 1``
each lane holds ``n_segs`` subjects end to end in equal segments of
``seg_cols = (L2 - W) / n_segs`` columns.  The result is the exact int32
Smith-Waterman maximum of each (lane, segment), flat and lane-major:
``out[lane * n_segs + seg]``.  A ``(Q, qpad, 32)`` stack of profiles scores Q
queries in one launch (swtpu's 4-D ``lhsB``) and gives ``(Q, B * n_segs)``.
Gaps are linear (``gap=``) or affine (``gap_open=``, ``gap_extend=``: a
length-L gap costs ``gap_open + (L-1) * gap_extend``).

``sw_wave`` launches the hand-written CUDA kernel (``csrc/sw_wave.cu``) for
tensors on the card and runs ``sw_wave_plain`` for tensors on the CPU.  It
never swaps one for the other: a CUDA tensor either reaches the kernel or
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..alphabet import PADDED_ALPHABET_SIZE as A32
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


def sw_wave(
    profile: torch.Tensor,
    subjT: torch.Tensor,
    *,
    gap: Optional[int] = None,
    n_segs: int = 1,
    gap_open: Optional[int] = None,
    gap_extend: Optional[int] = None,
) -> torch.Tensor:
    """Exact int32 SW max of one or Q query profiles vs every (lane, segment).

    Args:
      profile: (qpad, 32) int8 query profile (swtpu_torch.ops.profile), or a
        (Q, qpad, 32) stack of Q equal-length profiles; qpad % W == 0.
      subjT: (L2, B) int8 transposed bucket, pads PAD_SUBJECT.
      gap: linear gap penalty.
      n_segs: subjects chained per lane.
      gap_open, gap_extend: affine (Gotoh) gaps instead of ``gap``: a
        length-L gap costs gap_open + (L-1) * gap_extend.

    Returns:
      (B * n_segs,) int32 on the inputs' device, lane-major; (Q, B * n_segs)
      for a profile stack.
    """
    gaps = gap_model(gap, gap_open, gap_extend)
    seg_cols = _check(profile, subjT, n_segs)
    if subjT.device.type == "cpu":
        return _plain(profile, subjT, gaps, n_segs, seg_cols)
    if subjT.device.type != "cuda":
        raise ValueError(f"sw_wave runs on CPU or CUDA tensors, not {subjT.device}")
    return _sw_wave_cuda(profile, subjT, gaps, n_segs, seg_cols)


sw_wave.launches = 0  # kernel launches since the count was last set to 0
sw_wave.multi_launches = 0  # of those, launches with a (Q, qpad, 32) profile stack
sw_wave.affine_launches = 0  # of those, launches with affine gaps


def _kernel_lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("sw_wave")
    if lib.sw_wave_launch.argtypes is None:
        lib.sw_wave_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.sw_wave_launch.restype = ctypes.c_int
        lib.sw_wave_affine_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.sw_wave_affine_launch.restype = ctypes.c_int
        lib.sw_wave_error_string.argtypes = [ctypes.c_int]
        lib.sw_wave_error_string.restype = ctypes.c_char_p
    return lib


def carry_bytes(n_bands: int, n_segs: int, seg_cols: int, lanes: int, affine: bool = False) -> int:
    """Device bytes of one query's band carry in a launch: the bottom H row
    of each band, one int32 per column and lane, and in affine mode the
    bottom F row beside it.  A single band has no successor and needs none."""
    planes = 2 if affine else 1
    return 4 * planes * n_segs * seg_cols * lanes if n_bands > 1 else 0


def _sw_wave_cuda(profile, subjT, gaps: Gaps, n_segs, seg_cols) -> torch.Tensor:
    lib = _kernel_lib()
    dev = subjT.device
    multi = profile.dim() == 3
    affine = gaps[1] is not None
    prof3 = profile if multi else profile[None]
    n_q, n_bands = prof3.shape[0], prof3.shape[1] // W
    B = subjT.shape[1]
    out = torch.empty(n_q, B * n_segs, dtype=torch.int32, device=dev)
    if B == 0:
        return out if multi else out[0]
    # Each query has its own carry slice: blocks of different queries run at once.
    carry = torch.empty(n_q * carry_bytes(n_bands, n_segs, seg_cols, B, affine) // 4, dtype=torch.int32, device=dev)
    args = (prof3.data_ptr(), subjT.data_ptr(), carry.data_ptr(), out.data_ptr(), n_q, n_bands, B, n_segs, seg_cols)
    where = (dev.index if dev.index is not None else torch.cuda.current_device(), torch.cuda.current_stream(dev).cuda_stream)
    if affine:
        rc = lib.sw_wave_affine_launch(*args, gaps[0], gaps[1], *where)
    else:
        rc = lib.sw_wave_launch(*args, gaps[0], *where)
    if rc != 0:
        raise RuntimeError(f"sw_wave kernel launch failed: {lib.sw_wave_error_string(rc).decode()} ({rc})")
    sw_wave.launches += 1
    sw_wave.multi_launches += int(multi)
    sw_wave.affine_launches += int(affine)
    return out if multi else out[0]


def sw_wave_plain(
    profile: torch.Tensor,
    subjT: torch.Tensor,
    *,
    gap: Optional[int] = None,
    n_segs: int = 1,
    gap_open: Optional[int] = None,
    gap_extend: Optional[int] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device (same arguments).

    Un-chains the bucket into (B * n_segs, seg_cols) rows and runs a row
    recurrence vectorised over rows and columns with torch.cummax, one
    query after another for a profile stack: the u-space recurrence of
    swtpu.ops.xla_sw.sw_score_bucket for linear gaps, the closed-form Gotoh
    row of swtpu.ops.oracle.sw_affine_matrices for affine ones.  When pads
    score <= 0 (every profile from make_profile), rows that hold no residue
    score 0 and trailing all-pad columns cannot raise a max, under either
    gap model, so both are dropped before the recurrence.
    """
    gaps = gap_model(gap, gap_open, gap_extend)
    return _plain(profile, subjT, gaps, n_segs, _check(profile, subjT, n_segs))


def _plain(profile: torch.Tensor, subjT: torch.Tensor, gaps: Gaps, n_segs: int, seg_cols: int) -> torch.Tensor:
    if profile.dim() == 3:
        return torch.stack([_plain_one(p, subjT, gaps, n_segs, seg_cols) for p in profile])
    return _plain_one(profile, subjT, gaps, n_segs, seg_cols)


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
    best = _sw_rows(prof, idx, gaps[0]) if gaps[1] is None else _sw_rows_affine(prof, idx, *gaps)
    if keep is None:
        return best
    out[keep] = best
    return out


def _sw_rows(prof: torch.Tensor, idx: torch.Tensor, gap: int) -> torch.Tensor:
    """(N,) int32 SW max of a (qpad, 32) int32 profile vs (N, L) index rows.

    u[j] = H[j] + gap*j turns the in-row recurrence H[j] = max(T[j],
    H[j-1] - gap) into u = cummax(T + gap*j); the max of H is the max of
    t_u - gap*j over all rows.
    """
    N, L = idx.shape
    rebase = torch.arange(L, dtype=torch.int32, device=idx.device) * gap
    prof_g = prof + gap
    edge = torch.full((N, 1), -gap, dtype=torch.int32, device=idx.device)  # column -1: H = 0
    u = rebase.expand(N, L)
    bestu = u
    for i in range(prof.shape[0]):
        diag = torch.cat([edge, u[:, :-1]], dim=1)
        t = torch.maximum(torch.maximum(diag + prof_g[i][idx], u - gap), rebase)
        u = torch.cummax(t, dim=1).values
        bestu = torch.maximum(bestu, t)
    return (bestu - rebase).amax(dim=1).to(torch.int32)


def _sw_rows_affine(prof: torch.Tensor, idx: torch.Tensor, gap_open: int, gap_extend: int) -> torch.Tensor:
    """(N,) int32 Gotoh SW max of a (qpad, 32) int32 profile vs (N, L) index rows.

    Per query row: F = max(H_up - open, F_up - ext) elementwise from the
    previous row; T = max(0, diag + s, F); and, because open >= ext, the
    in-row E chain is closed-form: E[c] = max over k <= c of (V[k] + ext*k)
    - open - ext*c, with V[0] = 0 (the left boundary's H) and V[k] = T[k-1],
    which is one cummax; H = max(T, E).
    """
    N, L = idx.shape
    dev = idx.device
    ramp = torch.arange(L, dtype=torch.int32, device=dev) * gap_extend
    zero = torch.zeros((N, 1), dtype=torch.int32, device=dev)
    h = torch.zeros((N, L), dtype=torch.int32, device=dev)
    f = torch.full((N, L), NEG, dtype=torch.int32, device=dev)  # F above row 0
    best = h
    for i in range(prof.shape[0]):
        f = torch.maximum(h - gap_open, f - gap_extend)
        diag = torch.cat([zero, h[:, :-1]], dim=1)
        t = torch.maximum(diag + prof[i][idx], f).clamp_min_(0)
        u = torch.cummax(torch.cat([zero, t[:, :-1]], dim=1) + ramp, dim=1).values
        h = torch.maximum(t, u - ramp - gap_open)
        best = torch.maximum(best, h)
    return best.amax(dim=1).to(torch.int32)
