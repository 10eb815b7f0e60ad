"""Wavefront Smith-Waterman scoring of one query against a transposed bucket.

Counterpart of ``swtpu.ops.wave_sw.sw_wave`` in its single-query linear
modes.  A bucket is a ``(L2, B)`` int8 array of subjects laid along lanes
(``L2 = width + W``, the last ``W`` columns pad); with ``n_segs > 1`` each lane
holds ``n_segs`` subjects end to end in equal segments of
``seg_cols = (L2 - W) / n_segs`` columns.  The result is the exact int32
Smith-Waterman maximum of each (lane, segment), flat and lane-major:
``out[lane * n_segs + seg]``.

``sw_wave`` launches the hand-written CUDA kernel (``csrc/sw_wave.cu``) for
tensors on the card and runs ``sw_wave_plain`` for tensors on the CPU.  It
never swaps one for the other: a CUDA tensor either reaches the kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..alphabet import PADDED_ALPHABET_SIZE as A32
from .profile import PAD_SUBJECT

W = 32  # query rows per band, and the trailing pad columns of every bucket

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


def _check(profile: torch.Tensor, subjT: torch.Tensor, gap: int, n_segs: int) -> int:
    """Validate the kernel's contract; returns seg_cols."""
    if profile.dtype != torch.int8 or profile.dim() != 2 or profile.shape[1] != A32:
        raise ValueError(f"profile must be (qpad, {A32}) int8, got {tuple(profile.shape)} {profile.dtype}")
    if profile.shape[0] == 0 or profile.shape[0] % W:
        raise ValueError(f"profile rows {profile.shape[0]} must be a positive multiple of {W}")
    if subjT.dtype != torch.int8 or subjT.dim() != 2:
        raise ValueError(f"subjT must be (L2, B) int8, got {tuple(subjT.shape)} {subjT.dtype}")
    if profile.device != subjT.device:
        raise ValueError(f"profile on {profile.device} but subjT on {subjT.device}")
    if not (profile.is_contiguous() and subjT.is_contiguous()):
        raise ValueError("profile and subjT must be contiguous")
    if gap < 0:
        raise ValueError("gap must be >= 0")
    cols = subjT.shape[0] - W
    if n_segs < 1 or cols < n_segs or cols % n_segs:
        raise ValueError(f"n_segs={n_segs} must divide the column count {cols}")
    return cols // n_segs


def sw_wave(profile: torch.Tensor, subjT: torch.Tensor, *, gap: int, n_segs: int = 1) -> torch.Tensor:
    """Exact int32 SW max of one query profile vs every (lane, segment).

    Args:
      profile: (qpad, 32) int8 query profile (swtpu_torch.ops.profile), qpad % W == 0.
      subjT: (L2, B) int8 transposed bucket, pads PAD_SUBJECT.
      gap: linear gap penalty.
      n_segs: subjects chained per lane.

    Returns:
      (B * n_segs,) int32 on the inputs' device, lane-major.
    """
    seg_cols = _check(profile, subjT, gap, n_segs)
    if subjT.device.type == "cpu":
        return sw_wave_plain(profile, subjT, gap=gap, n_segs=n_segs)
    if subjT.device.type != "cuda":
        raise ValueError(f"sw_wave runs on CPU or CUDA tensors, not {subjT.device}")
    return _sw_wave_cuda(profile, subjT, gap, n_segs, seg_cols)


sw_wave.launches = 0  # kernel launches since the count was last set to 0


def _kernel_lib() -> ctypes.CDLL:
    from ._build import load

    lib = load("sw_wave")
    fn = lib.sw_wave_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.sw_wave_error_string.argtypes = [ctypes.c_int]
        lib.sw_wave_error_string.restype = ctypes.c_char_p
    return lib


def _sw_wave_cuda(profile, subjT, gap, n_segs, seg_cols) -> torch.Tensor:
    lib = _kernel_lib()
    dev = subjT.device
    n_bands = profile.shape[0] // W
    B = subjT.shape[1]
    out = torch.empty(B * n_segs, dtype=torch.int32, device=dev)
    if B == 0:
        return out
    # Band carry: the bottom H row of each band, one int32 per column and
    # lane.  A single band has no successor and needs none.
    carry = torch.empty(n_segs * seg_cols * B if n_bands > 1 else 0, dtype=torch.int32, device=dev)
    rc = lib.sw_wave_launch(
        profile.data_ptr(), subjT.data_ptr(), carry.data_ptr(), out.data_ptr(),
        n_bands, B, n_segs, seg_cols, gap, dev.index if dev.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"sw_wave kernel launch failed: {lib.sw_wave_error_string(rc).decode()} ({rc})")
    sw_wave.launches += 1
    return out


def sw_wave_plain(profile: torch.Tensor, subjT: torch.Tensor, *, gap: int, n_segs: int = 1) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device.

    Un-chains the bucket into (B * n_segs, seg_cols) rows and runs the u-space
    row recurrence of swtpu.ops.xla_sw.sw_score_bucket with torch.cummax.
    When pads score <= 0 (every profile from make_profile), rows that hold no
    residue score 0 and trailing all-pad columns cannot raise a max, so both
    are dropped before the recurrence.
    """
    seg_cols = _check(profile, subjT, gap, n_segs)
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
    best = _sw_rows(prof, idx, gap)
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
