"""Row-parallel Smith-Waterman scoring in plain PyTorch (``swtpu.ops.xla_sw``).

This is the port of swtpu's XLA scorers, the row path's own arithmetic, and
not a fallback: it runs on whichever device its tensors lie on, the card
included, and it is also the plain version of the CUDA kernels K2 and K3
(``swtpu_torch.ops.bucket_sw``).  A bucket is a row-major ``(B, L)`` int8
array of subjects (pads ``PAD_SUBJECT``); a stack is ``(C, B, L)``, C
same-shape buckets.  Each function takes the arguments of its swtpu twin and
gives the same integers.

The recurrence is swtpu's: in u-space, ``u[j] = H[j] + g*j``, a query row is
``t_u = max(g*j, diag_u + s + g, u_prev - g)`` then ``u = cummax(t_u)``, and
the best H is the max of ``t_u - g*j``.  The int16 variants reproduce swtpu's
casts, clamps (``min(t_u, satu)``), boundary constant (``diag_u`` padded with
``-g``) and ``stage_int8`` folding one for one: torch wraps int16 overflow
silently, and swtpu's bounds (``fast16_sat``, ``segpack.seg16_sat``) rule
out a wrap only under exactly those steps.

Where swtpu stages a strip of scores as a one-hot int8 matmul (an MXU
trick), here each query row's scores are one exact gather, ``table[r][idx]``
over the whole stack, so a stack costs one set of torch operations a query
row (``row_steps`` counts them), never one set a bucket.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .profile import PAD_SUBJECT, make_profile

# Fast-path saturation margin: profiles are int8, so one substitution adds at
# most 127 to a cell.
_PROFILE_MAX = 127

# Saturation ceiling of the narrow-type (int16) parity mode: the reference's
# char path stores scores in shorts and truncates; here they saturate, and
# the engine rescores saturated rows exactly in int32.
SAT16_MAX = 32767


def fast16_sat(gap: int, width: int) -> int:
    """Largest exact score the int16 fast path can certify for a bucket.

    Everything in u-space must fit int16: sat + gap*(L-1) + 127 + gap <=
    32767.  Scores >= the returned value mean "rescore exactly in int32".
    Returns <= 0 when the bucket is too wide for int16.
    """
    return 32767 - _PROFILE_MAX - gap * width


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _check(profile: torch.Tensor, strip: int) -> int:
    if profile.dim() != 2:
        raise ValueError(f"profile must be (qpad, 32), got {tuple(profile.shape)}")
    qpad = profile.shape[0]
    if strip < 1 or qpad % strip:
        raise ValueError(f"profile rows {qpad} must be a multiple of strip {strip}")
    return qpad


def _index(subjects: torch.Tensor) -> torch.Tensor:
    """Residue indices of a bucket or stack, as gather indices."""
    return subjects.to(torch.int32)


def _u_rows(
    table: torch.Tensor,
    idx: torch.Tensor,
    u: torch.Tensor,
    bestu: torch.Tensor,
    floor: torch.Tensor,
    gap: int,
    cap: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Advance the u-space DP by one query row per row of ``table``.

    ``table[r]`` holds row r's ``s + g`` per residue in the state's dtype;
    ``floor`` is the fresh-start value (``g*j``, or a segment rebase) and
    ``cap`` the saturation clamp.  All arithmetic stays in ``u``'s dtype.
    """
    row_steps = 0
    for r in range(table.shape[0]):
        t = table[r][idx]  # s + g, one exact gather over the whole stack
        t[..., 1:] += u[..., :-1]  # diag_u + s + g
        t[..., :1] += -gap  # column -1 has H = 0, so diag_u = -g
        torch.maximum(t, u - gap, out=t)
        torch.maximum(t, floor, out=t)
        if cap is not None:
            torch.minimum(t, cap, out=t)
        u = torch.cummax(t, dim=-1).values
        bestu = torch.maximum(bestu, t)
        row_steps += 1
    _u_rows.row_steps += row_steps
    return u, bestu


_u_rows.row_steps = 0  # query-row steps over a whole bucket or stack, since last set to 0


def row_steps() -> int:
    """Query-row steps run since the count was last set to 0 (each is ~9
    torch operations over one bucket or stack)."""
    return _u_rows.row_steps


def reset_row_steps() -> None:
    _u_rows.row_steps = 0


def _rebase(L: int, gap: int, dtype, device) -> torch.Tensor:
    return torch.arange(L, dtype=dtype, device=device) * gap


def _score_int32(profile: torch.Tensor, stack: torch.Tensor, gap: int) -> torch.Tensor:
    """(..., L) subjects -> (...,) exact int32 max scores."""
    L = stack.shape[-1]
    rebase = _rebase(L, gap, torch.int32, stack.device)
    u = rebase.expand(stack.shape).contiguous()
    table = profile.to(torch.int32) + gap
    _, bestu = _u_rows(table, _index(stack), u, u, rebase, gap)
    return (bestu - rebase).amax(dim=-1).to(torch.int32)


def sw_score_bucket(profile, subjects, *, gap: int, strip: int = 16) -> torch.Tensor:
    """Max local-alignment score of one query vs B subjects (exact int32).

    Args:
      profile: (qpad, 32) int8 query profile, qpad % strip == 0.
      subjects: (B, L) int8 residue indices, pads = PAD_SUBJECT.
      gap: linear gap penalty.
      strip: query rows per strip (swtpu's MXU strip; checked, not used).

    Returns:
      (B,) int32 max scores.
    """
    profile, subjects = _tensor(profile), _tensor(subjects)
    _check(profile, strip)
    return _score_int32(profile, subjects, gap)


def sw_score_rows(profile, subjects, u_in, bestu_in, *, gap: int, strip: int = 16):
    """Advance the u-space DP by ``qpad`` query rows from an explicit carry.

    Carry-in of ``u = bestu = g*j`` reproduces :func:`sw_score_bucket`; the
    final score is ``max(bestu - g*j, axis=1)``.  Returns (u, bestu), (B, L)
    int32 each.
    """
    profile, subjects = _tensor(profile), _tensor(subjects)
    _check(profile, strip)
    L = subjects.shape[-1]
    rebase = _rebase(L, gap, torch.int32, subjects.device)
    table = profile.to(torch.int32) + gap
    return _u_rows(table, _index(subjects), _tensor(u_in).to(torch.int32), _tensor(bestu_in).to(torch.int32), rebase, gap)


def _table16(profile: torch.Tensor, gap: int, stage_int8: bool) -> torch.Tensor:
    """Per-row ``s + g`` in int16, staged as swtpu stages it: with
    ``stage_int8`` the gap is folded into the int8 profile first (the caller
    guarantees matrix_max + gap <= 127), else added in int16."""
    if stage_int8:
        return (profile.to(torch.int16) + gap).to(torch.int8).to(torch.int16)
    return profile.to(torch.int32).to(torch.int16) + gap


def _score_fast16(profile: torch.Tensor, stack: torch.Tensor, gap: int, sat: int, stage_int8: bool) -> torch.Tensor:
    L = stack.shape[-1]
    if not 0 < sat <= fast16_sat(gap, L):
        raise ValueError(f"sat {sat} too large for int16 u-space at width {L}")
    rebase = _rebase(L, gap, torch.int16, stack.device)
    satu = rebase + sat  # per-column clamp in u-space
    u = rebase.expand(stack.shape).contiguous()
    _, bestu = _u_rows(_table16(profile, gap, stage_int8), _index(stack), u, u, rebase, gap, cap=satu)
    return (bestu - rebase).to(torch.int32).amax(dim=-1)


def sw_score_bucket_fast16(
    profile, subjects, *, gap: int, strip: int = 16, sat: int, stage_int8: bool = False
) -> torch.Tensor:
    """int16 u-space scoring, exact below ``sat`` (use :func:`fast16_sat`).

    Rows that reach ``sat`` are saturated and must be rescored exactly.
    With ``stage_int8`` the gap is folded into the int8 profile, so the
    CALLER must guarantee matrix_max + gap <= 127.  Returns (B,) int32,
    clamped at sat.
    """
    profile, subjects = _tensor(profile), _tensor(subjects)
    _check(profile, strip)
    return _score_fast16(profile, subjects, gap, sat, stage_int8)


def _score_sat16(profile: torch.Tensor, stack: torch.Tensor, gap: int) -> torch.Tensor:
    L = stack.shape[-1]
    dev = stack.device
    rebase = _rebase(L, gap, torch.int32, dev)
    idx = _index(stack)
    prof = profile.to(torch.int32)
    h = torch.zeros(stack.shape, dtype=torch.int16, device=dev)
    best = torch.zeros(stack.shape[:-1], dtype=torch.int32, device=dev)
    for r in range(prof.shape[0]):
        h_prev = h.to(torch.int32)
        t = prof[r][idx]
        t[..., 1:] += h_prev[..., :-1]  # diag + s; column -1 has H = 0
        torch.maximum(t, h_prev - gap, out=t)
        t.clamp_(0, SAT16_MAX)  # max(0, .) then the saturating min
        h = (torch.cummax(t + rebase, dim=-1).values - rebase).to(torch.int16)
        best = torch.maximum(best, t.amax(dim=-1))
    _u_rows.row_steps += prof.shape[0]
    return best


def sw_score_bucket_sat16(profile, subjects, *, gap: int, strip: int = 16) -> torch.Tensor:
    """Narrow-type (int16) saturating SW scoring of one query vs B subjects.

    The DP row is carried as int16 and cell values saturate at SAT16_MAX:
    scores are exact until a cell would exceed 32767, after which that
    alignment's score sticks at 32767 ("saturated, rescore exactly" -- the
    engine does that when ``score_dtype='int16'``).  Returns (B,) int32 in
    [0, SAT16_MAX].
    """
    profile, subjects = _tensor(profile), _tensor(subjects)
    _check(profile, strip)
    return _score_sat16(profile, subjects, gap)


def _score_seg16(
    profile: torch.Tensor, stack: torch.Tensor, rebase: torch.Tensor, seg_ends: torch.Tensor, gap: int, sat: int,
    stage_int8: bool,
) -> torch.Tensor:
    L = stack.shape[-1]
    reb = rebase.to(torch.int16)
    satu = reb + sat
    _, bestu = _u_rows(_table16(profile, gap, stage_int8), _index(stack), reb, reb, reb, gap, cap=satu)
    # bestu - g*j' is each column's best H plus its segment's jump offset.
    gj = _rebase(L, gap, torch.int32, stack.device).to(torch.int16)
    z = torch.cummax((bestu - gj).to(torch.int32), dim=-1).values
    return torch.take_along_dim(z, seg_ends.to(torch.int64), dim=-1)


def sw_score_bucket_seg16(
    profile, subjects, rebase, seg_ends, *, gap: int, strip: int = 16, sat: int, stage_int8: bool = False
) -> torch.Tensor:
    """Segment-packed fast16 scoring: several subjects share one batch row.

    Within segment s, ``rebase[j] = g*j' + s*D`` (D > sat), so a contribution
    from a previous segment arrives attenuated below zero: segments are
    exactly independent with no masking (swtpu.utils.segpack).

    Args:
      profile: (qpad, 32) int8, qpad % strip == 0.
      subjects: (B, L) int8, pads = PAD_SUBJECT.
      rebase: (B, L) int16 u-space rebase with D jumps.
      seg_ends: (B, S) int32 last real column of each segment.
      gap, strip, sat, stage_int8: as in sw_score_bucket_fast16; the caller
        guarantees S_max * (sat + 1) + gap * L + 127 <= 32767.

    Returns:
      (B, S) int32 per-segment max scores in u-jump space (the caller
      subtracts the per-slot jump offsets: swtpu_torch.utils.segpack.extract_scores).
    """
    profile, subjects = _tensor(profile), _tensor(subjects)
    _check(profile, strip)
    return _score_seg16(profile, subjects, _tensor(rebase), _tensor(seg_ends), gap, sat, stage_int8)


def sw_score_stack_seg16(
    profile, stack, rebases, seg_ends, *, gap: int, strip: int = 16, sat: int, stage_int8: bool = False
) -> torch.Tensor:
    """Segment-packed scoring of a (C, B, L) stack: (C, B, S) int32."""
    return sw_score_bucket_seg16(profile, stack, rebases, seg_ends, gap=gap, strip=strip, sat=sat, stage_int8=stage_int8)


def sw_score_stack(profile, stack, *, gap: int, strip: int = 16) -> torch.Tensor:
    """Exact int32 scoring of a (C, B, L) stack of same-shape buckets:
    (C, B) int32, every chunk in the same torch operations."""
    return sw_score_bucket(profile, stack, gap=gap, strip=strip)


def sw_score_stack_fast16(
    profile, stack, *, gap: int, strip: int = 16, sat: int, stage_int8: bool = False
) -> torch.Tensor:
    """fast16 scoring of a (C, B, L) stack (see :func:`sw_score_stack`)."""
    return sw_score_bucket_fast16(profile, stack, gap=gap, strip=strip, sat=sat, stage_int8=stage_int8)


def sw_score_pairs(query_idx: np.ndarray, subjects: list, matrix: np.ndarray, gap: int, strip: int = 16) -> np.ndarray:
    """Convenience: score a query against a ragged list of subjects, padded
    to one width (the engine proper uses length buckets)."""
    prof = make_profile(query_idx, matrix, pad_rows_to=strip)
    L = max(max((len(s) for s in subjects), default=1), 1)
    batch = np.full((len(subjects), L), PAD_SUBJECT, dtype=np.int8)
    for i, s in enumerate(subjects):
        batch[i, : len(s)] = s
    return sw_score_bucket(prof, batch, gap=gap, strip=strip).numpy()
