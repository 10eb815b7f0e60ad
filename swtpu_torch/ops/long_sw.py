"""Smith-Waterman scores of one query against long database sequences,
each scored with the roles swapped (``csrc/sw_long.cu``).

The prefiltered search scores its candidates of at most 992 residues on the
wavefront kernel (``wave_sw.sw_wave``: the query down the rows, the subjects
along the columns of a padded bucket) and the longer ones here: the sequence
down the rows of the DP, the query along its columns, one block a sequence
and a band of 32 rows a thread, so a launch's serial chain is (rows / 4,096
passes) x (query length + 172) steps and not the longest candidate's length
a pass (the kernel's source note).  Swapping the sequences changes no score:
the cell (row r, column c) reads ``matrix[query[c]][sequence[r]]`` and the
two gap moves trade places under the same costs.

The sequences are read where the database keeps them resident: ``flat``, the
int8 residues end to end, and ``offsets``, its int64 record offsets; ``ids``
names the ones to score.  ``sw_long`` launches the kernel for tensors on the
card and runs ``sw_long_plain`` for tensors on the CPU, never one for the
other.  Scores are exact int32.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..alphabet import ALPHABET_SIZE
from ..alphabet import PADDED_ALPHABET_SIZE as A32
from . import _build, wave_sw
from .profile import make_profile


def matrix_table(matrix: np.ndarray) -> np.ndarray:
    """The kernel's (25, 32) int8 table of a substitution matrix, [query
    letter][residue]: ``make_profile`` of the alphabet, pad residues at
    PAD_SCORE."""
    return make_profile(np.arange(ALPHABET_SIZE), matrix)


def _check(query, flat, offsets, ids, table) -> None:
    dev = flat.device
    for name, t, dtype in (("query", query, torch.int8), ("flat", flat, torch.int8),
                           ("offsets", offsets, torch.int64), ("ids", ids, torch.int64),
                           ("table", table, torch.int8)):
        if t.dtype != dtype or t.dim() != (2 if name == "table" else 1):
            raise ValueError(f"{name} must be a {'2' if name == 'table' else '1'}-D {dtype} tensor, "
                             f"got {tuple(t.shape)} {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device} but flat on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tuple(table.shape) != (ALPHABET_SIZE, A32):
        raise ValueError(f"table must be ({ALPHABET_SIZE}, {A32}) int8 (matrix_table), got {tuple(table.shape)}")


def sw_long(query: torch.Tensor, flat: torch.Tensor, offsets: torch.Tensor, ids: torch.Tensor, table: torch.Tensor,
            *, gap=None, gap_open=None, gap_extend=None) -> torch.Tensor:
    """Exact int32 SW scores of ``query`` against the sequences ``ids``.

    Args:
      query: (m,) int8 letters of the alphabet (below 25).
      flat: the database's int8 residues end to end.
      offsets: its (n + 1,) int64 record offsets.
      ids: (k,) int64 records to score; the kernel starts them in this order,
        so the caller puts the longest first.
      table: ``matrix_table(matrix)`` on the same device.
      gap, or gap_open with gap_extend: as ``wave_sw.sw_wave``.

    Returns:
      (k,) int32 on the inputs' device: the score of ids[i] at i.
    """
    gaps = wave_sw.gap_model(gap, gap_open, gap_extend)
    _check(query, flat, offsets, ids, table)
    if flat.device.type == "cpu":
        return sw_long_plain(query, flat, offsets, ids, table, gap=gap, gap_open=gap_open, gap_extend=gap_extend)
    if flat.device.type != "cuda":
        raise ValueError(f"sw_long runs on CPU or CUDA tensors, not {flat.device}")
    dev = flat.device
    k, m = ids.shape[0], query.shape[0]
    if k == 0 or m == 0:
        return torch.zeros(k, dtype=torch.int32, device=dev)
    affine = gaps[1] is not None
    out = torch.empty(k, dtype=torch.int32, device=dev)
    # A pass boundary's carry: one slot a query column and sequence, (H) or (H, F).
    carry = torch.empty(k * m * (2 if affine else 1), dtype=torch.int32, device=dev)
    lib = _kernel_lib()
    rc = lib.sw_long_launch(query.data_ptr(), m, flat.data_ptr(), offsets.data_ptr(), ids.data_ptr(), k,
                            table.data_ptr(), carry.data_ptr(), out.data_ptr(), gaps[0], gaps[1] or 0, int(affine),
                            *_build.where(dev))
    _build.check(rc, lib.sw_long_error_string, "sw_long kernel launch")
    sw_long.launches += 1
    return out


sw_long.launches = 0  # kernel launches since the count was last set to 0

_kernel_lib = _build.Library(
    "sw_long",
    sw_long_launch=[ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
)


def sw_long_plain(query: torch.Tensor, flat: torch.Tensor, offsets: torch.Tensor, ids: torch.Tensor,
                  table: torch.Tensor, *, gap=None, gap_open=None, gap_extend=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device (same arguments).

    The same orientation as the kernel: the sequences, gathered into a (k,
    longest) array, down the rows, one row of every sequence at a time; the
    query along the columns, the row recurrences of ``wave_sw``'s plain
    version (``_sw_rows``: linear, one cummax; ``_sw_rows_affine``: Gotoh,
    the closed-form E), each row's scores ``table[query, residue].T``.  Rows
    past a sequence's end update nothing.
    """
    gaps = wave_sw.gap_model(gap, gap_open, gap_extend)
    _check(query, flat, offsets, ids, table)
    dev = flat.device
    k, m = ids.shape[0], query.shape[0]
    best = torch.zeros(k, dtype=torch.int32, device=dev)
    if k == 0 or m == 0:
        return best
    starts = offsets[ids]
    lens = offsets[ids + 1] - starts
    longest = int(lens.max())
    pos = torch.arange(longest, dtype=torch.int64, device=dev)
    real = pos[None, :] < lens[:, None]  # (k, longest)
    idx = torch.where(real, starts[:, None] + pos[None, :], 0)
    res = torch.where(real, flat[idx].long() & (A32 - 1), 0) if flat.numel() else torch.zeros_like(idx)
    # prof[b, c]: the score of residue b against query column c
    prof = table.to(torch.int32)[query.long()].T.contiguous()  # (32, m)
    if gaps[1] is None:
        g = gaps[0]
        rebase = torch.arange(m, dtype=torch.int32, device=dev) * g
        edge = torch.full((k, 1), -g, dtype=torch.int32, device=dev)
        u = rebase.expand(k, m)  # H = 0 above row 0, in u-space (H + gap * column)
        for r in range(longest):
            diag = torch.cat([edge, u[:, :-1]], dim=1)
            t = torch.maximum(torch.maximum(diag + prof[res[:, r]] + g, u - g), rebase)
            u_new = torch.cummax(t, dim=1).values
            row_best = (t - rebase).amax(dim=1).to(torch.int32)
            live = real[:, r]
            best = torch.where(live, torch.maximum(best, row_best), best)
            u = torch.where(live[:, None], u_new, u)
        return best
    gap_open, gap_extend = gaps
    ramp = torch.arange(m, dtype=torch.int32, device=dev) * gap_extend
    zero = torch.zeros((k, 1), dtype=torch.int32, device=dev)
    h = torch.zeros((k, m), dtype=torch.int32, device=dev)
    f = torch.full((k, m), wave_sw.NEG, dtype=torch.int32, device=dev)  # F above row 0
    for r in range(longest):
        f_new = torch.maximum(h - gap_open, f - gap_extend)
        diag = torch.cat([zero, h[:, :-1]], dim=1)
        t = torch.maximum(diag + prof[res[:, r]], f_new).clamp_min_(0)
        e = torch.cummax(torch.cat([zero, t[:, :-1]], dim=1) + ramp, dim=1).values
        h_new = torch.maximum(t, e - ramp - gap_open)
        live = real[:, r]
        best = torch.where(live, torch.maximum(best, h_new.amax(dim=1)), best)
        h = torch.where(live[:, None], h_new, h)
        f = torch.where(live[:, None], f_new, f)
    return best
