"""Segment packing: several short subjects per row (``swtpu.utils.segpack``).

Length-bucketed batching pads every subject to its bucket width, ~1.4x
wasted cells on SwissProt-shaped data.  Segment packing instead bins all
short sequences into one wide row class: each (row, width) slot holds up to
S_MAX sequences separated by single pad columns, and the DP keeps the
segments exactly independent through the u-space rebase vector alone
(swtpu_torch.ops.row_sw.sw_score_bucket_seg16): within segment s, rebase[j]
= g*j + s*D with D > sat, which attenuates any cross-segment contribution
below zero at no extra per-row cost.

The price is a lower saturation ceiling (~3,900 for W=512, S_MAX=8); scores
that reach it are rescored exactly by the engine, so results stay exact.
The native segment packer (swtpu_torch.native) writes each batch on the
host, in place into its group's stack (``pack_segments_plain`` is its NumPy
version); the stacks, rebases and segment ends are uploaded to the engine's
device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import native
from ..io.fasta import Database
from ..ops.profile import PAD_SUBJECT
from ..ops.row_sw import _PROFILE_MAX


def seg16_sat(gap: int, width: int, s_max: int) -> int:
    """Largest exact score per segment for a packed row class.

    Everything in u-space must fit int16: g*W + (S-1)*(sat+1) + sat +
    PROFILE_MAX <= 32767.
    """
    return (32767 - _PROFILE_MAX - gap * width - (s_max - 1)) // s_max - 1


@dataclasses.dataclass(frozen=True)
class SegBatch:
    """One packed batch: rows of up to S_MAX subject segments."""

    ids: np.ndarray  # (rows, S) int64 sequence ids, -1 = empty slot
    starts: np.ndarray  # (rows, S) int32 first column of each segment
    ends: np.ndarray  # (rows, S) int32 last real column (inclusive)
    rows: int
    width: int
    s_max: int

    @property
    def n_valid(self) -> int:
        return int((self.ids >= 0).sum())


def plan_multiclass(
    lengths: np.ndarray,
    ids: np.ndarray,
    widths: Tuple[int, ...],
    s_max_for,
    batch_rows_for,
) -> List[Tuple[int, List[SegBatch]]]:
    """Global multi-width-class packing of all given sequences.

    Classes are processed widest first: every still-unplaced sequence that
    only fits this class (len >= next narrower width) opens a row, and row
    gaps are filled greedily with the largest still-unplaced sequence of any
    length that fits (largest-fit-decreasing over a skip-pointer structure).
    Every sequence must be shorter than max(widths).

    Returns [(width, [SegBatch, ...]), ...] for non-empty classes.
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    ids = np.asarray(ids, dtype=np.int64)
    if lengths.size == 0:
        return []
    widths = tuple(sorted(widths))
    if int(lengths.max()) >= widths[-1]:
        raise ValueError("plan_multiclass: sequence does not fit the widest class")

    asc = np.argsort(lengths, kind="stable")
    asc_len = lengths[asc]
    n = int(lengths.size)
    # skip pointers: alive iff nxt[p] == p; a removed position points to the
    # next lower candidate (-1 = nothing alive at or below).
    nxt = np.arange(n, dtype=np.int64)

    def find(p: int) -> int:
        """Largest alive ascending-position <= p, or -1 (path-compressing)."""
        path = []
        while p >= 0 and nxt[p] != p:
            path.append(p)
            p = int(nxt[p])
        for q in path:
            nxt[q] = p
        return p

    def remove(p: int) -> None:
        nxt[p] = p - 1  # -1 when p == 0

    out: List[Tuple[int, List[SegBatch]]] = []
    lower_bounds = [0] + list(widths[:-1])
    for width, lower in zip(reversed(widths), reversed(lower_bounds)):
        s_max = s_max_for(width)
        rows: List[List[int]] = []
        top = n - 1
        while True:
            top = find(top)
            if top < 0 or asc_len[top] < lower:
                break  # no opener left for this class
            members = [int(asc[top])]
            cap = width - int(asc_len[top])
            remove(top)
            while cap >= 2 and len(members) < s_max:
                # largest remaining with length <= cap - 1 (separator column)
                hi = find(int(np.searchsorted(asc_len, cap - 1, side="right")) - 1)
                if hi < 0:
                    break
                members.append(int(asc[hi]))
                cap -= int(asc_len[hi]) + 1
                remove(hi)
            rows.append(members)
        if rows:
            out.append((width, _rows_to_batches(rows, lengths, ids, width, s_max, batch_rows_for(width))))
    return out


def plan_segments(
    lengths: np.ndarray,
    ids: np.ndarray,
    width: int = 512,
    s_max: int = 8,
    batch_rows: int = 8192,
) -> List[SegBatch]:
    """Single-class packing (see :func:`plan_multiclass`)."""
    classes = plan_multiclass(lengths, ids, (width,), lambda _w: s_max, lambda _w: batch_rows)
    return classes[0][1] if classes else []


def _rows_to_batches(
    rows: List[List[int]],
    lengths: np.ndarray,
    ids: np.ndarray,
    width: int,
    s_max: int,
    batch_rows: int,
) -> List[SegBatch]:
    batches: List[SegBatch] = []
    for base in range(0, len(rows), batch_rows):
        chunk = rows[base : base + batch_rows]
        R = len(chunk)
        bid = np.full((R, s_max), -1, dtype=np.int64)
        bst = np.zeros((R, s_max), dtype=np.int32)
        ben = np.zeros((R, s_max), dtype=np.int32)
        for r, members in enumerate(chunk):
            col = 0
            for s, idx in enumerate(members):
                if s > 0:
                    col += 1  # separator pad column
                ln = int(lengths[idx])
                bid[r, s] = ids[idx]
                bst[r, s] = col
                ben[r, s] = col + ln - 1
                col += ln
            # unused slots gather the last real end (harmless duplicates)
            last = ben[r, max(len(members) - 1, 0)]
            for s in range(len(members), s_max):
                ben[r, s] = last
        batches.append(SegBatch(ids=bid, starts=bst, ends=ben, rows=R, width=width, s_max=s_max))
    return batches


def pack_segments(db: Database, batch: SegBatch, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Materialise the (rows, width) int8 residue array for a SegBatch with
    the native segment packer, into ``out`` if given."""
    return native.pack_segments_native(db.residues, db.offsets, batch.ids, batch.starts, batch.width, PAD_SUBJECT, out=out)


def pack_segments_plain(db: Database, batch: SegBatch) -> np.ndarray:
    """NumPy version of :func:`pack_segments` (one vectorised gather of
    every member's residues; on a valid plan no member passes its row's
    end, where the native packer would cut it)."""
    out = np.full((batch.rows, batch.width), PAD_SUBJECT, dtype=np.int8)
    r, s = np.nonzero(batch.ids >= 0)
    sid = batch.ids[r, s]
    lens = db.offsets[sid + 1] - db.offsets[sid]
    first = np.cumsum(lens) - lens  # each member's first residue in the gathered order
    within = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(first, lens)
    cols = np.repeat(batch.starts[r, s].astype(np.int64), lens) + within
    out[np.repeat(r, lens), cols] = db.residues[np.repeat(db.offsets[sid], lens) + within]
    return out


def build_rebase(batch: SegBatch, gap: int, sat: int) -> np.ndarray:
    """(rows, width) int16 u-space rebase with D jumps at separator columns.

    rebase[j] = gap*j + D * segidx(j); the jump lands ON each separator
    column (start_s - 1 for s >= 1) so H[separator] == 0 by induction.
    """
    D = sat + 1
    R, W = batch.rows, batch.width
    jumps = np.zeros((R, W), dtype=np.int64)
    for s in range(1, batch.s_max):
        valid = batch.ids[:, s] >= 0
        cols = batch.starts[valid, s] - 1
        jumps[np.nonzero(valid)[0], cols] += 1
    segidx = np.cumsum(jumps, axis=1)
    rebase = gap * np.arange(W, dtype=np.int64)[None, :] + D * segidx
    assert rebase.max() + sat + _PROFILE_MAX <= 32767, "segment rebase overflows int16"
    return rebase.astype(np.int16)


def slot_offsets(batch: SegBatch, sat: int) -> np.ndarray:
    """(rows, S) int32 jump offsets J_s to subtract from gathered z values."""
    D = sat + 1
    return (np.arange(batch.s_max, dtype=np.int64)[None, :] * D).astype(np.int32) * np.ones(
        (batch.rows, 1), dtype=np.int32
    )


def extract_scores(batch: SegBatch, z_gathered: np.ndarray, sat: int) -> Tuple[np.ndarray, np.ndarray]:
    """Map kernel output (rows, S) back to (ids, scores) for valid slots."""
    vals = z_gathered.astype(np.int64) - slot_offsets(batch, sat)
    valid = batch.ids >= 0
    return batch.ids[valid], np.clip(vals[valid], 0, None).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class PackedSegGroup:
    """Stack of same-shape segment-packed batches on the engine's device.

    ``parts`` holds the (stack, rebases, ends) triple of (C, rows, ...)
    tensors, one part a device: one triple as packed here; an engine on a
    mesh splits all three into one contiguous row shard a device, so each
    device keeps the segment metadata of its own rows.  ``batches`` holds
    the host metadata for score extraction, over all the rows.
    """

    rows: int
    width: int
    s_max: int
    sat: int
    # ((C, rows, width) int8 stack, (C, rows, width) int16 rebases,
    # (C, rows, s_max) int32 ends) a part
    parts: Tuple[Tuple[torch.Tensor, torch.Tensor, torch.Tensor], ...]
    batches: Tuple[SegBatch, ...]

    @property
    def stack(self) -> torch.Tensor:
        """The (C, rows, width) int8 stack of a group in one part."""
        ((stack, _, _),) = self.parts
        return stack

    @property
    def rebases(self) -> torch.Tensor:
        ((_, rebases, _),) = self.parts
        return rebases

    @property
    def ends(self) -> torch.Tensor:
        ((_, _, ends),) = self.parts
        return ends

    @property
    def chunks(self) -> int:
        return len(self.batches)

    @property
    def cells(self) -> int:
        return self.chunks * self.rows * self.width


def _quantise_rows(rows: int, min_rows: int = 1) -> int:
    if rows > 1024:
        q = -(-rows // 512) * 512
    elif rows <= 1:
        q = 1
    else:
        q = 1 << (rows - 1).bit_length()
    # round up to the row multiple (a power of two)
    return -(-max(q, min_rows) // min_rows) * min_rows


def _pad_batch_rows(b: SegBatch, rows: int) -> SegBatch:
    if b.rows == rows:
        return b
    pad = rows - b.rows
    return SegBatch(
        ids=np.concatenate([b.ids, np.full((pad, b.s_max), -1, np.int64)]),
        starts=np.concatenate([b.starts, np.zeros((pad, b.s_max), np.int32)]),
        ends=np.concatenate([b.ends, np.zeros((pad, b.s_max), np.int32)]),
        rows=rows,
        width=b.width,
        s_max=b.s_max,
    )


def pack_seg_groups(
    db: Database,
    lengths: np.ndarray,
    ids: np.ndarray,
    *,
    gap: int,
    width: int = 512,
    s_max: int = 8,
    batch_rows: int = 8192,
) -> List[PackedSegGroup]:
    """Plan + pack + build rebases for one single-width class, on the host."""
    batches = plan_segments(lengths, ids, width=width, s_max=s_max, batch_rows=batch_rows)
    return pack_batches_to_groups(db, batches, gap=gap, width=width, s_max=s_max)


def pack_batches_to_groups(
    db: Database,
    batches: List[SegBatch],
    *,
    gap: int,
    width: int,
    s_max: int,
    place=None,
    row_multiple: int = 1,
) -> List[PackedSegGroup]:
    """Stack planned batches per quantised row count (full batches in one
    big stack, the partial tail in its own) so no batch pays full-block pad
    rows, and build the rebases, on the host; ``place`` maps each group as
    soon as it is packed (``bucketing.pack_database``'s).
    ``row_multiple`` (a power of two) forces every batch's rows to a
    multiple of it."""
    if not batches:
        return []
    sat = seg16_sat(gap, width, s_max)
    by_rows: dict = {}
    for b in batches:
        rows = _quantise_rows(b.rows, row_multiple)
        by_rows.setdefault(rows, []).append(_pad_batch_rows(b, rows))
    groups: List[PackedSegGroup] = []
    for rows, bs in sorted(by_rows.items()):
        stack = np.empty((len(bs), rows, width), dtype=np.int8)
        for c, b in enumerate(bs):
            pack_segments(db, b, out=stack[c])
        rebases = np.stack([build_rebase(b, gap, sat) for b in bs])
        ends = np.stack([b.ends for b in bs])
        group = PackedSegGroup(
            rows=rows,
            width=width,
            s_max=s_max,
            sat=sat,
            parts=((torch.from_numpy(stack), torch.from_numpy(rebases), torch.from_numpy(ends)),),
            batches=tuple(bs),
        )
        groups.append(group if place is None else place(group))
    return groups
