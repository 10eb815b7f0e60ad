"""Bucket planning and packing (``swtpu.utils.bucketing``).

Two planners live here.  The wave planner sorts sequences onto a ladder of
widths, merges rungs into buckets by a modeled cost, and picks per bucket how
many subjects to chain end to end on a lane; its layout parameters are the
TPU-derived ones of swtpu_torch.ops.wave_sw, so buckets come out identical to
swtpu's.  A resident wave pack on the card is a gather on the device from the
database's flat residue buffer, uploaded once: per bucket the host builds
member offsets and lengths and the device computes each cell's source.  On
the host (streaming, and the CPU engine) the native transposed packer
(swtpu_torch.native) writes each bucket, one call a segment, as swtpu does.

The ladder planner (``plan_batches``) serves the row path: subjects sorted
longest first into row-major ``(rows, width)`` batches whose widths sit on a
quantised ladder, and same-shape batches stacked into ``(C, rows, width)``
groups.  The native row packer writes each batch on the host, in place into
its group's stack, and each stack is uploaded to the engine's device.  The
NumPy gather stays as the plain version (``pack_batch_plain``); the device
gather ``gather_wave_stack`` is also the native wave pack's plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import native
from ..io.fasta import Database
from ..ops import wave_sw
from ..ops.profile import PAD_SUBJECT


def wave_width_edges(max_len: int, ratio: float = 1.12) -> List[int]:
    """Width ladder: widths w whose padded length w + 32 divides by a chunk
    size of wave_sw.LC_LADDER.  32-granular to 992, 128-granular to 2016,
    then ~1.12-geometric on the 256 grid."""
    edges = []
    need = 64
    while True:
        if wave_sw.has_lc(need):
            edges.append(need - 32)
            if need - 32 >= max_len:
                return edges
        if need < 1024:
            need += 32
        elif need < 2048:
            need += 128
        else:
            need = -(-int(need * ratio) // 256) * 256


@dataclasses.dataclass(frozen=True)
class WaveGroup:
    """One wave bucket: transposed (width + 32, Bpad) int8 subjects.

    ``width`` is the total column count of a lane; with chaining
    (``n_segs`` > 1) each lane holds n_segs subjects in equal width/n_segs
    column segments.  ``ids`` is (Bpad * n_segs,) int64 lane-major,
    ids[lane * n_segs + s], matching the kernel's flat score order; -1 marks
    pad slots.  ``lc``/``bt`` are the TPU kernel's chunk and lane tile,
    kept for comparison with swtpu.

    ``parts`` holds the subjects, one part a device: ``(stack,)`` as packed
    here; an engine on a mesh places each part on its device (see
    ``SearchEngine._place``).
    """

    width: int
    lc: int
    bt: int
    parts: Tuple[torch.Tensor, ...]  # ((width + 32, Bpad) int8,) as packed
    ids: np.ndarray  # (Bpad * n_segs,) int64 lane-major, -1 = pad slot
    n_segs: int = 1

    @property
    def stack(self) -> torch.Tensor:
        """The (width + 32, Bpad) int8 stack of a bucket in one part."""
        (stack,) = self.parts
        return stack

    @property
    def lanes(self) -> int:
        return int(self.ids.shape[0]) // self.n_segs

    @property
    def seg_cols(self) -> int:
        return self.width // self.n_segs

    @property
    def rows(self) -> int:
        """Flat score-slot count: lanes * n_segs (kernel output length)."""
        return int(self.ids.shape[0])

    @property
    def cells(self) -> int:
        return self.lanes * (self.width + 32)


@dataclasses.dataclass(frozen=True)
class PackedGroup:
    """All of a plan's batches that share one (rows, width) shape, stacked.

    ``parts`` holds the (C, rows, width) int8 stack, one part a device:
    ``(stack,)`` as packed here; an engine on a mesh splits the rows into
    one contiguous shard a device (see ``SearchEngine._place_rows``).
    ``ids`` is (C, rows) int64 with -1 marking pad rows.
    """

    rows: int
    width: int
    parts: Tuple[torch.Tensor, ...]  # ((C, rows, width) int8,) as packed
    ids: np.ndarray  # (C, rows) int64, -1 = pad slot

    @property
    def stack(self) -> torch.Tensor:
        """The (C, rows, width) int8 stack of a group in one part."""
        (stack,) = self.parts
        return stack

    @property
    def chunks(self) -> int:
        return int(self.ids.shape[0])


@dataclasses.dataclass(frozen=True)
class PackedDatabase:
    """A database packed on one device: wave buckets (the wavefront path),
    or ladder groups plus segment-packed groups (swtpu_torch.utils.segpack)
    for the row path.  Flat scores run wave, then ladder, then segment
    groups."""

    groups: Tuple[PackedGroup, ...]
    n_sequences: int
    seg_groups: Tuple = ()  # Tuple[segpack.PackedSegGroup, ...]
    wave_groups: Tuple[WaveGroup, ...] = ()

    @property
    def total_cells(self) -> int:
        return (
            sum(g.chunks * g.rows * g.width for g in self.groups)
            + sum(g.cells for g in self.seg_groups)
            + sum(g.cells for g in self.wave_groups)
        )


# Chain factors the planner may consider.
CHAIN_OPTIONS = (1, 2, 3, 4, 6, 8)


def _chain_seg_cols(width: int, n_segs: int, w: int = 32) -> Optional[int]:
    """Smallest per-segment width >= ``width`` whose chained total
    n_segs*ws + w lands on the Lc ladder."""
    ws = width
    for _ in range(64):
        if wave_sw.has_lc(n_segs * ws + w):
            return ws
        ws += 8
    return None


# Chunk-size throughput factor of the TPU cost model (rate ~ BT_SPEED[bt] /
# (1 + _LC_COST / Lc)).
_LC_COST = 31.0


def _best_chain(nrows: int, width: int, lane_multiple: int, chain: bool):
    """(cost, n_segs, seg_cols, bt, bpad) minimising modeled padded time."""
    w = wave_sw.W
    best = None
    for S in CHAIN_OPTIONS if chain else (1,):
        if S > nrows:
            break
        ws = width if S == 1 else _chain_seg_cols(width, S)
        if ws is None:
            continue
        lanes = -(-nrows // S)
        bt, bpad = wave_sw.pick_lanes(lanes, lane_multiple)
        lc = wave_sw.pick_lc(S * ws)
        cost = bpad * (S * ws + w) * (1.0 + _LC_COST / lc) / wave_sw.BT_SPEED[bt]
        if best is None or cost < best[0]:
            best = (cost, S, ws, bt, bpad)
    return best


def plan_wave_buckets(
    db: Database, max_rows: int = 1 << 20, lane_multiple: int = 1, chain: bool = True
) -> List[Tuple[int, np.ndarray, int, int, int]]:
    """Plan wave buckets without materialising them.

    Returns [(total width, ids, bt, padded lane count, n_segs)]; member k of
    ``ids`` sits on lane k // n_segs, segment k % n_segs.  Zero-length
    records never enter a bucket (they score 0).  An O(r^2) DP over the
    occupied ladder rungs merges them into buckets of least modeled cost.
    """
    lengths = np.asarray(db.lengths, dtype=np.int64)
    if lengths.shape[0] == 0:
        return []
    pos = lengths > 0
    if not pos.any():
        return []
    edges = np.array(wave_width_edges(int(lengths.max())), dtype=np.int64)
    which = np.searchsorted(edges, lengths[pos])
    idx_pos = np.nonzero(pos)[0]
    occ = sorted(np.unique(which))
    counts = {e: int((which == e).sum()) for e in occ}
    r = len(occ)
    best = [0.0] * (r + 1)
    cut = [0] * (r + 1)
    for j in range(1, r + 1):
        best[j] = float("inf")
        nrows = 0
        for i in range(j - 1, -1, -1):
            nrows += counts[occ[i]]
            c = best[i] + _best_chain(nrows, int(edges[occ[j - 1]]), lane_multiple, chain)[0]
            if c < best[j]:
                best[j], cut[j] = c, i
    rung_list: List[Tuple[int, np.ndarray]] = []
    j = r
    while j > 0:
        i = cut[j]
        ids_merged = np.concatenate([idx_pos[which == e] for e in occ[i:j]])
        rung_list.append((int(edges[occ[j - 1]]), ids_merged))
        j = i
    buckets: List[Tuple[int, np.ndarray, int, int, int]] = []
    for width, ids_all in sorted(rung_list, key=lambda t: t[0]):
        _, n_segs, ws, _, _ = _best_chain(ids_all.shape[0], width, lane_multiple, chain)
        for s in range(0, ids_all.shape[0], max_rows * n_segs):
            ids = ids_all[s : s + max_rows * n_segs]
            bt, bpad = wave_sw.pick_lanes(-(-ids.shape[0] // n_segs), lane_multiple)
            buckets.append((ws * n_segs, ids, bt, bpad, n_segs))
    return buckets


def upload_residues(db: Database, device) -> torch.Tensor:
    """The database's flat residue buffer on ``device`` (one copy)."""
    return torch.from_numpy(np.ascontiguousarray(db.residues, dtype=np.int8)).to(device)


def gather_wave_stack(
    db: Database, width: int, ids: np.ndarray, bpad: int, n_segs: int = 1, residues: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """A wave bucket's (width + W, bpad) int8 transposed stack as one gather
    a segment from ``residues``, the flat buffer on any device (the CPU if
    None).  It is both the resident pack on the card (the card's only wave
    pack) and, on CPU residues, the plain version that the tests and
    ``chip_smoke.py`` hold the native host pack to.

    Member k packs into lane k // n_segs at column (k % n_segs) * seg_cols;
    columns past a member's length, the trailing W columns and pad lanes
    hold PAD_SUBJECT.
    """
    if residues is None:
        residues = upload_residues(db, "cpu")
    dev = residues.device
    l2 = width + wave_sw.W
    ws = width // n_segs
    slots = bpad * n_segs
    off = np.zeros(slots, dtype=np.int64)
    length = np.zeros(slots, dtype=np.int64)  # 0 on pad slots: all PAD
    off[: ids.shape[0]] = db.offsets[ids]
    length[: ids.shape[0]] = db.offsets[ids + 1] - db.offsets[ids]
    off_d = torch.from_numpy(off.reshape(bpad, n_segs)).to(dev)
    len_d = torch.from_numpy(length.reshape(bpad, n_segs)).to(dev)
    pos = torch.arange(ws, dtype=torch.int64, device=dev)[:, None]  # (ws, 1)
    top = max(residues.shape[0] - 1, 0)
    stack = torch.full((l2, bpad), PAD_SUBJECT, dtype=torch.int8, device=dev)
    for s in range(n_segs):  # one (ws, bpad) gather per segment bounds the index tensors
        src = (off_d[:, s][None, :] + pos).clamp_(max=top)
        valid = pos < len_d[:, s][None, :]
        if residues.shape[0]:
            stack[s * ws : (s + 1) * ws] = torch.where(valid, residues[src], PAD_SUBJECT)
    return stack


def pack_wave_group(
    db: Database,
    width: int,
    ids: np.ndarray,
    bt: int,
    bpad: int,
    n_segs: int = 1,
    residues: Optional[torch.Tensor] = None,
) -> WaveGroup:
    """Materialise one wave bucket: on the host when ``residues`` is None or
    on the CPU, with the native transposed packer (one call a segment, each
    writing its (seg_cols, bpad) rows of the stack in place); else gathered
    on ``residues``' device (``gather_wave_stack``).  The layout is
    ``gather_wave_stack``'s.
    """
    if residues is None or residues.device.type == "cpu":
        ws = width // n_segs
        stack = np.empty((width + wave_sw.W, bpad), dtype=np.int8)
        for s in range(n_segs):
            native.pack_bucket_T_native(
                db.residues, db.offsets, ids[s::n_segs], ws, bpad, PAD_SUBJECT, out=stack[s * ws : (s + 1) * ws]
            )
        stack[n_segs * ws :] = PAD_SUBJECT
        stack = torch.from_numpy(stack)
    else:
        stack = gather_wave_stack(db, width, ids, bpad, n_segs, residues)
    full_ids = np.full(bpad * n_segs, -1, dtype=np.int64)
    full_ids[: ids.shape[0]] = ids  # member k -> (lane k // S, seg k % S) == flat k
    return WaveGroup(width=width, lc=wave_sw.pick_lc(width), bt=bt, parts=(stack,), ids=full_ids, n_segs=n_segs)


def pack_database_wave(
    db: Database, device="cpu", max_rows: int = 1 << 20, chain: bool = True, plan=None
) -> PackedDatabase:
    """Pack a whole database into wave buckets resident on ``device``
    (``plan``: a plan_wave_buckets result to reuse): gathered on a device
    from one upload of the residues, packed natively on the CPU."""
    if plan is None:
        plan = plan_wave_buckets(db, max_rows, chain=chain)
    residues = None if torch.device(device).type == "cpu" else upload_residues(db, device)
    groups = tuple(
        pack_wave_group(db, width, ids, bt, bpad, n_segs, residues=residues)
        for width, ids, bt, bpad, n_segs in plan
    )
    return PackedDatabase(groups=(), n_sequences=db.n, wave_groups=groups)


def iter_wave_groups(
    db: Database, device="cpu", max_rows: int = 1 << 20, chain: bool = True, lane_multiple: int = 1
) -> Iterator[WaveGroup]:
    """Yield wave buckets one at a time (bounded device memory per bucket;
    on the CPU, the default, each packed natively on the host); a mesh's
    lane-sharded streaming plans with ``lane_multiple`` = its size."""
    residues = None if torch.device(device).type == "cpu" else upload_residues(db, device)
    for width, ids, bt, bpad, n_segs in plan_wave_buckets(db, max_rows, lane_multiple=lane_multiple, chain=chain):
        yield pack_wave_group(db, width, ids, bt, bpad, n_segs, residues=residues)


# --- the ladder planner of the row path -------------------------------------------


def width_edges(max_width: int, quantum: int = 128, ratio: float = 1.25) -> List[int]:
    """Quantised width ladder covering [quantum, >=max_width]."""
    edges = [quantum]
    while edges[-1] < max_width:
        nxt = max(edges[-1] + quantum, int(-(-edges[-1] * ratio // quantum) * quantum))
        edges.append(nxt)
    return edges


def _pow2_floor(x: int) -> int:
    return 1 << (max(x, 1).bit_length() - 1)


def _pow2_ceil(x: int) -> int:
    return 1 << (max(x, 1) - 1).bit_length() if x > 1 else 1


@dataclasses.dataclass(frozen=True)
class Batch:
    """One static-shaped unit of row-path work."""

    ids: np.ndarray  # (n_valid,) database sequence ids (file order)
    rows: int  # batch row count
    width: int  # padded subject length

    @property
    def n_valid(self) -> int:
        return int(self.ids.shape[0])

    @property
    def cells(self) -> int:
        return self.rows * self.width


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """A full packing plan for one database."""

    batches: Tuple[Batch, ...]
    n_sequences: int
    shapes: Tuple[Tuple[int, int], ...]  # distinct (rows, width)

    @property
    def total_cells(self) -> int:
        return sum(b.cells for b in self.batches)


def plan_batches(
    lengths: np.ndarray,
    batch_rows: int = 8192,
    length_quantum: int = 128,
    max_batch_cells: int = 1 << 23,
    min_rows: int = 8,
    width_ratio: float = 1.25,
    min_width: int = 256,
    min_bucket_rows: int = 256,
) -> BatchPlan:
    """Plan static-shaped batches for a database given its sequence lengths.

    Sequences sort longest first (stable, so equal lengths keep file order)
    and pad to their own ladder edge; a width's run of sequences is cut into
    batches of at most ``batch_rows`` rows, fewer for wide widths so rows *
    width stays under ``max_batch_cells``.  ``min_width`` floors the ladder;
    ``min_bucket_rows`` merges sparse narrower widths into a wider run
    within a whole-plan padding budget.  Partial tail batches declare a
    quantised row count (powers of two below 256, 128-steps above), a
    multiple of ``min_rows``.
    """
    n = int(lengths.shape[0])
    if n == 0:
        return BatchPlan(batches=(), n_sequences=0, shapes=())
    lengths = np.asarray(lengths, dtype=np.int64)
    order = np.argsort(-lengths, kind="stable").astype(np.int32)
    edges = np.array(
        [e for e in width_edges(int(lengths.max()), quantum=length_quantum, ratio=width_ratio) if e >= min_width]
        or [min_width],
        dtype=np.int64,
    )
    if edges[0] > min_width:
        edges = np.concatenate([[min_width], edges])
    sorted_w = edges[np.searchsorted(edges, np.maximum(lengths[order], 1))]
    batches: List[Batch] = []
    pos = 0
    # Whole-plan budget for merge padding: ~256k extra cells or 1/16 of the
    # true work, whichever is smaller.
    absorb_budget = min(1 << 18, int(lengths.sum()) >> 4)
    while pos < n:
        width = int(sorted_w[pos])
        end = pos + int(np.searchsorted(-sorted_w[pos:], -width, side="right"))
        while end < n and (end - pos) < min_bucket_rows:
            w2 = int(sorted_w[end])
            nxt = end + int(np.searchsorted(-sorted_w[end:], -w2, side="right"))
            extra = (nxt - end) * (width - w2)
            if extra > absorb_budget:
                break
            absorb_budget -= extra
            end = nxt
        rows = min(batch_rows, max(min_rows, _pow2_floor(max_batch_cells // width)))
        rows = max(min_rows, rows - rows % min_rows)
        while pos < end:
            take = min(rows, end - pos)
            decl = -(-take // 128) * 128 if take > 256 else _pow2_ceil(take)
            decl = -(-max(min_rows, decl) // min_rows) * min_rows
            decl = min(rows, decl)
            batches.append(Batch(ids=order[pos : pos + take].copy(), rows=decl, width=width))
            pos += take
    shapes = tuple(sorted({(b.rows, b.width) for b in batches}))
    return BatchPlan(batches=tuple(batches), n_sequences=n, shapes=shapes)


def pack_batch(db: Database, batch: Batch, out: Optional[np.ndarray] = None) -> np.ndarray:
    """Materialise a (rows, width) int8 subject array for a batch (pads
    PAD_SUBJECT) with the native row packer, into ``out`` if given."""
    return native.pack_batch_native(db.residues, db.offsets, batch.ids, batch.rows, batch.width, PAD_SUBJECT, out=out)


def pack_batch_plain(db: Database, batch: Batch) -> np.ndarray:
    """NumPy version of :func:`pack_batch`: one vectorised gather from the
    flat residue buffer."""
    W, R = batch.width, batch.rows
    ids = batch.ids.astype(np.int64)
    offs = db.offsets[ids][:, None]  # (V, 1)
    lens = (db.offsets[ids + 1] - db.offsets[ids])[:, None]  # (V, 1)
    cols = np.arange(W, dtype=np.int64)[None, :]  # (1, W)
    valid = cols < lens  # (V, W)
    src = np.minimum(offs + cols, max(db.residues.shape[0] - 1, 0))
    out = np.full((R, W), PAD_SUBJECT, dtype=np.int8)
    if db.residues.shape[0]:
        out[: ids.shape[0]] = np.where(valid, db.residues[src], PAD_SUBJECT)
    return out


def iter_packed(db: Database, plan: BatchPlan) -> Iterator[Tuple[Batch, np.ndarray]]:
    """Yield (batch, packed subjects) pairs in plan order."""
    for b in plan.batches:
        yield b, pack_batch(db, b)


def pack_database(db: Database, plan: BatchPlan, place=None) -> PackedDatabase:
    """Materialise the full plan as stacked same-shape groups, each batch
    packed on the host in place into its group's stack.  ``place`` (a
    function of a host group, such as an engine's placement on its devices)
    maps each group as soon as it is packed, so that the host holds one
    group's stack at a time; None keeps the groups on the host."""
    by_shape: dict = {}
    for batch in plan.batches:
        by_shape.setdefault((batch.rows, batch.width), []).append(batch)
    groups: List[PackedGroup] = []
    for (rows, width), batches in sorted(by_shape.items()):
        stack = np.empty((len(batches), rows, width), dtype=np.int8)
        ids = np.full((len(batches), rows), -1, dtype=np.int64)
        for c, b in enumerate(batches):
            pack_batch(db, b, out=stack[c])
            ids[c, : b.n_valid] = b.ids
        group = PackedGroup(rows=rows, width=width, parts=(torch.from_numpy(stack),), ids=ids)
        groups.append(group if place is None else place(group))
    return PackedDatabase(groups=tuple(groups), n_sequences=plan.n_sequences)


def scatter_scores(plan: BatchPlan, per_batch_scores: Sequence[np.ndarray]) -> np.ndarray:
    """Zip per-batch score vectors back into file-order (n,) scores."""
    out = np.zeros(plan.n_sequences, dtype=np.int32)
    for batch, scores in zip(plan.batches, per_batch_scores):
        out[batch.ids] = np.asarray(scores)[: batch.n_valid]
    return out
