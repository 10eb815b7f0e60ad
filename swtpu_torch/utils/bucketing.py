"""Wave-bucket planning and packing (the wave half of ``swtpu.utils.bucketing``).

The planner sorts sequences onto a ladder of widths, merges rungs into
buckets by a modeled cost, and picks per bucket how many subjects to chain
end to end on a lane.  Its layout parameters are the TPU-derived ones of
swtpu_torch.ops.wave_sw, so buckets come out identical to swtpu's.

Packing is a gather on the target device from the database's flat residue
buffer, uploaded once: per bucket the host builds member offsets and lengths
and the device computes each cell's source.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

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
    """

    width: int
    lc: int
    bt: int
    stack: torch.Tensor  # (width + 32, Bpad) int8
    ids: np.ndarray  # (Bpad * n_segs,) int64 lane-major, -1 = pad slot
    n_segs: int = 1

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
class PackedDatabase:
    """A database packed into wave buckets on one device."""

    wave_groups: Tuple[WaveGroup, ...]
    n_sequences: int

    @property
    def total_cells(self) -> int:
        return sum(g.cells for g in self.wave_groups)


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


def pack_wave_group(
    db: Database,
    width: int,
    ids: np.ndarray,
    bt: int,
    bpad: int,
    n_segs: int = 1,
    residues: Optional[torch.Tensor] = None,
) -> WaveGroup:
    """Materialise one wave bucket on ``residues``' device (CPU if None).

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
    full_ids = np.full(slots, -1, dtype=np.int64)
    full_ids[: ids.shape[0]] = ids  # member k -> (lane k // S, seg k % S) == flat k
    return WaveGroup(width=width, lc=wave_sw.pick_lc(width), bt=bt, stack=stack, ids=full_ids, n_segs=n_segs)


def pack_database_wave(
    db: Database, device="cpu", max_rows: int = 1 << 20, chain: bool = True, plan=None
) -> PackedDatabase:
    """Pack a whole database into wave buckets resident on ``device``
    (``plan``: a plan_wave_buckets result to reuse)."""
    if plan is None:
        plan = plan_wave_buckets(db, max_rows, chain=chain)
    residues = upload_residues(db, device)
    groups = tuple(
        pack_wave_group(db, width, ids, bt, bpad, n_segs, residues=residues)
        for width, ids, bt, bpad, n_segs in plan
    )
    return PackedDatabase(wave_groups=groups, n_sequences=db.n)


def iter_wave_groups(db: Database, device="cpu", max_rows: int = 1 << 20, chain: bool = True) -> Iterator[WaveGroup]:
    """Yield wave buckets one at a time (bounded device memory per bucket)."""
    residues = upload_residues(db, device)
    for width, ids, bt, bpad, n_segs in plan_wave_buckets(db, max_rows, chain=chain):
        yield pack_wave_group(db, width, ids, bt, bpad, n_segs, residues=residues)
