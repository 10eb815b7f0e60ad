"""The search pipeline: one query against a database packed on the device.

Counterpart of the main path of ``swtpu.models.search``: pack the database
once into wave buckets resident on the device, then per query build the
profile, launch the wavefront kernel once per bucket, and scatter the
lane-major flat scores back to file order.  Every score is exact int32.

The engine runs on the card unless the caller passes ``device="cpu"``; with
no CUDA device and no explicit CPU request it raises rather than fall back.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import SWConfig
from ..io.fasta import Database, Query
from ..matrices import get_matrix
from ..ops import wave_sw
from ..ops.profile import make_profile
from ..utils.bucketing import PackedDatabase, pack_database_wave, plan_wave_buckets
from ..utils.memory import resident_cell_budget
from ..utils.metrics import PhaseTimer, SearchMetrics


@dataclasses.dataclass
class SearchResult:
    """Scores in database file order + throughput accounting."""

    scores: np.ndarray  # (n,) int32, index = 0-based file-order id
    metrics: SearchMetrics

    def top_k(self, k: int) -> List[Tuple[int, int]]:
        """Top-k (id, score), score-descending, id-ascending tie-break."""
        n = self.scores.shape[0]
        k = min(k, n)
        if k == 0:
            return []
        # Take the full >= kth-score candidate set first so the id-ascending
        # tie-break is honoured at the boundary.
        kth = -np.partition(-self.scores, k - 1)[k - 1]
        cand = np.nonzero(self.scores >= kth)[0]
        order = np.lexsort((cand, -self.scores[cand]))[:k]
        return [(int(cand[i]), int(self.scores[cand[i]])) for i in order]


def resolve_device(device=None) -> torch.device:
    """The engine's device: CUDA unless the caller names another."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch version on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class SearchEngine:
    """Reusable scorer: pack a database once, search it with many queries."""

    def __init__(self, config: SWConfig = SWConfig(), device=None):
        self.config = config
        self.device = resolve_device(device)
        self.matrix = get_matrix(config.matrix)
        self._wave_chain = True if config.wave_chain is None else config.wave_chain
        self._resident: Optional[Tuple[Database, PackedDatabase]] = None

    def pack_to_device(self, db: Database, plan=None) -> PackedDatabase:
        """Pack the whole database into wave buckets on the engine's device
        (``plan``: a plan_wave_buckets result to reuse)."""
        return pack_database_wave(db, device=self.device, chain=self._wave_chain, plan=plan)

    def _resident_packed(self, db: Database) -> PackedDatabase:
        """The cached device-resident pack for ``db``, packing it on first use.

        The wave plan's int8 bytes must fit both ``device_resident_cells`` and
        a share of the device's free memory; a larger database needs the
        streaming search, which is not ported yet.
        """
        if self._resident is not None and self._resident[0] is db:
            return self._resident[1]
        plan = plan_wave_buckets(db, chain=self._wave_chain)
        need = sum((width + wave_sw.W) * bpad for width, _, _, bpad, _ in plan)
        budget = resident_cell_budget(self.config.device_resident_cells, self.device)
        if need > budget:
            raise RuntimeError(
                f"the packed database needs {need} resident bytes but the budget on "
                f"{self.device} is {budget} (SWConfig.device_resident_cells and free "
                "device memory); streaming search arrives with slice A8"
            )
        self._resident = (db, self.pack_to_device(db, plan))
        return self._resident[1]

    def _packed_step(self, profile: torch.Tensor, packed: PackedDatabase) -> torch.Tensor:
        """Score every bucket (one kernel launch each); flat scores on device."""
        gap = self.config.gap_penalty
        outs = [wave_sw.sw_wave(profile, g.stack, gap=gap, n_segs=g.n_segs) for g in packed.wave_groups]
        if not outs:
            return torch.zeros(0, dtype=torch.int32, device=self.device)
        return torch.cat(outs)

    def _reduce_flat(self, flat_all: np.ndarray, packed: PackedDatabase) -> np.ndarray:
        """Scatter lane-major flat scores back to file order (pads dropped;
        zero-length records, which no bucket holds, keep score 0)."""
        scores = np.zeros(packed.n_sequences, dtype=np.int32)
        off = 0
        for group in packed.wave_groups:
            vals = flat_all[off : off + group.rows]
            off += group.rows
            valid = group.ids >= 0
            scores[group.ids[valid]] = vals[valid]
        return scores

    def search_packed(self, query: Query, db: Database, packed: PackedDatabase) -> SearchResult:
        """Search a database already packed on the engine's device."""
        timer = PhaseTimer()
        t_start = time.perf_counter()
        with timer.phase("plan"):
            profile_np = make_profile(query.residues, self.matrix, pad_rows_to=wave_sw.W)
            profile = torch.from_numpy(profile_np).to(self.device)

        launches0 = wave_sw.sw_wave.launches
        on_cuda = self.device.type == "cuda"
        try:
            if on_cuda:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                flat = self._packed_step(profile, packed)
                end.record()
                end.synchronize()
                device_seconds = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                flat = self._packed_step(profile, packed)
                device_seconds = time.perf_counter() - t0
        except torch.cuda.OutOfMemoryError as e:
            raise RuntimeError(
                f"device out of memory while scoring a packed database of "
                f"{packed.total_cells} cells (query length {query.length}); lower "
                "SWConfig.device_resident_cells or search a smaller database"
            ) from e
        t_copy = time.perf_counter()
        flat_all = flat.cpu().numpy()
        transfer_seconds = time.perf_counter() - t_copy

        with timer.phase("reduce"):
            scores = self._reduce_flat(flat_all, packed)

        metrics = SearchMetrics(
            query_length=query.length,
            n_subjects=db.n,
            residue_sum=db.length_sum,
            padded8_sum=db.padded_length_sum(8),
            packed_cells=profile_np.shape[0] * packed.total_cells,
            wall_seconds=time.perf_counter() - t_start,
            device_seconds=max(device_seconds, 1e-12),
            phases=dict(timer.phases),
            transfer_seconds=transfer_seconds,
            kernel_launches=wave_sw.sw_wave.launches - launches0,
        )
        return SearchResult(scores=scores, metrics=metrics)

    def search(self, query: Query, db: Database) -> SearchResult:
        """Search ``db``, packing it onto the device on its first search."""
        return self.search_packed(query, db, self._resident_packed(db))


def search_file(query_path, db_path, config: SWConfig = SWConfig(), device=None) -> SearchResult:
    """One-shot convenience mirroring the reference CLI's flow."""
    from ..io.fasta import parse_database, parse_query

    engine = SearchEngine(config, device=device)
    return engine.search(parse_query(query_path), parse_database(db_path))
