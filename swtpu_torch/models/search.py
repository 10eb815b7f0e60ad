"""The search pipeline: queries against a database packed on the device.

Counterpart of ``swtpu.models.search`` on two paths.  The wavefront path
(the default) packs the database once into wave buckets resident on the
device, then per query builds the profile, launches the wavefront kernel
once per bucket, and scatters the lane-major flat scores back to file order;
every score is exact int32, under linear gaps or, with ``SWConfig.gap_open``,
affine (Gotoh) ones on every path below.  The row path (``use_wave=False``,
or ``score_dtype="int16"``) packs ladder batches and segment-packed rows and
scores them with swtpu's row-parallel family (``ops.row_sw``; with
``use_pallas``, the CUDA kernels K2 and K3 of ``ops.bucket_sw``), rescoring
saturated rows exactly, so its scores are the same exact int32.

Serving paths beside the single search:

* ``search_many`` folds queries of equal padded length into one launch per
  bucket (the kernel's multi-query mode) and syncs once per such piece; on
  the row path, whose kernels have no query axis, it is ``search_queued``;
* ``search_queued`` enqueues every query's launches on the current stream
  and syncs once for the whole batch;
* a database over the residency budget, or with ``device_resident=False``,
  streams bucket by bucket, every query scored against each upload;
* with ``SWConfig.top_k`` the top-K reduces on the device and only candidate
  rows transfer; with ``SWConfig.evalue`` the null distribution's moments
  reduce there too, in int64;
* with ``SWConfig.prefilter`` ``search`` and ``search_many`` run the k-mer
  prefilter through one body (a search is a batch of one): one int8 coarse
  launch (``ops.int8_mma``) ranks the batch against the database's
  signature index (built on the card once a database), and each query's
  top candidates are gathered on the device and scored exactly;
* ``warmup`` runs each shape a batch needs once, ahead of it;
* with ``SWConfig.mesh_shape = (n,)`` the engine runs on a mesh of n
  devices (swtpu_torch.parallel): every wave bucket's lanes shard
  contiguously over the devices, each shard's launches run on its own
  device (``_score_shards``), and the results merge on the primary: flat
  scores concatenated in mesh order, or each shard's top-K keys and null
  moments reduced to one top-K and one moment vector; with
  ``SWConfig.query_shard`` the query's bands shard instead, through the
  systolic pipeline of ``parallel.query_shard``.  On the row path every
  ladder and segment group's rows shard the same way (``_row_shards``).
  As in swtpu, what a mesh does not shard runs on the primary: a streamed
  row ladder (the row path's, and a database that cannot be resident under
  ``query_shard``), and the prefilter's coarse pass and gathered exact
  phase; the prefilter's exhaustive fallback searches on the mesh.

The engine runs on the card unless the caller passes ``device="cpu"``; with
no CUDA device and no explicit CPU request it raises rather than fall back.
A mesh takes the first n cards unless the caller names its devices (a
sequence, in which a device may repeat, or ``"cpu"`` for n CPU shards).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import SWConfig
from ..io.fasta import Database, Query
from ..matrices import get_matrix
from ..ops import bucket_sw, int8_mma, long_sw, row_sw, wave_sw
from ..ops import prefilter as pf
from ..ops.profile import PAD_SUBJECT, make_profile
from ..parallel import query_shard
from ..parallel.mesh import Mesh, lane_bounds, make_mesh, on_device, replicate, replicate_tiles, shard_lanes
from ..stats import DEFAULT_TRIM
from ..utils import segpack
from ..utils.bucketing import (
    BatchPlan,
    PackedDatabase,
    iter_packed,
    iter_wave_groups,
    pack_database,
    pack_database_wave,
    plan_batches,
    plan_wave_buckets,
    scatter_scores,
)
from ..utils.memory import reraise_oom, resident_cell_budget, scratch_budget_bytes
from ..utils.metrics import PhaseTimer, SearchMetrics
from ..utils.profiling import span


@dataclasses.dataclass
class SearchResult:
    """Scores in database file order + throughput accounting.

    When the engine ran with ``config.top_k`` on a resident database,
    ``scores`` is None (the full array never leaves the device) and ``hits``
    holds the device-computed top-K.
    """

    scores: Optional[np.ndarray]  # (n,) int32, index = 0-based file-order id
    metrics: SearchMetrics
    hits: Optional[List[Tuple[int, int]]] = None  # engine-level top-K
    # Null-distribution sufficient statistics (swtpu_torch.stats.NullStats)
    # when the engine ran with config.evalue: device-reduced on top-K paths,
    # host-reduced on full-score paths.
    null_stats: Optional[object] = None

    def top_k(self, k: int) -> List[Tuple[int, int]]:
        """Top-k (id, score), score-descending, id-ascending tie-break."""
        if self.scores is None:
            if self.hits is None:
                raise ValueError(f"top_k({k}) unavailable: no scores and no hits")
            if k > len(self.hits):
                # Fine when the database has fewer than k sequences (hits
                # then covers every sequence); only a smaller engine top_k
                # is an error.
                if len(self.hits) >= self.metrics.n_subjects:
                    return list(self.hits)
                raise ValueError(
                    f"top_k({k}) unavailable: engine ran with top_k={len(self.hits)} "
                    "and no full score array"
                )
            return self.hits[:k]
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

    def top_k_stats(self, k: int, trim: float = 0.02):
        """Top-k hits with empirical significance (E-value, bit score).

        The Gumbel null is fitted to this query's score distribution
        (swtpu_torch.stats), from the engine-collected ``null_stats`` when
        present, else from the full score array.  Returns
        ``List[swtpu_torch.stats.HitStat]``.  The fit is the span
        ``swtpu.evalues``.
        """
        with span("swtpu.evalues"):
            from ..stats import hit_significance, null_stats_from_scores

            hits = self.top_k(k)
            if self.null_stats is not None:
                ns = self.null_stats
                needed = int(np.ceil(trim * ns.count)) if trim > 0 else 0
                if needed > np.asarray(ns.top_vals).size:
                    # A larger trim than the engine collected for cannot be
                    # honoured: fail rather than fit at a smaller effective trim.
                    raise ValueError(
                        f"trim={trim} needs the top {needed} scores but the "
                        f"engine collected {np.asarray(ns.top_vals).size}; "
                        "use the engine-default trim, or fit from the full "
                        "score array (swtpu_torch.stats.null_stats_from_scores)"
                    )
                return hit_significance(ns, hits, trim=trim)
            if self.scores is None:
                raise ValueError(
                    "top_k_stats needs the full score array (or engine-collected "
                    "null statistics: run with SWConfig.evalue=True) to fit the "
                    "null distribution"
                )
            m = self.metrics
            null = null_stats_from_scores(
                self.scores,
                n_subjects=int(np.asarray(self.scores).size),
                query_length=m.query_length,
                mean_subject_length=m.residue_sum / max(m.n_subjects, 1),
                trim=trim,
            )
            return hit_significance(null, hits, trim=trim)


def _null_moments(flat: torch.Tensor, bins: torch.Tensor, nb: int) -> torch.Tensor:
    """Device reduction of the null distribution's sufficient statistics.

    One int64 vector ``[count, sum, sumsq, bin_counts.., bin_sums..,
    bin_sumsqs..]`` of length 3 + 3*nb per query (``flat`` (total,) or (Q,
    total)).  Zero scores (pad slots, true zeros) count nowhere; pad slots
    carry bin id ``nb``, an overflow bin that is dropped.  Integer sums are
    exact and no float matmul (or its TF32 mode) is involved.
    """
    f = flat.to(torch.int64)
    nz = (f > 0).to(torch.int64)
    lead = f.shape[:-1]
    idx = bins.expand(*lead, -1)

    def per_bin(v):
        acc = torch.zeros(*lead, nb + 1, dtype=torch.int64, device=f.device)
        return acc.scatter_add_(-1, idx, v)[..., :nb]

    sq = f * f
    head = torch.stack([nz.sum(-1), f.sum(-1), sq.sum(-1)], dim=-1)
    return torch.cat([head, per_bin(nz), per_bin(f), per_bin(sq)], dim=-1)


# A device top-K key packs a score and its file id into one int64, score in
# the high 32 bits and _ID_MASK - id in the low 32 (0 on pad slots), so one
# descending torch.topk orders by (score desc, id asc) with no ties at all.
_ID_MASK = (1 << 32) - 1

# The prefilter's exact phase scores candidates of at most this many
# residues on the wavefront kernel, in one bucket of this width (swtpu's
# ladder's fine/coarse boundary), and the longer ones on long_sw's kernel.
PREFILTER_WAVE_WIDTH = 992


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

    def __init__(self, config: SWConfig = SWConfig(), device=None, *, top_trim: float = DEFAULT_TRIM):
        """``top_trim``: the fraction of a query's scores whose top values
        the null statistics keep, the fit's default trim; a fleet process
        keeps more, to ship its share of the global trim whatever the skew
        (``parallel.distributed``)."""
        self.config = config
        self._top_trim = top_trim
        # A mesh of config.n_devices > 1 devices, or None for one device;
        # self.device is the mesh's primary, where results merge.
        self.mesh: Optional[Mesh] = self._resolve_mesh(device)
        if self.mesh is None and isinstance(device, (list, tuple, Mesh)):  # a list of one device
            device = (device.devices if isinstance(device, Mesh) else device)[0]
        self.device = self.mesh.primary if self.mesh is not None else resolve_device(device)
        self._devices = self.mesh.distinct if self.mesh is not None else (self.device,)
        self._qshard = config.query_shard and self.mesh is not None
        # The devices a wave bucket's lanes (or a row group's rows) split
        # over, one part each: the mesh when it is lane-sharded, else the one
        # device.
        self._lanes = self.mesh if self.mesh is not None and not self._qshard else Mesh((self.device,))
        self.matrix = get_matrix(config.matrix)
        # Subject chaining: on unless asked off, and off under query_shard
        # (one subject a lane: the pipeline's carry chain is a lane's).
        self._wave_chain = (not config.query_shard) if config.wave_chain is None else config.wave_chain
        # The kernel's gap arguments, at every launch (swtpu's wave_local): a
        # config with gap_open runs the affine mode, even when open == extend.
        self._affine = config.gap_open is not None
        self._gaps = (
            dict(gap_open=config.gap_open, gap_extend=config.gap_extend) if self._affine else dict(gap=config.gap_penalty)
        )
        self._wave_enabled = self._resolve_wave()
        if self._affine and not self._wave_enabled:
            raise ValueError(
                "affine gaps (gap_open/gap_extend) run on the wavefront kernel only: "
                "leave use_wave at None or True and score_dtype at 'int32'"
            )
        # int8 score staging of the int16 scorers is exact iff every folded
        # score fits int8.
        self._stage_int8 = int(self.matrix.max()) + config.gap_penalty <= 127
        # The row kernels K2/K3 on the card, the PyTorch scorers on the CPU.
        self._use_pallas = self._on_cuda if config.use_pallas is None else config.use_pallas
        self._kernel = self._select_kernel()
        self._resident: Optional[Tuple[Database, PackedDatabase]] = None
        self._topk_cache = None
        self.rescored_rows = 0  # saturated rows rescored exactly, since last set to 0
        # K1 (lane, segment) entries whose int16 best may have wrapped and that
        # were rescored in int32 on the card, since last set to 0: the devices'
        # running totals (wave_sw.rescore_counter) copied to the host before a
        # path's launches and again before the sync it makes anyway.
        self.rescored_lanes = 0
        # The prefilter's per-database state (signatures and residues on the
        # device, the E-value sample), the long route's matrix table and the
        # exact engine.
        self._sig_cache = None
        self._long_table_cache = None
        self._evalue_sample_cache = None
        self._population_bins_cache = None
        self._exact: Optional["SearchEngine"] = None

    # --- device plumbing -------------------------------------------------------

    def _resolve_mesh(self, device) -> Optional[Mesh]:
        """The mesh of ``config.mesh_shape``: None for one device; for n > 1,
        the first n cards (``device`` None or ``"cuda"``), n CPU shards
        (``"cpu"``), or the n devices of a sequence or Mesh as given."""
        n, axis = self.config.n_devices, self.config.mesh_axes[0]
        if isinstance(device, Mesh):
            device = device.devices
        if isinstance(device, (list, tuple)):
            if len(device) != n:
                raise ValueError(f"mesh_shape={self.config.mesh_shape} needs {n} devices, {len(device)} given")
            if n == 1:
                return None
            mesh = make_mesh(n, axis, devices=device)
            if len({d.type for d in mesh.devices}) > 1:
                raise ValueError(f"a mesh's devices are all CUDA or all CPU, not {mesh.devices}")
            return mesh
        if n == 1:
            return None
        if device is None or torch.device(device) == torch.device("cuda"):
            if not torch.cuda.is_available():
                raise RuntimeError(
                    f"no CUDA device is available for mesh_shape={self.config.mesh_shape}; pass "
                    "device='cpu' to shard over the CPU"
                )
            return make_mesh(n, axis)
        if torch.device(device).type == "cpu":
            return make_mesh(n, axis, devices=("cpu",) * n)
        raise ValueError(
            f"mesh_shape={self.config.mesh_shape} takes device=None or 'cuda' (the first {n} cards), "
            f"'cpu', or a sequence of {n} devices, not {device!r}"
        )

    @property
    def _on_cuda(self) -> bool:
        return self.device.type == "cuda"

    def _replicas(self, t: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """``t`` (on the primary) on the device of every lane shard."""
        return replicate(t, self._lanes)

    def _place(self, group):
        """A bucket packed on the primary, on the engine's devices: its lane
        shards, shard k on device k (one part on one device), or under
        query_shard a tile-major replica on every mesh device."""
        if self._qshard:
            return dataclasses.replace(group, parts=replicate_tiles(group.stack, group.bt, self.mesh))
        return dataclasses.replace(group, parts=shard_lanes(group.stack, self._lanes))

    def _place_rows(self, group):
        """A ladder or segment group packed on the host, as row shards of
        every (C, rows, ...) array, shard k on device k: swtpu's ``P(None,
        axis)`` on its stacks, and for a segment group also on its rebases
        and ends, so that each device keeps its own rows' segment metadata."""
        if isinstance(group, segpack.PackedSegGroup):
            stack, rebases, ends = group.parts[0]
            parts = tuple(zip(*(shard_lanes(t, self._lanes) for t in (stack, rebases, ends))))
        else:
            parts = shard_lanes(group.stack, self._lanes)
        return dataclasses.replace(group, parts=parts)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device, without a host sync on the
        card (pinned, asynchronous on the current stream)."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if not self._on_cuda:
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _to_host(self, t: torch.Tensor) -> torch.Tensor:
        """Start a device -> host copy into pinned memory; valid after _sync()."""
        if t.device.type != "cuda":
            return t
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return host.copy_(t, non_blocking=True)

    def _rescore_fetch(self):
        """Start copying each lane device's running total of K1 entries
        rescored in int32 to the host, on the current streams; valid after
        the path's sync (``_rescored``)."""
        if not self._on_cuda:
            return None
        return [self._to_host(wave_sw.rescore_counter(dev)) for dev in self._lanes.distinct]

    def _rescored(self, before, after) -> int:
        """Entries rescored between two ``_rescore_fetch`` copies, read after
        the sync; adds them to ``rescored_lanes``."""
        if before is None:
            return 0
        n = sum(int(b[0]) for b in after) - sum(int(a[0]) for a in before)
        self.rescored_lanes += n
        return n

    def _sync(self) -> None:
        """Wait for every device's current stream (one host thread enqueued
        on all of them; no shard syncs on its own)."""
        if self._on_cuda:
            for dev in self._devices:
                torch.cuda.current_stream(dev).synchronize()

    def _mark(self):
        """A point on the current streams: a CUDA event on each of the
        engine's devices, the host clock on the CPU (where the work before it
        has already run)."""
        if not self._on_cuda:
            return time.perf_counter()
        marks = []
        for dev in self._devices:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(dev))
            marks.append(ev)
        return tuple(marks)

    @staticmethod
    def _wait(mark) -> None:
        """Wait until a mark's events have completed."""
        if not isinstance(mark, float):
            for ev in mark:
                ev.synchronize()

    @staticmethod
    def _seconds(start, end) -> float:
        """Seconds between two marks, the longest device's span (events
        compare only on one device); a CUDA end mark must have completed."""
        if isinstance(start, float):
            return end - start
        return max(a.elapsed_time(b) for a, b in zip(start, end)) / 1e3

    @contextlib.contextmanager
    def _oom_hint(self, what: str):
        """Re-raise a device memory exhaustion inside as an actionable error
        (``utils.memory.reraise_oom``); any other error passes unchanged."""
        try:
            yield
        except Exception as e:
            reraise_oom(e, what)

    @staticmethod
    def _metrics(q: Query, db: Database, packed_cells: int, wall: float, device_seconds: float, **kw) -> SearchMetrics:
        return SearchMetrics(
            query_length=q.length,
            n_subjects=db.n,
            residue_sum=db.length_sum,
            padded8_sum=db.padded_length_sum(8),
            packed_cells=packed_cells,
            wall_seconds=wall,
            device_seconds=max(device_seconds, 1e-12),
            **kw,
        )

    # --- planning and residency -------------------------------------------------

    def _query_pad(self, qlen: int, quantum: int, serving: bool = False) -> int:
        """Row padding target for a query: exact quantum, or the serving
        ladder (32-step to 256, then ~1.25x on the 32 grid).

        The ladder engages when ``config.query_ladder`` is True, or in auto
        mode (None) on batched serving paths (``serving=True``), where it
        merges queries into shared launches.
        """
        qpad = -(-max(qlen, 1) // quantum) * quantum
        ladder = self.config.query_ladder
        if ladder is None:
            ladder = serving
        if not ladder:
            return qpad
        step = quantum
        while step < qpad:
            step = step + 32 if step < 256 else -(-int(step * 1.25) // 32) * 32
        return -(-step // quantum) * quantum

    def _resolve_wave(self) -> bool:
        """Whether the wavefront path is active: never in int16 parity mode
        (whose saturating semantics the exact wavefront kernel does not
        reproduce), else ``use_wave``, and on by default on either device.
        swtpu's default is on with a TPU and off on the CPU; the scores are
        the same either way."""
        cfg = self.config
        if cfg.score_dtype == "int16":
            return False
        return True if cfg.use_wave is None else cfg.use_wave

    def _select_kernel(self):
        """The streamed row path's scorer: kernel(profile, bucket) ->
        (scores, rescore threshold | None).  Rows scoring >= the threshold
        are saturated lower bounds, rescored exactly; None means exact."""
        cfg = self.config
        gap, strip = cfg.gap_penalty, cfg.query_strip
        if cfg.score_dtype == "int16":
            # Narrow-type saturating mode: int16 DP row, saturating at 32767.
            return lambda prof, subj: (row_sw.sw_score_bucket_sat16(prof, subj, gap=gap, strip=strip), row_sw.SAT16_MAX)
        if self._use_pallas:
            return lambda prof, subj: (bucket_sw.sw_score_bucket(prof, subj, gap=gap, strip=strip), None)

        def kernel(prof, subj):
            sat = self._fast16_sat(subj.shape[1])
            if sat is not None:
                scores = row_sw.sw_score_bucket_fast16(prof, subj, gap=gap, strip=strip, sat=sat, stage_int8=self._stage_int8)
                return scores, sat
            return row_sw.sw_score_bucket(prof, subj, gap=gap, strip=strip), None

        return kernel

    def _fast16_sat(self, width: int) -> Optional[int]:
        """fast16's ceiling for a ladder batch of this width, or None where
        the row path scores it exactly instead: int16 parity mode,
        ``fast_saturating`` off, or a ceiling under 4096 (wide batches, large
        gaps).  Scores below the ceiling are exact; the rest are rescored."""
        cfg = self.config
        sat = row_sw.fast16_sat(cfg.gap_penalty, width)
        return sat if cfg.score_dtype != "int16" and cfg.fast_saturating and sat >= 4096 else None

    @staticmethod
    def _launches() -> int:
        """CUDA kernel launches of every wrapper of a search so far (K1 and
        its rescore, K2, K3, the coarse counts, the signature index and the
        prefilter's long route)."""
        return (
            wave_sw.sw_wave.launches
            + getattr(wave_sw.sw_wave, "rescore_launches", 0)  # a stand-in for sw_wave may not count them
            + bucket_sw.sw_score_bucket_fused.launches
            + bucket_sw.sw_score_bucket.launches
            + int8_mma.coarse_counts.launches
            + pf.database_signatures_cuda.launches
            + long_sw.sw_long.launches
        )

    @property
    def _row_multiple(self) -> int:
        """Ladder and segment batch rows divide both swtpu's 8-row sublane
        tile and the mesh size (swtpu's ``_row_multiple``), so that every
        group splits into equal row shards."""
        n = self.config.n_devices
        return 8 * n // math.gcd(8, n)

    def plan(self, db: Database) -> BatchPlan:
        """The row path's ladder plan of ``db``."""
        return self._ladder_plan(db.lengths)

    def _ladder_plan(self, lengths: np.ndarray, min_width: int = 256) -> BatchPlan:
        cfg = self.config
        return plan_batches(
            lengths,
            batch_rows=cfg.batch_rows,
            length_quantum=cfg.length_quantum,
            max_batch_cells=min(cfg.chunk_budget_residues, cfg.max_batch_cells),
            min_width=min_width,
            min_rows=self._row_multiple,
        )

    def pack_to_device(self, db: Database, plan=None) -> PackedDatabase:
        """Pack the whole database on the engine's devices: into wave buckets
        on the wavefront path (``plan``: a plan_wave_buckets result), each
        then placed on the mesh (``_place``), else
        into ladder groups (``plan``: a BatchPlan) and, with segment packing,
        segment-packed groups for every sequence shorter than
        max(seg_widths), each packed on the host and its row shards placed
        on the devices as soon as it is packed (``_place_rows``; one device
        holds one shard)."""
        with span("swtpu.pack"):
            if self._wave_enabled:
                if plan is None:
                    plan = self._wave_plan(db)
                packed = pack_database_wave(db, device=self.device, plan=plan)
                return dataclasses.replace(packed, wave_groups=tuple(self._place(g) for g in packed.wave_groups))
            return self._pack_rows(db, plan)

    def _pack_rows(self, db: Database, plan: Optional[BatchPlan]) -> PackedDatabase:
        """The row path's ladder and segment groups of ``db``, placed on the
        devices (``pack_to_device``)."""
        cfg = self.config
        # Segment packing needs a usable saturation ceiling; large gap
        # penalties (or int16 mode) pack plain ladder batches.
        seg_ok = (
            cfg.segment_packing
            and cfg.score_dtype != "int16"
            and cfg.fast_saturating
            and segpack.seg16_sat(cfg.gap_penalty, cfg.seg_widths[0], cfg.seg_s_max) >= 1024
        )
        if not seg_ok:
            return pack_database(db, plan if plan is not None else self.plan(db), place=self._place_rows)
        lengths = db.lengths
        s_max_for = lambda w: max(2, min(cfg.seg_s_max, cfg.seg_widths[0] * cfg.seg_s_max // w))  # noqa: E731
        rows_for = lambda w: min(cfg.batch_rows, max(256, cfg.max_batch_cells // w))  # noqa: E731
        # Zero-length records score 0 and never enter a packed row.
        short = (lengths < cfg.seg_widths[-1]) & (lengths > 0)
        short_idx = np.nonzero(short)[0]
        seg_groups = []
        for width, batches in segpack.plan_multiclass(lengths[short_idx], short_idx, cfg.seg_widths, s_max_for, rows_for):
            seg_groups.extend(
                segpack.pack_batches_to_groups(
                    db, batches, gap=cfg.gap_penalty, width=width, s_max=s_max_for(width), place=self._place_rows,
                    row_multiple=self._row_multiple,
                )
            )
        long_idx = np.nonzero(~short)[0]
        groups = ()
        if long_idx.size:
            long_plan = self._ladder_plan(lengths[long_idx], min_width=cfg.seg_widths[-1])
            # the subset plan's positional ids -> database ids
            remapped = dataclasses.replace(
                long_plan,
                batches=tuple(dataclasses.replace(b, ids=long_idx[b.ids].astype(np.int64)) for b in long_plan.batches),
            )
            groups = pack_database(db, remapped, place=self._place_rows).groups
        return PackedDatabase(groups=groups, n_sequences=db.n, seg_groups=tuple(seg_groups))

    def _resident_packed(self, db: Database, plan: Optional[BatchPlan] = None) -> Optional[PackedDatabase]:
        """The cached device-resident pack for ``db``, packing it on first
        use; None when it must stream instead: residency is off, or the
        plan's int8 bytes (the wave plan, or on the row path the ladder
        plan) exceed ``device_resident_cells`` or a share of the device's
        free memory.

        ``plan`` (a BatchPlan, ``plan(db)``'s by default) packs the row
        path's ladder groups; the wavefront path plans its own buckets, as
        swtpu's pack does.  As in swtpu the cache is keyed by the database
        object alone: a plan given once ``db`` is resident does not repack."""
        if self._resident is not None and self._resident[0] is db:
            return self._resident[1]
        if not self.config.device_resident:
            return None
        budget = resident_cell_budget(self.config.device_resident_cells, self._devices)
        if self._wave_enabled:
            plan = self._wave_plan(db)
            need = sum((width + wave_sw.W) * bpad for width, _, _, bpad, _ in plan)
            if self._qshard:  # every device holds the whole database
                need *= len(self._devices)
        else:
            if plan is None:
                plan = self.plan(db)
            need = plan.total_cells
        if need > budget:
            return None
        self._resident = (db, self.pack_to_device(db, plan))
        return self._resident[1]

    # --- scoring ------------------------------------------------------------------

    def _wave_plan(self, db: Database):
        """The wave plan of ``db``: its buckets' lanes padded to split into
        equal shards of whole lane tiles over the lane shards' devices."""
        return plan_wave_buckets(db, lane_multiple=self._lanes.size, chain=self._wave_chain)

    def _score_shards(self, groups, launch) -> List[List[torch.Tensor]]:
        """Every bucket call of the wavefront path: ``launch(k, group,
        part)`` for each bucket and each of its lane shards, on shard k's
        device (inside its device context: a kernel entry point sets the
        thread's CUDA device itself); returns the outputs per shard, in
        bucket order, where they were computed.  One device is one shard."""
        outs: List[List[torch.Tensor]] = [[] for _ in range(self._lanes.size)]
        for g in groups:
            for k, part in enumerate(g.parts):
                with on_device(part.device):
                    outs[k].append(launch(k, g, part))
        return outs

    def _gather(self, outs: List[List[torch.Tensor]], profile: torch.Tensor) -> torch.Tensor:
        """Per-shard outputs as one flat array on the primary device, bucket
        by bucket and each bucket's shards in mesh order: the lane-major
        (lane, segment) order of the bucket's ids."""
        if not outs[0]:
            return torch.zeros(*profile.shape[:-2], 0, dtype=torch.int32, device=self.device)
        return torch.cat(
            [shard[i].to(self.device, non_blocking=True) for i in range(len(outs[0])) for shard in outs], dim=-1
        )

    def _packed_outs(self, profile: torch.Tensor, groups) -> List[List[torch.Tensor]]:
        """Score every bucket, one launch a lane shard; per-shard outputs
        (``_score_shards``), (lanes,) for a (qpad, 32) profile or (Q, lanes)
        for a profile stack, which every device gets a replica of.

        A stack of several queries whose band carry would exceed the scratch
        share of its device's free memory (utils/memory.py) is split along
        the query axis into as many launches as it takes.
        """
        profiles = self._replicas(profile)
        multi = profile.dim() == 3 and profile.shape[0] > 1
        n_bands = profile.shape[-2] // wave_sw.W
        # Free memory is read once a call and device, not once a bucket.
        free = {dev: scratch_budget_bytes(dev) for dev in self._lanes.distinct} if multi else {}
        budgets = [free.get(dev) for dev in self._lanes.devices]
        int16 = wave_sw.uses_int16(tuple(self._gaps.values()), hand_off=False)

        def launch(k, g, part):
            prof = profiles[k]
            budget = budgets[k]
            per_query = wave_sw.carry_bytes(n_bands, g.n_segs, g.seg_cols, part.shape[1], self._affine)
            if not int16:  # gaps past the int16x2 kernel's: the int32 kernel's carry
                per_query = wave_sw.carry_bytes(n_bands, g.n_segs, g.seg_cols, part.shape[1], self._affine, int16=False)
            if budget is not None and per_query * prof.shape[0] > budget:
                step = max(1, budget // per_query)
                return torch.cat([
                    wave_sw.sw_wave(prof[i : i + step], part, n_segs=g.n_segs, **self._gaps)
                    for i in range(0, prof.shape[0], step)
                ])
            return wave_sw.sw_wave(prof, part, n_segs=g.n_segs, **self._gaps)

        return self._score_shards(groups, launch)

    def _packed_step(self, profile: torch.Tensor, groups) -> torch.Tensor:
        """Score every bucket, one launch a lane shard; flat scores on the
        primary device, (total,) for a (qpad, 32) profile or (Q, total) for
        a profile stack."""
        return self._gather(self._packed_outs(profile, groups), profile)

    def _fused_step(self, profile: torch.Tensor, stack: torch.Tensor) -> int:
        """Chunks per K2 launch over a (C, B, L) stack: all C, or as many as
        keep the band carry within the scratch share of free device memory.
        A launch whose bands fit in one pass of the kernel needs no carry."""
        C, B, L = stack.shape
        need = bucket_sw.carry_bytes(-(-profile.shape[0] // bucket_sw.W), C, B, L)
        budget = scratch_budget_bytes(stack.device)
        if budget is None or need <= budget:
            return max(C, 1)
        return max(1, budget // (need // C))

    def _fused_stack(self, profile: torch.Tensor, stack: torch.Tensor) -> torch.Tensor:
        """K2 over a (C, B, L) ladder stack: (C, B) exact int32, in launches
        of ``_fused_step`` chunks."""
        cfg = self.config
        C = stack.shape[0]
        step = self._fused_step(profile, stack)
        return torch.cat([
            bucket_sw.sw_score_bucket_fused(profile, stack[i : i + step], gap=cfg.gap_penalty, strip=cfg.query_strip)
            for i in range(0, C, step)
        ])

    def _row_step(self, profile: torch.Tensor, packed: PackedDatabase) -> torch.Tensor:
        """Score every ladder and segment group of a row-path pack for one
        (qpad, 32) profile; flat (total,) scores on the primary device,
        ladder groups first.  Ladder groups run K2 with ``use_pallas``, else
        fast16 where its ceiling is high enough, else exact int32; segment
        groups seg16.  On a mesh each row shard runs them on its device
        (``_row_shards``)."""
        cfg = self.config
        gap, strip = cfg.gap_penalty, cfg.query_strip
        profiles = self._replicas(profile)

        def ladder(k, g, stack):
            sat = self._fast16_sat(g.width)
            if self._use_pallas:
                return self._fused_stack(profiles[k], stack)
            if sat is not None:
                return row_sw.sw_score_stack_fast16(
                    profiles[k], stack, gap=gap, strip=strip, sat=sat, stage_int8=self._stage_int8)
            return row_sw.sw_score_stack(profiles[k], stack, gap=gap, strip=strip)

        def seg(k, g, part):
            stack, rebases, ends = part
            return row_sw.sw_score_stack_seg16(
                profiles[k], stack, rebases, ends, gap=gap, strip=strip, sat=g.sat, stage_int8=self._stage_int8)

        outs = self._row_shards(packed.groups, ladder) + self._row_shards(packed.seg_groups, seg)
        if not outs:
            return torch.zeros(0, dtype=torch.int32, device=self.device)
        return torch.cat([o.reshape(-1) for o in outs])

    def _row_shards(self, groups, launch) -> List[torch.Tensor]:
        """Every row group's scores: ``launch(k, group, part)`` for each of
        its row shards, on shard k's device (in its device's context), then
        the shards gathered on the primary in mesh order along the rows:
        (C, rows) a ladder group, (C, rows, s_max) a segment group."""
        out = []
        for g in groups:
            shards = []
            for k, part in enumerate(g.parts):
                with on_device((part[0] if isinstance(part, tuple) else part).device):
                    shards.append(launch(k, g, part))
            if len(shards) == 1:
                out.append(shards[0])
            else:
                out.append(torch.cat([x.to(self.device, non_blocking=True) for x in shards], dim=1))
        return out

    def _scored(self, profile: torch.Tensor, packed: PackedDatabase) -> List[List[torch.Tensor]]:
        """One query's scores against a resident pack, per shard
        (``_score_shards``): through the query-band pipeline under
        query_shard, else one launch per bucket, or on the row path its
        scorers, gathered on the primary (one shard)."""
        if self._qshard:
            return [[self._query_sharded(profile, g) for g in packed.wave_groups]]
        if self._wave_enabled:
            return self._packed_outs(profile, packed.wave_groups)
        return [[self._row_step(profile, packed)]]

    def _flat(self, profile: torch.Tensor, packed: PackedDatabase) -> torch.Tensor:
        """One query's flat scores against a resident pack, on the primary
        device (``_scored``, gathered)."""
        return self._gather(self._scored(profile, packed), profile)

    def _query_sharded(self, profile: torch.Tensor, group) -> torch.Tensor:
        """One bucket's scores through the query-band pipeline: device k
        scores its block of the profile's bands on every lane tile of its
        replica, from device k - 1's band carry (parallel.query_shard)."""
        if group.n_segs != 1:
            raise ValueError("query_shard scores one subject a lane: its pack is unchained")
        return query_shard.wave_pipeline(
            query_shard.band_slices(profile, self.mesh), group.parts, self.mesh, **self._gaps
        )

    def _group_threshold(self, width: int) -> Optional[int]:
        """Saturation (rescore) threshold of a ladder group of this width.
        K2 is exact int32 at every width (the TPU kernel stops at 4096 and
        routes wider groups to fast16)."""
        cfg = self.config
        if self._use_pallas:
            return None
        sat = self._fast16_sat(width)
        if sat is not None:
            return sat
        return row_sw.SAT16_MAX if cfg.score_dtype == "int16" else None

    def _reduce_flat(
        self, flat_all: np.ndarray, packed: PackedDatabase, db: Optional[Database] = None, profile=None
    ) -> np.ndarray:
        """Scatter one query's flat scores back to file order (wave, then
        ladder, then segment groups; pads dropped; zero-length records,
        which no group holds, keep score 0) and rescore saturated rows
        exactly against ``profile``, the query's profile on the device."""
        scores = np.zeros(packed.n_sequences, dtype=np.int32)
        sat_ids = []
        off = 0
        for group in packed.wave_groups:
            vals = flat_all[off : off + group.rows]
            off += group.rows
            valid = group.ids >= 0
            scores[group.ids[valid]] = vals[valid]  # exact int32: no rescore
        for group in packed.groups:
            size = group.chunks * group.rows
            vals = flat_all[off : off + size]
            off += size
            ids = group.ids.ravel()
            valid = ids >= 0
            scores[ids[valid]] = vals[valid]
            threshold = self._group_threshold(group.width)
            if threshold is not None:
                sat_ids.append(ids[valid][vals[valid] >= threshold])
        for group in packed.seg_groups:
            for batch in group.batches:
                size = batch.rows * batch.s_max
                z = flat_all[off : off + size].reshape(batch.rows, batch.s_max)
                off += size
                ids, vals = segpack.extract_scores(batch, z, group.sat)
                scores[ids] = vals
                sat_ids.append(ids[vals >= group.sat])
        if sat_ids:
            self._rescore(scores, np.concatenate(sat_ids), db, profile)
        return scores

    def _rescore(self, scores: np.ndarray, sat_ids: np.ndarray, db: Database, profile: torch.Tensor) -> None:
        """Rescore saturated rows exactly in int32 (row_sw.sw_score_bucket on
        the engine's device), all in one bucket padded to a 256-residue
        quantum; pad columns cannot change a score."""
        if sat_ids.size == 0:
            return
        if db is None or profile is None:
            raise ValueError("saturated rows need the database and the query profile to be rescored")
        seqs = [db.sequence(int(i)) for i in sat_ids]
        width = max(256, -(-max(len(x) for x in seqs) // 256) * 256)
        subj = np.full((len(seqs), width), PAD_SUBJECT, dtype=np.int8)
        for k, x in enumerate(seqs):
            subj[k, : len(x)] = x
        exact = row_sw.sw_score_bucket(profile, self._upload(subj), gap=self.config.gap_penalty, strip=self.config.query_strip)
        scores[sat_ids] = exact.cpu().numpy()
        self.rescored_rows += int(sat_ids.size)

    # --- device top-K and E-values ------------------------------------------------

    def _topk_kk(self, k: int, total: int) -> int:
        """Candidate-fetch size: over-sized for host tie re-ranking, and wide
        enough to cover the null fit's trim when collecting statistics."""
        kk = min(total, max(4 * k + 64, k))
        if self.config.evalue:
            kk = min(total, max(kk, int(np.ceil(self._top_trim * total))))
        return kk

    def _evalue_bins(self, db: Database, ids_flat: np.ndarray):
        """Length-bin metadata for the device null reduction: bin edges over
        subject lengths, the bin id of every flat slot on the host (pad
        slots -> overflow bin), and the per-bin log-length/subject-count
        vectors of the length-corrected fit (swtpu_torch.stats)."""
        from .. import stats as st

        edges, log_len, n_subj = self._population_bins(db)
        lens = np.where(ids_flat >= 0, db.lengths[np.maximum(ids_flat, 0)], 0)
        bins = st.length_bin_ids(lens, edges).astype(np.int64)
        return edges, bins, log_len, n_subj, len(edges)

    def _population_bins(self, db: Database):
        """``stats.population_bins`` of the database's lengths (bin edges,
        mean ln(length) and subjects a bin), computed once a database
        object: every null fitted to it extrapolates to these."""
        cached = self._population_bins_cache
        if cached is not None and cached[0] is db:
            return cached[1]
        from .. import stats as st

        bins = st.population_bins(db.lengths)
        self._population_bins_cache = (db, bins)
        return bins

    def _topk_setup(self, db: Database, packed: PackedDatabase):
        """(total, kk, key low bits, (bins, nb)|None, evalue metadata|None,
        shards|None) of top-K searches against ``packed``, cached per (db,
        packed).  On one device the low bits and bins cover the flat array
        on the device; on a lane-sharded mesh ``shards`` holds each shard's
        (total, kk, low bits, (bins, nb)|None) on its device instead, over
        its slice of every bucket, and the flat-array ones are None."""
        cached = self._topk_cache
        if cached is not None and cached[0] is db and cached[1] is packed:
            return cached[2]
        ids_flat = np.concatenate([g.ids for g in packed.wave_groups])
        if ids_flat.size and int(ids_flat.max()) >= _ID_MASK:
            raise ValueError(f"device top-K keys hold file ids below {_ID_MASK}; the database has {db.n}")
        total = int(ids_flat.shape[0])
        kk = self._topk_kk(self.config.top_k, total)
        low = np.where(ids_flat >= 0, _ID_MASK - ids_flat, 0)
        bins = meta = None
        if self.config.evalue:
            edges, bins, log_len, n_subj, nb = self._evalue_bins(db, ids_flat)
            meta = (edges, log_len, n_subj)
        if self._lanes.size == 1:
            setup = (total, kk, self._upload(low), None if bins is None else (self._upload(bins), nb), meta, None)
        else:
            # A bucket's ids are lane-major, so shard k's slots are its k-th
            # equal slice of every bucket.
            n = self._lanes.size
            cuts = np.cumsum([0] + [g.rows for g in packed.wave_groups])
            shards = []
            for k, dev in enumerate(self._lanes.devices):
                sel = np.concatenate([np.split(np.arange(a, b), n)[k] for a, b in zip(cuts[:-1], cuts[1:])])
                put = lambda a: torch.from_numpy(np.ascontiguousarray(a[sel])).to(dev)  # noqa: E731
                shards.append((int(sel.size), min(kk, int(sel.size)), put(low), None if bins is None else (put(bins), nb)))
            setup = (total, kk, None, None, meta, tuple(shards))
        self._topk_cache = (db, packed, setup)
        return setup

    @staticmethod
    def _topk_keys(flat: torch.Tensor, setup):
        """Device top-kk keys of flat scores along the last axis (score high,
        ``_ID_MASK - id`` low: descending = (score desc, id asc)), and the
        null moments when collecting E-value statistics, or None.
        torch.topk leaves the order of equal values unspecified; the keys
        have none.  ``setup``: its kk, low bits and bins are read."""
        kk, low, bins = setup[1:4]
        key = torch.topk((flat.to(torch.int64) << 32) | low, kk, dim=-1, largest=True, sorted=True).values
        return key, (_null_moments(flat, *bins) if bins is not None else None)

    @staticmethod
    def _topk_reduce(flat: torch.Tensor, setup):
        """Device top-kk of flat scores (``_topk_keys``) as (vals, ids,
        moms|None) on the device, in (score desc, id asc) order."""
        key, moms = SearchEngine._topk_keys(flat, setup)
        return (key >> 32).to(torch.int32), _ID_MASK - (key & _ID_MASK), moms

    def _topk_of(self, outs: List[List[torch.Tensor]], setup):
        """The device top-K of per-shard outputs (``_score_shards``) as
        (vals, ids, moms|None) on the primary device.  On a mesh each shard
        reduces its own keys and moments on its device; the primary takes
        the top-kk of the n x kk keys (each shard's top-kk holds every key
        of the overall top-kk that it owns) and adds the moment vectors, as
        swtpu's collective merge does."""
        shards = setup[5]
        if shards is None:
            return self._topk_reduce(torch.cat(outs[0], dim=-1), setup)
        keys, moms = [], []
        for shard, shard_setup in zip(outs, shards):
            flat = torch.cat(shard, dim=-1)
            with on_device(flat.device):
                key, mom = self._topk_keys(flat, shard_setup)
            keys.append(key.to(self.device, non_blocking=True))
            moms.append(None if mom is None else mom.to(self.device, non_blocking=True))
        key = torch.topk(torch.cat(keys, dim=-1), setup[1], dim=-1, largest=True, sorted=True).values
        mom = None if moms[0] is None else torch.stack(moms).sum(dim=0)
        return (key >> 32).to(torch.int32), _ID_MASK - (key & _ID_MASK), mom

    def _build_null(self, q: Query, db: Database, vals, cand_ids, moms, edges, log_len, n_subj):
        """swtpu_torch.stats.NullStats from the device moment vector
        (_null_moments) and the fetched top candidates, whose (score desc,
        id asc) order is the one a full-array fit uses."""
        from .. import stats as st

        m = np.asarray(moms, np.int64).reshape(-1)
        nb = (m.shape[0] - 3) // 3
        nz = vals > 0
        tids = cand_ids[nz]
        tlens = np.where(tids >= 0, db.lengths[np.maximum(tids, 0)], 0)
        return st.NullStats(
            count=int(m[0]),
            total=float(m[1]),
            total_sq=float(m[2]),
            top_vals=vals[nz].astype(np.float64),
            n_subjects=db.n,
            query_length=q.length,
            mean_subject_length=db.length_sum / max(db.n, 1),
            top_bins=st.length_bin_ids(tlens, edges),
            bin_counts=m[3 : 3 + nb].astype(np.float64),
            bin_sums=m[3 + nb : 3 + 2 * nb].astype(np.float64),
            bin_sumsqs=m[3 + 2 * nb :].astype(np.float64),
            bin_log_len=log_len,
            bin_n_subjects=n_subj,
        )

    def _attach_null(self, result: SearchResult, q: Query, db: Database) -> SearchResult:
        """Host-side null statistics for full-score-array results (the
        device-reduction paths attach theirs when they resolve)."""
        if not self.config.evalue or result.null_stats is not None or result.scores is None:
            return result
        from .. import stats as st

        result.null_stats = st.null_stats_from_scores(
            result.scores,
            n_subjects=db.n,
            query_length=q.length,
            mean_subject_length=db.length_sum / max(db.n, 1),
            lengths=db.lengths,
            trim=self._top_trim,
            bins=self._population_bins(db),
        )
        return result

    @staticmethod
    def _resolve_topk_hits(vals, cand_ids, k, kk, total, db):
        """Resolve a descending device top-kk candidate set (file ids, -1 on
        pad slots) into exact (id, score) hits with the engine's (score
        desc, id asc) order, or None when boundary ties could extend past
        the fetched candidates."""
        keep = cand_ids >= 0  # drop pad slots (score 0)
        vals, cand_ids = vals[keep], cand_ids[keep]
        # Zero-length records never enter a bucket; they score 0, so merge
        # them back as candidates for a k-th score of 0.
        zero_ids = np.nonzero(np.asarray(db.lengths) == 0)[0]
        if zero_ids.size:
            cand_ids = np.concatenate([cand_ids, zero_ids])
            vals = np.concatenate([vals, np.zeros(zero_ids.size, vals.dtype)])
        if kk < total:
            # Pad slots also score 0 and may have displaced real score-0
            # sequences: a short candidate set, or a k-th kept score of 0,
            # needs the full array.
            if vals.shape[0] < k or vals[min(k, vals.shape[0]) - 1] == 0:
                return None
            if vals.shape[0] > k and vals[k - 1] == vals[-1]:
                return None  # k-th score ties run off the candidate set
        order = np.lexsort((cand_ids, -vals))[:k]
        return [(int(cand_ids[i]), int(vals[i])) for i in order]

    def _topk_result(self, q, db, packed, setup, vals, ids, moms, metrics, timer: PhaseTimer) -> SearchResult:
        """A hits-only result from one query's fetched candidates, or its
        full-array search when boundary ties defeat the candidate set (the
        ``fallback`` phase, whose search goes on with ``timer``)."""
        total, kk, meta = setup[0], setup[1], setup[4]
        with timer.phase("resolve"):
            cand_ids = np.where(ids == _ID_MASK, -1, ids)
            hits = self._resolve_topk_hits(vals, cand_ids, self.config.top_k, kk, total, db)
        if hits is None:
            with timer.phase("fallback"):
                return self.search_packed(q, db, packed, skip_device_topk=True, timer=timer)
        null = None
        if moms is not None:
            with timer.phase("null"):
                null = self._build_null(q, db, vals, cand_ids, moms, *meta)
        return SearchResult(scores=None, metrics=metrics, hits=hits, null_stats=null)

    # --- single search --------------------------------------------------------------

    def _fused_key(self, q: Query) -> int:
        """Rows of a query's single-search profile (one launch a bucket): the
        shape ``warmup`` runs.  Under query_shard the band quantum is W x n,
        so that every device owns as many whole bands."""
        if not self._wave_enabled:
            return self._query_pad(q.length, self.config.query_strip)
        return self._query_pad(q.length, wave_sw.W * (self.mesh.size if self._qshard else 1))

    def _profile(self, query: Query) -> torch.Tensor:
        """A single search's (qpad, 32) profile on the device, of
        ``_fused_key`` rows."""
        return self._upload(make_profile(query.residues, self.matrix, pad_rows_to=self._fused_key(query)))

    def search_packed(
        self, query: Query, db: Database, packed: PackedDatabase, skip_device_topk: bool = False,
        timer: Optional[PhaseTimer] = None,
    ) -> SearchResult:
        """Search a database already packed on the engine's device.

        With ``config.top_k`` the top-K reduces on the device and only
        candidate rows transfer, unless ``skip_device_topk`` asks for the
        full array (the tie fallback of the top-K paths, which passes its
        search's ``timer`` to go on with).  The result's ``metrics.phases``
        is the timer's own dict: every phase of the search, those after the
        accounting included.
        """
        cfg = self.config
        timer = PhaseTimer() if timer is None else timer
        t_start = time.perf_counter()
        # Under query_shard the full array comes back and the host takes the
        # top-K, as in swtpu (whose collective top-K is lane sharding's).
        device_topk = cfg.top_k is not None and not skip_device_topk and packed.wave_groups and not self._qshard
        with timer.phase("plan"):
            profile = self._profile(query)
            setup = self._topk_setup(db, packed) if device_topk else None
        cells = profile.shape[0] * packed.total_cells
        launches0 = self._launches()

        if device_topk:
            with self._oom_hint(f"scoring a packed database of {packed.total_cells} cells"):
                with timer.phase("enqueue"):
                    rescores0 = self._rescore_fetch()
                    t0 = self._mark()
                    vals, ids, moms = self._topk_of(self._scored(profile, packed), setup)
                    t1 = self._mark()
                with timer.phase("transfer"):
                    vals, ids, moms = (None if x is None else self._to_host(x) for x in (vals, ids, moms))
                    rescores = self._rescore_fetch()
                    self._sync()
            with timer.phase("metrics"):
                metrics = self._metrics(
                    query, db, cells, time.perf_counter() - t_start, self._seconds(t0, t1),
                    phases=timer.phases, transfer_seconds=timer.phases["transfer"],
                    kernel_launches=self._launches() - launches0, rescored_lanes=self._rescored(rescores0, rescores),
                )
            return self._topk_result(
                query, db, packed, setup, vals.numpy(), ids.numpy(), None if moms is None else moms.numpy(), metrics,
                timer,
            )

        with self._oom_hint(f"scoring a packed database of {packed.total_cells} cells (query length {query.length})"):
            with timer.phase("enqueue"):
                rescores0 = self._rescore_fetch()
                t0 = self._mark()
                flat = self._flat(profile, packed)
                t1 = self._mark()
            self._wait(t1)
            device_seconds = self._seconds(t0, t1)
        with timer.phase("transfer"):
            rescores = self._rescore_fetch()
            flat_all = flat.cpu().numpy()

        with timer.phase("reduce"):
            scores = self._reduce_flat(flat_all, packed, db, profile)

        with timer.phase("metrics"):
            metrics = self._metrics(
                query, db, cells, time.perf_counter() - t_start, device_seconds,
                phases=timer.phases, transfer_seconds=timer.phases["transfer"],
                kernel_launches=self._launches() - launches0, rescored_lanes=self._rescored(rescores0, rescores),
            )
        return self._attach_null(SearchResult(scores=scores, metrics=metrics), query, db)

    def search(self, query: Query, db: Database, plan: Optional[BatchPlan] = None) -> SearchResult:
        """Search ``db``: resident (packed on its first search) when it fits
        the budget, else streamed bucket by bucket (wave path) or batch by
        batch (row path) with exact query padding.  ``plan``: the row path's
        ladder plan (``_resident_packed``); with ``config.prefilter`` the
        two-phase heuristic search runs instead (``_search_prefiltered``).
        The whole search is the span ``swtpu.search``."""
        with span("swtpu.search"):
            if self.config.prefilter is not None:
                return self._search_prefiltered(query, db)
            return self._search_exhaustive(query, db, plan)

    def _search_exhaustive(self, query: Query, db: Database, plan: Optional[BatchPlan] = None) -> SearchResult:
        """``search`` without the prefilter: every subject scored.  The
        prefilter's exhaustive fallback scores its sub-database through this
        body of its exact engine, not through ``search``: one request is one
        ``search`` call and one ``swtpu.search`` span, so that whatever wraps
        or times ``search`` sees each request once, with its own answer."""
        packed = self._resident_packed(db, plan)
        if packed is not None:
            return self.search_packed(query, db, packed)
        if not self._wave_enabled or self._qshard:
            # The row ladder, batch by batch on the primary device: the row
            # path's stream, and swtpu's route for a database that cannot be
            # resident under query_shard (its batches unsharded, on the
            # default device).
            if self._affine:
                raise ValueError(
                    "affine gaps under query_shard need a resident database: one that streams "
                    "runs swtpu's row ladder, which scores linear gaps only; raise device_resident_cells"
                )
            return self._attach_null(self._search_rows_streaming(query, db, plan), query, db)
        return self._attach_null(self._search_many_wave_streaming([query], db, serving=False)[0], query, db)

    # --- batched serving ------------------------------------------------------------

    def _query_pieces(self, queries: List[Query], serving: bool = True):
        """Group queries by padded band count and cut binary-size pieces
        (<= 16) in first-seen order: [(qpad, [query index, ...])].

        ``serving=False`` keeps exact padding, the query_ladder=None
        contract for single searches."""
        by_qpad: dict = {}
        for i, q in enumerate(queries):
            by_qpad.setdefault(self._query_pad(q.length, wave_sw.W, serving=serving), []).append(i)
        pieces = []
        for qpad, idxs in by_qpad.items():
            pos = 0
            while pos < len(idxs):
                take = 16
                while take > len(idxs) - pos:
                    take //= 2
                pieces.append((qpad, idxs[pos : pos + take]))
                pos += take
        return pieces

    def _piece_profiles(self, queries: List[Query], qpad: int, piece: List[int]) -> torch.Tensor:
        """(Q, qpad, 32) int8 profile stack of one piece, on the device."""
        return self._upload(np.stack([make_profile(queries[i].residues, self.matrix, pad_rows_to=qpad) for i in piece]))

    def _search_many_wave(self, queries: List[Query], db: Database, packed: PackedDatabase) -> List[SearchResult]:
        """Batched serving on a resident pack: one launch per (bucket,
        piece), one host sync per piece.  Per-query times are
        cell-proportional shares of the piece (``SearchMetrics.attributed``).
        Each piece is the span ``swtpu.piece``; each query's ``phases`` are
        its piece's (plan, enqueue, transfer: the whole piece's seconds)
        and its own."""
        out: List[Optional[SearchResult]] = [None] * len(queries)
        setup = self._topk_setup(db, packed) if self.config.top_k is not None else None
        for qpad, piece in self._query_pieces(queries):
            with span("swtpu.piece"):
                for i, res in zip(piece, self._serve_piece(queries, db, packed, qpad, piece, setup)):
                    out[i] = res
        return out  # type: ignore[return-value]

    def _serve_piece(self, queries: List[Query], db: Database, packed: PackedDatabase, qpad: int,
                     piece: List[int], setup) -> List[SearchResult]:
        """One piece of ``_search_many_wave``: its launches, one sync, and
        its queries' results in piece order (``setup``: the top-K set-up,
        or None for full arrays)."""
        topk = setup is not None
        results = []
        timer = PhaseTimer()
        t_start = time.perf_counter()
        launches0 = wave_sw.sw_wave.launches
        with timer.phase("plan"):
            profiles = self._piece_profiles(queries, qpad, piece)
        with self._oom_hint(f"batched scoring of {len(piece)} queries vs {packed.total_cells} packed cells"):
            with timer.phase("enqueue"):
                rescores0 = self._rescore_fetch()
                t0 = self._mark()
                outs = self._packed_outs(profiles, packed.wave_groups)  # per shard, (Q, lanes) a bucket
                fetched = self._topk_of(outs, setup) if topk else (self._gather(outs, profiles),)
                t1 = self._mark()
            with timer.phase("transfer"):
                fetched = [None if x is None else self._to_host(x) for x in fetched]
                rescores = self._rescore_fetch()
                self._sync()
        device_seconds = self._seconds(t0, t1)
        wall = time.perf_counter() - t_start
        launches = wave_sw.sw_wave.launches - launches0
        rescored = self._rescored(rescores0, rescores)
        total_true = sum(queries[i].length for i in piece) * db.length_sum
        for row, i in enumerate(piece):
            share = (queries[i].length * db.length_sum) / max(total_true, 1)
            own = PhaseTimer(dict(timer.phases), dict(timer.counts))
            with own.phase("metrics"):
                metrics = self._metrics(
                    queries[i], db, qpad * packed.total_cells, wall * share, device_seconds * share,
                    phases=own.phases, attributed=True, transfer_seconds=timer.phases["transfer"],
                    kernel_launches=launches, rescored_lanes=rescored,
                )
            if topk:
                vals, ids, moms = (None if x is None else x[row].numpy() for x in fetched)
                results.append(self._topk_result(queries[i], db, packed, setup, vals, ids, moms, metrics, own))
            else:
                with own.phase("reduce"):
                    scores = self._reduce_flat(fetched[0][row].numpy(), packed)
                results.append(self._attach_null(SearchResult(scores=scores, metrics=metrics), queries[i], db))
        return results

    def search_many(
        self, queries: List[Query], db: Database, packed: Optional[PackedDatabase] = None
    ) -> List[SearchResult]:
        """Batched multi-query search.

        Queries of equal padded length (the serving ladder in auto mode)
        fold into the kernel's query axis and share one launch per bucket;
        the reference's Performance suite runs 17 queries back to back
        (test/swissprot_tests.cpp:99-115), here they share launches.  A
        database that cannot be resident streams, every query scored against
        each bucket upload.  With ``config.prefilter`` one coarse launch
        scores the whole batch and the exact phases sync once
        (``_search_many_prefiltered``).
        """
        if not queries:
            return []
        with span("swtpu.search_many"):
            if self.config.prefilter is not None:
                return self._search_many_prefiltered(queries, db)
            if not self._wave_enabled:
                # The row kernels have no query axis: each query keeps its own
                # launches, and the batch syncs once.
                return self.search_queued(queries, db, packed=packed)
            if packed is None:
                packed = self._resident_packed(db)
                if packed is None:
                    if self._qshard:  # the row ladder (search), a search a query, as swtpu
                        return [self.search(q, db) for q in queries]
                    return [
                        self._attach_null(r, q, db)
                        for q, r in zip(queries, self._search_many_wave_streaming(queries, db))
                    ]
            if not packed.wave_groups or self._qshard:
                # Nothing to launch (every record is empty), or the band
                # pipeline, which carries one query: a search a query.
                return [self.search_packed(q, db, packed) for q in queries]
            return self._search_many_wave(queries, db, packed)

    # --- queued serving ---------------------------------------------------------------

    def search_queued(
        self,
        queries: List[Query],
        db: Database,
        plan: Optional[BatchPlan] = None,
        *,
        packed: Optional[PackedDatabase] = None,
    ) -> List[SearchResult]:
        """Throughput protocol: enqueue every query's own launches back to
        back on the current stream, then sync once for the whole batch.

        Unlike :meth:`search_many` on the wavefront path, each query keeps
        its own launches (any length mix, exact padding).  With
        ``config.top_k`` each query's launches end in the device top-K and
        only candidate rows transfer.  Per-query times are cell-proportional
        shares (``SearchMetrics.attributed``).  ``plan`` as in
        :meth:`search`; ``packed``, a pack already on the device, skips the
        residency lookup.  A database that cannot be resident falls back to
        sequential :meth:`search` (which streams).
        """
        if not queries:
            return []
        if packed is None:
            packed = self._resident_packed(db, plan)
            if packed is None:
                return [self.search(q, db, plan) for q in queries]
        if self._qshard:  # the band pipeline carries one query: a search a query
            return [self.search_packed(q, db, packed) for q in queries]
        topk = self.config.top_k is not None and bool(packed.wave_groups)
        setup = self._topk_setup(db, packed) if topk else None

        t_start = time.perf_counter()
        launches0 = self._launches()
        pending = []
        with self._oom_hint(f"queued scoring of {len(queries)} queries"):
            rescores0 = self._rescore_fetch()
            t0 = self._mark()
            for q in queries:
                profile = self._profile(q)
                outs = self._scored(profile, packed)
                fetched = self._topk_of(outs, setup) if topk else (self._gather(outs, profile),)
                # Each query's copy streams while later queries compute.
                pending.append((profile, [None if x is None else self._to_host(x) for x in fetched]))
            t1 = self._mark()
            rescores = self._rescore_fetch()
            self._sync()  # the one sync of the batch
        device_seconds = self._seconds(t0, t1)
        launches = self._launches() - launches0
        rescored = self._rescored(rescores0, rescores)

        results = []
        total_true = sum(q.length for q in queries) * max(db.length_sum, 1)
        for q, (profile, fetched) in zip(queries, pending):
            share = (q.length * db.length_sum) / max(total_true, 1)
            timer = PhaseTimer()
            metrics = self._metrics(
                q, db, profile.shape[0] * packed.total_cells, (time.perf_counter() - t_start) * share,
                device_seconds * share, phases=timer.phases, attributed=True, kernel_launches=launches,
                rescored_lanes=rescored,
            )
            if topk:
                vals, ids, moms = (None if x is None else x.numpy() for x in fetched)
                results.append(self._topk_result(q, db, packed, setup, vals, ids, moms, metrics, timer))
            else:
                scores = self._reduce_flat(fetched[0].numpy(), packed, db, profile)
                results.append(self._attach_null(SearchResult(scores=scores, metrics=metrics), q, db))
        return results

    # --- warmups ------------------------------------------------------------------------

    def warmup(
        self, queries: List[Query], db: Database, plan: Optional[BatchPlan] = None, threads: int = 8
    ) -> float:
        """Run, from a thread pool, one real search dispatch for every
        distinct shape ``queries`` will need, ahead of them; returns the
        seconds spent.  A shape is a single-search profile's rows
        (``_fused_key``); with ``top_k`` the dispatch ends in the device
        top-K, as the searches will.  On the card the first dispatch builds
        or loads the kernel library, and any one packs the database resident
        and warms the caching allocator; nothing is compiled per shape.  A
        failure in a worker is raised here.  No-op (0.0) for a database that
        streams, as :meth:`search_queued` then falls back to searches, and
        under query_shard, whose searches run one query at a time.
        ``plan`` as in :meth:`search`."""
        packed = self._resident_packed(db, plan)
        if packed is None or self._qshard or not queries:
            return 0.0
        t0 = time.perf_counter()
        seen: dict = {}
        for q in queries:
            seen.setdefault(self._fused_key(q), q)
        setup = self._topk_setup(db, packed) if self.config.top_k is not None and packed.wave_groups else None

        def fire(q: Query) -> None:
            outs = self._scored(self._profile(q), packed)
            if setup is not None:
                self._topk_of(outs, setup)
            self._sync()  # this thread's streams: the dispatch has run

        with ThreadPoolExecutor(max_workers=max(1, threads)) as ex:
            list(ex.map(fire, seen.values()))  # raises the first worker's exception
        return time.perf_counter() - t0

    # --- the k-mer prefilter ----------------------------------------------------------------

    def _exact_engine(self) -> "SearchEngine":
        """Lazy exhaustive engine for the exact phase off the wavefront
        path: the same config without the heuristic knobs, unchained (as
        swtpu's), and without E-values (the caller fits its null from the
        calibration sample, not from the candidates' biased scores), on the
        same devices: a mesh keeps its shards, as swtpu's does."""
        if self._exact is None:
            self._exact = SearchEngine(
                self.config.replace(prefilter=None, top_k=None, wave_chain=False, evalue=False),
                device=self.mesh if self.mesh is not None else self.device,
            )
        return self._exact

    def _prefilter_signatures(self, db: Database):
        """(signatures (n, DIM) int8, popcounts (n,) int32, residues, int64
        offsets) on the engine's device, made once per database object (the
        span ``swtpu.prefilter_build``): the coarse pass reads the first
        two, gather_stack the last two (int64 offsets: no 2**31-residue
        limit on the gather).  On the card the residues and offsets are
        copied up once and the signatures built there
        (``pf.database_signatures_cuda``): no host copy of the index
        exists.  On the CPU the native host pass makes them
        (``pf.database_signatures``)."""
        cached = self._sig_cache
        if cached is not None and cached[0] is db:
            return cached[1]
        self._sig_cache = None  # release the previous database's tensors first
        with span("swtpu.prefilter_build"):
            offsets = np.ascontiguousarray(db.offsets, dtype=np.int64)
            if self._on_cuda:
                # A plain copy, not _upload's pinned one: a pinned staging
                # copy of a multi-GB buffer would stay in the host allocator's cache.
                flat = torch.from_numpy(np.ascontiguousarray(db.residues)).to(self.device)
                offsets = torch.from_numpy(offsets).to(self.device)
                sig, pop = pf.database_signatures_cuda(flat, offsets)
            else:
                sig = self._upload(pf.database_signatures(db))
                pop, flat, offsets = sig.sum(dim=1, dtype=torch.int32), self._upload(db.residues), self._upload(offsets)
        resident = (sig, pop, flat, offsets)
        self._sig_cache = (db, resident)
        return resident

    def _n_cand(self, n: int) -> int:
        """Candidates a query keeps: the ``prefilter`` fraction of n, at least
        ``prefilter_min_candidates`` and 4 * top_k, at most n."""
        cfg = self.config
        if n == 0:
            return 0
        return min(max(int(np.ceil(cfg.prefilter * n)), min(cfg.prefilter_min_candidates, n), 4 * cfg.top_k), n)

    def _search_prefiltered(self, query: Query, db: Database) -> SearchResult:
        """Two-phase heuristic search of one query: ``_search_many_prefiltered``
        on a batch of one, its times its own (not ``attributed``)."""
        return self._search_many_prefiltered([query], db, attributed=False)[0]

    def _search_many_prefiltered(self, queries: List[Query], db: Database, attributed: bool = True) -> List[SearchResult]:
        """Two-phase heuristic search (``ops.prefilter``), the one body of
        ``search`` and ``search_many`` under ``config.prefilter``: one int8
        coarse launch ranks the batch against the resident signatures
        (``_coarse_rank``), each query's candidates are merged
        (``_prefilter_candidates``) and its exact rescore enqueued
        (``_prefilter_exact_enqueue``), and one sync drains them.  A query
        whose candidates are the whole database (no k-mer, no shared bucket,
        or a candidate set that covers it), and every query off the
        wavefront path, is scored over its candidates by the exact engine
        (``_prefilter_exhaustive``).  Hits are exact SW scores with
        file-order ids; ``scores`` is None (most of the array was never
        computed).  Device seconds are the coarse pass's span plus the exact
        phases'; with ``attributed`` a query's times are its cell-proportional
        share of the batch's."""
        cfg = self.config
        t_start = time.perf_counter()
        timer = PhaseTimer()
        launches0 = self._launches()
        with timer.phase("prefilter_signatures"):
            sig, pop, _, _ = self._prefilter_signatures(db)
            qsigs = np.stack([pf.signature(q.residues) for q in queries])
        n_cand = self._n_cand(db.n)
        # A degenerate signal (a query shorter than K, an empty database)
        # takes exhaustive candidates rather than arbitrary hits.
        good = [i for i in range(len(queries)) if db.n and qsigs[i].any()]
        ranked, device_seconds = {}, 0.0
        if good:
            packed, device_seconds = self._coarse_rank(sig, pop, self._upload(qsigs[good]), n_cand, timer)
            ranked = dict(zip(good, packed))
        scored, pend = {}, []
        for qi, q in enumerate(queries):
            with timer.phase("prefilter_merge"):
                cand = self._prefilter_candidates(ranked.get(qi), n_cand, db)
            if self._wave_enabled and cand.shape[0] < db.n:
                flat, jobs, cells, marks = self._prefilter_exact_enqueue(q, db, cand, timer)
                pend.append((qi, self._to_host(flat), jobs, cells, marks))
            else:
                scores, cells, dev_s = self._prefilter_exhaustive(q, db, cand, timer)
                scored[qi] = (cand, scores, cells, 0)
                device_seconds += dev_s
        self._sync()  # the one sync of the batch's exact phases
        for qi, host, jobs, cells, marks in pend:
            ids, scores = self._prefilter_exact_scores(host, jobs)
            scored[qi] = (ids, scores, cells, self._long_candidates(jobs))
            device_seconds += self._seconds(*marks)
        nulls = {}
        if cfg.evalue:
            for qi, (ids, scores, _, _) in sorted(scored.items()):
                with timer.phase("prefilter_null"):
                    nulls[qi] = self._null_from_sample(queries[qi], db, ids, scores)
        wall = time.perf_counter() - t_start
        launches = self._launches() - launches0
        total_cells = max(sum(r[2] for r in scored.values()), 1)
        out = []
        for qi, q in enumerate(queries):
            ids, scores, cells, n_long = scored[qi]
            share = cells / total_cells if attributed else 1.0
            metrics = self._metrics(
                q, db, cells, wall * share, device_seconds * share,
                phases=dict(timer.phases), attributed=attributed, kernel_launches=launches,
                prefilter_candidates=int(ids.shape[0]), long_candidates=n_long,
            )
            hits = self._hits_from(ids, scores, min(cfg.top_k, int(ids.shape[0])))
            out.append(SearchResult(scores=None, metrics=metrics, hits=hits, null_stats=nulls.get(qi)))
        return out

    def _coarse_rank(self, sig, pop, qsigs: torch.Tensor, n_cand: int, timer):
        """The coarse pass of (Q, DIM) query signatures on the device: K7's
        counts (the phase ``prefilter_coarse``), then the z-scores, each
        signal's stable sort and the copy back of the (Q, 3, n_cand) ids
        (``prefilter_rank``; ``pf.candidates_from_counts``).  Returns them on
        the host and the device seconds of both."""
        t0 = self._mark()
        with timer.phase("prefilter_coarse"):
            q = qsigs.to(torch.int8).contiguous()
            counts = int8_mma.coarse_counts(q, sig)
        with timer.phase("prefilter_rank"):
            packed = pf.candidates_from_counts(counts, pop, q, n_cand)
            t1 = self._mark()
            packed = packed.cpu().numpy()
        return packed, self._seconds(t0, t1)

    def _prefilter_candidates(self, ranked: Optional[np.ndarray], n_cand: int, db: Database) -> np.ndarray:
        """A query's ascending candidate ids: the merge of its (3, n_cand)
        coarse ranking, or every id when it has no signal (no ranking, or no
        bucket shared with any subject: ranking by it would pick an id
        prefix), then with ``evalue`` the union with the calibration sample,
        which is scored exactly too for an unbiased sampled fit."""
        if ranked is not None and int(ranked[2, 0]) != 0:
            cand = pf.merge_candidates(ranked[0], ranked[1], n_cand)
        else:
            cand = np.arange(db.n, dtype=np.int64)
        if self.config.evalue:
            cand = np.union1d(cand, self._evalue_sample(db))
        return cand

    def _prefilter_exhaustive(self, query: Query, db: Database, cand: np.ndarray, timer):
        """The exhaustive fallback, and the row path's exact phase: the
        candidates' sub-database scored by the exact engine's search body.
        Returns (scores in ``cand`` order, packed cells, device seconds); the
        sub-search's phases add to ``timer``'s."""
        with timer.phase("prefilter_gather"):
            sub = db.take(cand)
        sub_result = self._exact_engine()._search_exhaustive(query, sub)
        for name, seconds in sub_result.metrics.phases.items():
            timer.phases[name] = timer.phases.get(name, 0.0) + seconds
        return np.asarray(sub_result.scores), sub_result.metrics.packed_cells, sub_result.metrics.device_seconds

    def _prefilter_exact_enqueue(self, query: Query, db: Database, cand: np.ndarray, timer):
        """Enqueue, without a sync, the exact rescore of one query's
        candidates, split by length.  Returns (flat scores on the device,
        jobs, packed cells, (start, end) marks) for
        ``_prefilter_exact_scores``; a job is (ids, scores it fills,
        route).

        Candidates of at most ``PREFILTER_WAVE_WIDTH`` residues take one
        wavefront launch (K1, route "wave"), gathered on the device from the
        resident residue buffer (``pf.gather_stack``) into a bucket of that
        width whose lanes are a power of two from 256, as swtpu pins them.
        The longer ones take one launch of ``long_sw.sw_long`` (route
        "long"): each scored with the roles swapped, read in place from the
        resident buffer, longest first.  ``packed_cells`` counts what each
        route computes: the bucket's padded cells, and the long route's
        32-row bands times the query's length.
        """
        lens = db.lengths[cand]
        short = lens <= PREFILTER_WAVE_WIDTH
        order = np.argsort(-lens[~short], kind="stable")
        long_ids = cand[~short][order]
        _, _, flat, offsets = self._prefilter_signatures(db)
        jobs, cells = [], 0
        with timer.phase("prefilter_pack"):
            if short.any():
                part = cand[short]
                qpad = self._query_pad(query.length, wave_sw.W, serving=True)
                profile = self._upload(make_profile(query.residues, self.matrix, pad_rows_to=qpad))
                bpad = max(256, 1 << (int(part.shape[0]) - 1).bit_length())
                cand_pad = np.full(bpad, -1, dtype=np.int64)
                cand_pad[: part.shape[0]] = part
                jobs.append((part, bpad, "wave"))
                cells += qpad * bpad * (PREFILTER_WAVE_WIDTH + wave_sw.W)
            if long_ids.shape[0]:
                jobs.append((long_ids, int(long_ids.shape[0]), "long"))
                cells += int((-(-lens[~short] // 32)).sum()) * 32 * query.length
        t0 = self._mark()
        outs = []
        for _, _, route in jobs:
            if route == "wave":
                stack = pf.gather_stack(flat, offsets, self._upload(cand_pad), PREFILTER_WAVE_WIDTH)
                outs.append(wave_sw.sw_wave(profile, stack, **self._gaps))
            else:
                residues = self._upload(np.ascontiguousarray(query.residues, dtype=np.int8))
                outs.append(long_sw.sw_long(residues, flat, offsets, self._upload(long_ids), self._long_table(),
                                            **self._gaps))
        t1 = self._mark()
        return torch.cat(outs), jobs, cells, (t0, t1)

    def _long_table(self) -> torch.Tensor:
        """The long route's (25, 32) int8 matrix table on the engine's device."""
        if self._long_table_cache is None:
            self._long_table_cache = self._upload(long_sw.matrix_table(self.matrix))
        return self._long_table_cache

    @staticmethod
    def _prefilter_exact_scores(flat_host: torch.Tensor, jobs):
        """(candidate ids, exact scores) of an enqueued exact phase, from its
        flat scores on the host after the sync (pad lanes dropped)."""
        flat = flat_host.numpy()
        split, pieces = 0, []
        for part, n_out, _ in jobs:
            pieces.append(flat[split : split + part.shape[0]])
            split += n_out
        return np.concatenate([part for part, _, _ in jobs]), np.concatenate(pieces)

    @staticmethod
    def _long_candidates(jobs) -> int:
        """Candidates an exact phase scored on the long route."""
        return sum(int(part.shape[0]) for part, _, route in jobs if route == "long")

    @staticmethod
    def _hits_from(ids: np.ndarray, scores: np.ndarray, k: int) -> List[Tuple[int, int]]:
        """Top-k (id, score) in the engine's (score desc, id asc) order."""
        order = np.lexsort((ids, -scores))[:k]
        return [(int(ids[i]), int(scores[i])) for i in order]

    def _evalue_sample(self, db: Database) -> np.ndarray:
        """The deterministic random calibration sample of prefilter E-values
        (2,048 ids, ``default_rng(0)``), scored exactly beside the
        candidates: the candidate set is biased by the coarse score, and a
        null fitted to it would be wrong."""
        cached = self._evalue_sample_cache
        if cached is not None and cached[0] is db:
            return cached[1]
        n = min(2048, db.n)
        sample = np.sort(np.random.default_rng(0).choice(db.n, n, replace=False)).astype(np.int64)
        self._evalue_sample_cache = (db, sample)
        return sample

    def _null_from_sample(self, q: Query, db: Database, ids: np.ndarray, scores: np.ndarray):
        """NullStats from the calibration sample's exact scores, found among
        the rescored (ids, scores)."""
        from .. import stats as st

        sample = self._evalue_sample(db)
        order = np.argsort(ids)
        idx = order[np.searchsorted(ids[order], sample)]
        return st.null_stats_from_scores(
            scores[idx],
            n_subjects=db.n,
            query_length=q.length,
            mean_subject_length=db.length_sum / max(db.n, 1),
            lengths=db.lengths[sample],
            population_lengths=db.lengths,
            trim=self._top_trim,
            bins=self._population_bins(db),
        )

    # --- streaming ----------------------------------------------------------------------

    def _upload_bucket(self, host_stack: torch.Tensor, copy_streams) -> Tuple[torch.Tensor, ...]:
        """A host-packed bucket's lane shards, shard k on device k (the
        whole stack on one device).  On the card each copy runs pinned on
        its device's copy stream (``copy_streams``, by device); the device's
        current stream waits for it, and the shard is recorded on that
        stream so the caching allocator cannot hand its memory back while a
        kernel still reads it."""
        bounds = lane_bounds(host_stack.shape[1], self._lanes.size)
        out = []
        for (lo, hi), dev in zip(bounds, self._lanes.devices):
            part = host_stack[:, lo:hi]
            if copy_streams is None:
                out.append(part.contiguous().to(dev))
                continue
            with on_device(dev):
                compute = torch.cuda.current_stream(dev)
                pinned = part.contiguous().pin_memory()
                with torch.cuda.stream(copy_streams[dev]):
                    shard = pinned.to(dev, non_blocking=True)
                compute.wait_stream(copy_streams[dev])
                shard.record_stream(compute)
            out.append(shard)
        return tuple(out)

    def _stream_bucket(self, group, pieces, copy_streams):
        """Upload one host-packed bucket and enqueue every piece against it;
        returns the in-flight entry that _drain_streamed completes."""
        on_device = (dataclasses.replace(group, parts=self._upload_bucket(group.stack, copy_streams)),)
        t0 = self._mark()
        outs = [(piece, self._packed_step(profiles, on_device)) for _, piece, profiles in pieces]
        t1 = self._mark()
        outs = [(piece, self._to_host(flat)) for piece, flat in outs]
        return group.ids, outs, t0, t1, self._mark()

    def _drain_streamed(self, entry, scores: List[np.ndarray]) -> float:
        """Wait for one in-flight bucket (not the ones behind it), scatter
        its scores; returns its kernel seconds."""
        ids, outs, t0, t1, copied = entry
        self._wait(copied)
        valid = ids >= 0
        for piece, host in outs:
            flat = host.numpy()  # (Q, rows)
            for row, qi in enumerate(piece):
                scores[qi][ids[valid]] = flat[row][valid]
        return self._seconds(t0, t1)

    def _search_many_wave_streaming(
        self, queries: List[Query], db: Database, serving: bool = True
    ) -> List[SearchResult]:
        """Serving for a database that is not resident: pack one bucket at a
        time on the host, upload it, and score every query against it, so
        each upload serves the whole batch.  At most two buckets are in
        flight (a new one is enqueued only after draining down to one), so
        device memory holds two buckets at a time.

        Per-query metrics are cell-proportional shares of the batch totals
        (``SearchMetrics.attributed``).
        """
        t_start = time.perf_counter()
        pieces = [
            (qpad, piece, self._piece_profiles(queries, qpad, piece))
            for qpad, piece in self._query_pieces(queries, serving=serving)
        ]
        qpad_of = {i: qpad for qpad, piece, _ in pieces for i in piece}
        scores = [np.zeros(db.n, dtype=np.int32) for _ in queries]
        copy_streams = {dev: torch.cuda.Stream(dev) for dev in self._devices} if self._on_cuda else None
        launches0 = wave_sw.sw_wave.launches
        # packed on the host, one at a time
        buckets = iter_wave_groups(db, chain=self._wave_chain, lane_multiple=self._lanes.size)
        inflight = []
        padded_total = 0
        pack_time = device_seconds = 0.0
        with self._oom_hint(f"streaming wave buckets for {len(queries)} queries"):
            while True:
                t0 = time.perf_counter()
                group = next(buckets, None)
                pack_time += time.perf_counter() - t0
                if group is None:
                    break
                padded_total += group.cells
                inflight.append(self._stream_bucket(group, pieces, copy_streams))
                if len(inflight) >= 2:  # bound device residency to 2 buckets
                    device_seconds += self._drain_streamed(inflight.pop(0), scores)
            while inflight:
                device_seconds += self._drain_streamed(inflight.pop(0), scores)
        wall = time.perf_counter() - t_start
        launches = wave_sw.sw_wave.launches - launches0

        total_true = sum(q.length for q in queries) * max(db.length_sum, 1)
        results = []
        for i, q in enumerate(queries):
            share = (q.length * db.length_sum) / max(total_true, 1)
            results.append(SearchResult(
                scores=scores[i],
                metrics=self._metrics(
                    q, db, qpad_of[i] * padded_total, wall * share, device_seconds * share,
                    phases={"pack_and_put": pack_time * share}, attributed=True, kernel_launches=launches,
                ),
            ))
        return results


    def _search_rows_streaming(self, query: Query, db: Database, plan: Optional[BatchPlan] = None) -> SearchResult:
        """The row path for a database that is not resident: pack the ladder
        plan (``plan(db)``'s unless given) batch by batch on the host, upload
        each, score it with the streamed scorer (K3 with ``use_pallas``),
        scatter the scores to file order, and rescore saturated rows exactly.
        Device time is the sum of the scorer's own spans (CUDA events),
        without the host packing.  On a mesh every batch goes unsharded to
        the primary device, as swtpu's streamed ladder puts each batch on its
        default device: swtpu's semantics, with the plan's rows on the mesh's
        row multiple, not a fallback."""
        timer = PhaseTimer()
        t_start = time.perf_counter()
        with timer.phase("plan"):
            if plan is None:
                plan = self.plan(db)
            profile = self._upload(make_profile(query.residues, self.matrix, pad_rows_to=self.config.query_strip))
        launches0 = self._launches()
        batches = iter_packed(db, plan)
        pending = []
        pack_time = 0.0
        with self._oom_hint(f"streaming {len(plan.batches)} batches ({plan.total_cells} cells)"):
            while True:
                t0 = time.perf_counter()
                item = next(batches, None)
                if item is not None:
                    subj = self._upload(item[1])
                pack_time += time.perf_counter() - t0
                if item is None:
                    break
                m0 = self._mark()
                out, threshold = self._kernel(profile, subj)
                pending.append((self._to_host(out), threshold, m0, self._mark()))
            with timer.phase("device_sync"):
                self._sync()
        timer.phases["pack_and_put"] = pack_time
        device_seconds = sum(self._seconds(m0, m1) for _, _, m0, m1 in pending)
        launches = self._launches() - launches0
        per_batch = [host.numpy() for host, _, _, _ in pending]
        with timer.phase("reduce"):
            scores = scatter_scores(plan, per_batch)
        with timer.phase("rescore_saturated"):
            sat_ids = [
                batch.ids[np.nonzero(vals[: batch.n_valid] >= threshold)[0]]
                for batch, vals, (_, threshold, _, _) in zip(plan.batches, per_batch, pending)
                if threshold is not None
            ]
            if sat_ids:
                self._rescore(scores, np.concatenate(sat_ids).astype(np.int64), db, profile)
        return SearchResult(
            scores=scores,
            metrics=self._metrics(
                query, db, profile.shape[0] * plan.total_cells, time.perf_counter() - t_start, device_seconds,
                phases=dict(timer.phases), kernel_launches=launches,
            ),
        )


def search_file(query_path, db_path, config: SWConfig = SWConfig(), device=None) -> SearchResult:
    """One-shot convenience mirroring the reference CLI's flow."""
    from ..io.fasta import parse_database, parse_query

    engine = SearchEngine(config, device=device)
    return engine.search(parse_query(query_path), parse_database(db_path))
