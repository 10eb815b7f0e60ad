"""Typed engine configuration (the fields of ``swtpu.config.SWConfig``).

This package implements linear and affine (Gotoh) gaps on the wavefront
kernel: single, batched, queued and streaming searches, the full score array
or a device top-K, E-values, and the alignment traceback; and swtpu's
row-parallel scoring family (``use_wave=False``, ``score_dtype="int16"``):
ladder and segment packing, the int32, fast16, seg16 and int16-parity
scorers with their exact rescore, and the CUDA kernels K2 and K3 behind
``use_pallas``; the k-mer prefilter (``prefilter``), whose coarse pass is
the CUDA kernel of ``ops.int8_mma``; and multi-device search
(``mesh_shape``, ``query_shard``: swtpu_torch.parallel) on every one of
those paths, and across processes (``parallel.distributed``).  The
TPU-only ``interpret`` and ``wave_unroll_block`` have no counterpart, nor
has composed band-group dispatch: swtpu chains a query's bands as
power-of-two rungs to bound its compiled kernels, and the CUDA kernel takes
any shape, so on the card the chain would only add launches and carry
traffic.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SWConfig:
    """Configuration for a Smith-Waterman database search."""

    # --- scoring semantics (implemented) ------------------------------------
    gap_penalty: int = 2  # linear gap
    # Affine (Gotoh) gaps: a gap of length L costs gap_open + (L-1) *
    # gap_extend.  Both or neither; set, they replace gap_penalty on every
    # path (the kernel's affine mode, even when gap_open == gap_extend) and
    # route alignments to the Gotoh traceback.
    gap_open: Optional[int] = None
    gap_extend: Optional[int] = None
    matrix: str = "blosum50_ref"  # see swtpu_torch.matrices.get_matrix
    # --- residency and chaining (implemented) --------------------------------
    # Pack the database onto the device once and search it there when its
    # packed int8 subject cells fit this budget and the device's free memory;
    # otherwise (or with device_resident=False) stream it bucket by bucket.
    device_resident: bool = True
    device_resident_cells: int = 1 << 30
    # Lay several short subjects end to end per lane (None = auto: on).
    wave_chain: Optional[bool] = None
    # --- results and serving (implemented) -----------------------------------
    top_k: Optional[int] = None  # None = full score array; else a device top-K
    # Collect the null distribution's sufficient statistics for E-values and
    # bit scores (SearchResult.top_k_stats), on the device on top-K paths.
    evalue: bool = False
    # Round query-row padding up the serving ladder (32-step to 256, then
    # ~1.25x); None = auto: on for batched serving (search_many), where it
    # merges queries into shared launches, exact padding for single searches.
    query_ladder: Optional[bool] = None

    # --- the row-parallel path (implemented) ----------------------------------
    # Score accumulation: "int32" (exact) or "int16" (saturating parity mode
    # of the reference's narrow-type kernel, with an exact int32 rescore of
    # saturated rows; always off the wavefront path).
    score_dtype: str = "int32"
    length_quantum: int = 128  # the ladder planner's width quantum
    batch_rows: int = 8192  # subjects per ladder batch
    max_batch_cells: int = 1 << 23  # rows * width cap per ladder batch
    chunk_budget_residues: int = 64 * 1024 * 1024
    # Bin sequences shorter than seg_widths[-1] into shared rows of up to
    # seg_s_max segments (swtpu_torch.utils.segpack).
    segment_packing: bool = True
    seg_widths: Tuple[int, ...] = (512,)
    seg_s_max: int = 8
    query_strip: int = 32  # query-row padding quantum of the row path
    # int16 u-space scoring with an exact int32 rescore of saturated rows.
    fast_saturating: bool = True
    # The wavefront kernel; None = auto: on (the card stands where swtpu has
    # its TPU), off in int16 parity mode.  False selects the row path.
    use_wave: Optional[bool] = None
    # Row path: ladder groups through K2, streamed batches through K3.  None
    # = auto: on for a CUDA device, off on the CPU; False keeps the PyTorch
    # scorers (swtpu's XLA family) on the card too.
    use_pallas: Optional[bool] = None

    # --- heuristic prefilter (implemented) ------------------------------------
    # A k-mer coarse pass (swtpu_torch.ops.prefilter) scores the whole
    # database in one int8 product, then only the top ``prefilter`` fraction
    # (at least prefilter_min_candidates and 4 * top_k) is scored exactly.
    # Reported hits are exact; hits outside the candidate set are missed.
    # Requires top_k.
    prefilter: Optional[float] = None
    prefilter_min_candidates: int = 256

    # --- parallelism (implemented) -------------------------------------------------
    # Device mesh axis sizes: the database shards over prod(mesh_shape)
    # devices (swtpu_torch.parallel.mesh), one contiguous lane shard of every
    # wave bucket (on the row path, row shard of every group) a device, and
    # the results merge on the first.
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("db",)
    # Query-band sharding: with a mesh, split the query's bands across the
    # devices instead of the lanes, pipelining lane tiles with the kernel's
    # band carry handed from device k to k+1 (swtpu_torch.parallel.
    # query_shard); the database is replicated.  For latency on long
    # queries against small databases.
    query_shard: bool = False

    def __post_init__(self):
        if self.gap_penalty < 0:
            raise ValueError("gap_penalty must be >= 0")
        if (self.gap_open is None) != (self.gap_extend is None):
            raise ValueError("gap_open and gap_extend must be set together")
        if self.gap_open is not None:
            if self.gap_open < self.gap_extend or self.gap_extend < 0:
                raise ValueError("affine gaps need gap_open >= gap_extend >= 0")
            if self.score_dtype == "int16":
                raise ValueError("affine gaps are exact-int32 only (wavefront kernel)")
        if self.length_quantum < 1 or self.batch_rows < 1:
            raise ValueError("length_quantum and batch_rows must be >= 1")
        if self.score_dtype not in ("int32", "int16"):
            raise ValueError(f"unsupported score_dtype {self.score_dtype!r}")
        if len(self.mesh_shape) != len(self.mesh_axes):
            raise ValueError("mesh_shape and mesh_axes must align")
        if any(int(n) < 1 for n in self.mesh_shape):
            raise ValueError(f"mesh_shape sizes must be >= 1 (got {self.mesh_shape})")
        if self.device_resident_cells < 0:
            raise ValueError("device_resident_cells must be >= 0")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError("top_k must be >= 1 (None for the full score array)")
        if self.prefilter is not None:
            if not (0.0 < self.prefilter <= 1.0):
                raise ValueError(f"prefilter must be a fraction in (0, 1] (got {self.prefilter})")
            if self.top_k is None:
                raise ValueError(
                    "prefilter requires top_k: the heuristic two-phase search "
                    "only reports a top-K (most scores are never computed)"
                )
            if self.prefilter_min_candidates < 1:
                raise ValueError("prefilter_min_candidates must be >= 1")
        if self.n_devices > 1 or self.query_shard:
            # swtpu's engine checks (swtpu/models/search.py:232-256), here so
            # that the CLI refuses before it parses anything.
            if self.wave_chain and self.query_shard:
                raise ValueError("wave_chain=True is incompatible with query_shard")
            if self.query_shard and (self.score_dtype == "int16" or self.use_wave is False):
                raise ValueError(
                    "query_shard requires the wavefront path: leave use_wave at None or True "
                    "and score_dtype at 'int32'"
                )

    @property
    def n_devices(self) -> int:
        return math.prod(int(n) for n in self.mesh_shape)

    def replace(self, **kw) -> "SWConfig":
        return dataclasses.replace(self, **kw)



# Reference-parity config: length quantum 8 as the reference's pad-to-8,
# exact int32 scores, the reference's BLOSUM50 with a zeroed '*', gap 2.
REFERENCE_PARITY = SWConfig(length_quantum=8, matrix="blosum50_ref", gap_penalty=2)
