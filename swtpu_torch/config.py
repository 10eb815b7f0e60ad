"""Typed engine configuration (the fields of ``swtpu.config.SWConfig``).

This package implements linear and affine (Gotoh) gaps on the wavefront
kernel: single, batched, queued and streaming searches, the full score array
or a device top-K, E-values, and the alignment traceback.  A knob of a
feature that a later slice of the port brings (``ROADMAP.md`` Queue A) keeps
its field and default here, and setting it to anything else raises
``NotImplementedError`` naming that slice, so no setting is silently
ignored.  The TPU-only ``interpret`` and
``wave_unroll_block`` have no counterpart.
"""

from __future__ import annotations

import dataclasses
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

    # --- knobs of later slices: defaults only ---------------------------------
    score_dtype: str = "int32"
    length_quantum: int = 128
    batch_rows: int = 8192
    max_batch_cells: int = 1 << 23
    chunk_budget_residues: int = 64 * 1024 * 1024
    segment_packing: bool = True
    seg_widths: Tuple[int, ...] = (512,)
    seg_s_max: int = 8
    query_strip: int = 32
    fast_saturating: bool = True
    use_wave: Optional[bool] = None  # the wavefront kernel is the only path: None or True
    use_pallas: bool = False
    prefilter: Optional[float] = None
    prefilter_min_candidates: int = 256
    wave_compose: bool = False
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("db",)
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
        if self.device_resident_cells < 0:
            raise ValueError("device_resident_cells must be >= 0")
        if self.top_k is not None and self.top_k < 1:
            raise ValueError("top_k must be >= 1 (None for the full score array)")
        defaults = SWConfig.__dataclass_fields__
        for name, later in _LATER_SLICES.items():
            value = getattr(self, name)
            if name == "use_wave" and value is True:
                continue
            if value != defaults[name].default:
                raise NotImplementedError(
                    f"SWConfig.{name}={value!r} is not ported yet: it arrives with "
                    f"{later} (ROADMAP.md Queue A)"
                )

    def replace(self, **kw) -> "SWConfig":
        return dataclasses.replace(self, **kw)


_NON_WAVE = "slice A13 (non-wave scoring family)"

# Field -> the slice of the port that implements it.
_LATER_SLICES = {
    "score_dtype": _NON_WAVE,
    "length_quantum": _NON_WAVE,
    "batch_rows": _NON_WAVE,
    "max_batch_cells": _NON_WAVE,
    "chunk_budget_residues": _NON_WAVE,
    "segment_packing": _NON_WAVE,
    "seg_widths": _NON_WAVE,
    "seg_s_max": _NON_WAVE,
    "query_strip": _NON_WAVE,
    "fast_saturating": _NON_WAVE,
    "use_wave": _NON_WAVE,
    "use_pallas": _NON_WAVE,
    "prefilter": "slice A12 (prefilter)",
    "prefilter_min_candidates": "slice A12 (prefilter)",
    "wave_compose": "slice A11 (composed band-group dispatch)",
    "mesh_shape": "slice A14 (multi-GPU)",
    "mesh_axes": "slice A14 (multi-GPU)",
    "query_shard": "slice A14 (multi-GPU)",
}
