"""Typed engine configuration (the fields of ``swtpu.config.SWConfig``).

This package implements the main path only: linear gaps, the wavefront
kernel, a device-resident database and the full score array.  A knob of a
feature that a later slice of the port brings (``ROADMAP.md`` Queue A) keeps
its field and default here, and setting it to anything else raises
``NotImplementedError`` naming that slice, so no setting is silently ignored.
The TPU-only ``interpret`` and ``wave_unroll_block`` have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class SWConfig:
    """Configuration for a Smith-Waterman database search."""

    # --- scoring semantics (implemented) ------------------------------------
    gap_penalty: int = 2  # linear gap
    matrix: str = "blosum50_ref"  # see swtpu_torch.matrices.get_matrix
    # --- residency and chaining (implemented) --------------------------------
    # Pack the database onto the device once and search it there; the packed
    # int8 subject cells must fit this budget and the device's free memory.
    device_resident: bool = True
    device_resident_cells: int = 1 << 30
    # Lay several short subjects end to end per lane (None = auto: on).
    wave_chain: Optional[bool] = None

    # --- knobs of later slices: defaults only ---------------------------------
    gap_open: Optional[int] = None
    gap_extend: Optional[int] = None
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
    top_k: Optional[int] = None
    evalue: bool = False
    prefilter: Optional[float] = None
    prefilter_min_candidates: int = 256
    query_ladder: Optional[bool] = None
    wave_compose: bool = False
    mesh_shape: Tuple[int, ...] = (1,)
    mesh_axes: Tuple[str, ...] = ("db",)
    query_shard: bool = False

    def __post_init__(self):
        if self.gap_penalty < 0:
            raise ValueError("gap_penalty must be >= 0")
        if self.device_resident_cells < 0:
            raise ValueError("device_resident_cells must be >= 0")
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
    "device_resident": "slice A8 (non-resident streaming search)",
    "gap_open": "slice A9 (affine gaps)",
    "gap_extend": "slice A9 (affine gaps)",
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
    "top_k": "slice A7 (device top-K and E-values)",
    "evalue": "slice A7 (device top-K and E-values)",
    "prefilter": "slice A12 (prefilter)",
    "prefilter_min_candidates": "slice A12 (prefilter)",
    "query_ladder": "slice A8 (batched serving)",
    "wave_compose": "slice A11 (composed band-group dispatch)",
    "mesh_shape": "slice A14 (multi-GPU)",
    "mesh_axes": "slice A14 (multi-GPU)",
    "query_shard": "slice A14 (multi-GPU)",
}
