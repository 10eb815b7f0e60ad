"""Phase timing and GCUPS accounting (copy of ``swtpu.utils.metrics``).

The reference CLI reports one GCUPS figure, ``1e-9 * qlen * subjectLengthSum
/ wall``, whose numerator counts its pad-to-8 residues.  That formula stays
available for the METRICS block; the engine also reports true-cell GCUPS over
wall and over device time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Dict, Optional

from .profiling import span


@dataclasses.dataclass
class PhaseTimer:
    """Accumulating wall-clock phase timer.  Each phase is also the span
    ``swtpu.<name>`` in a recording profiler's trace (``profiling.span``)."""

    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)  # times each phase ran

    @contextlib.contextmanager
    def phase(self, name: str):
        with span("swtpu." + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0
                self.counts[name] = self.counts.get(name, 0) + 1

    def total(self) -> float:
        """Seconds over every phase."""
        return sum(self.phases.values())


@dataclasses.dataclass
class SearchMetrics:
    """Throughput accounting for one database search."""

    query_length: int
    n_subjects: int
    residue_sum: int  # true database residues
    padded8_sum: int  # reference-parity denominator basis (pad-to-8 included)
    packed_cells: int  # qpad * sum(lanes * (width + 32)): what the device computed
    wall_seconds: float
    device_seconds: float  # kernel stream time (CUDA events) or CPU compute time
    phases: Dict[str, float] = dataclasses.field(default_factory=dict)
    # True when wall_seconds/device_seconds are this query's cell-proportional
    # share of a batched run, not a per-query measurement.  GCUPS aggregates
    # stay correct (shares sum to the batch totals); do not read wall_seconds
    # as this query's latency when attributed is set: every query of the
    # batch waited for the whole batch.
    attributed: bool = False
    transfer_seconds: float = 0.0  # the "transfer" phase: scores (or top-K candidates) device -> host
    kernel_launches: int = 0
    # K1 (lane, segment) entries whose int16 best may have wrapped, rescored
    # in int32 on the card (in a batch: its piece's, as kernel_launches).
    rescored_lanes: int = 0
    # Ids a prefiltered search scored exactly: its candidates and the
    # E-value calibration sample (0 off the prefilter).
    prefilter_candidates: int = 0
    # Of those, the ones longer than the wavefront bucket's width, scored on
    # the long route (ops/long_sw.py; 0 off the prefilter).
    long_candidates: int = 0

    @property
    def gcups(self) -> float:
        """True-cell end-to-end GCUPS."""
        return 1e-9 * self.query_length * self.residue_sum / max(self.wall_seconds, 1e-12)

    @property
    def gcups_reference_formula(self) -> float:
        """Reference-parity GCUPS (padded numerator, full wall clock)."""
        return 1e-9 * self.query_length * self.padded8_sum / max(self.wall_seconds, 1e-12)

    @property
    def gcups_device(self) -> float:
        """True-cell GCUPS over device time only."""
        return 1e-9 * self.query_length * self.residue_sum / max(self.device_seconds, 1e-12)

    @property
    def gcups_device_padded(self) -> float:
        """Padded-cell GCUPS over device time."""
        return 1e-9 * self.packed_cells / max(self.device_seconds, 1e-12)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(
            gcups=self.gcups,
            gcups_reference_formula=self.gcups_reference_formula,
            gcups_device=self.gcups_device,
            gcups_device_padded=self.gcups_device_padded,
        )
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    def format_reference_block(self, elapsed: Optional[float] = None) -> str:
        """The METRICS block in the reference CLI's format."""
        wall = self.wall_seconds if elapsed is None else elapsed
        gcups = 1e-9 * self.query_length * self.padded8_sum / max(wall, 1e-12)
        lines = [
            "=" * 80,
            "METRICS:",
            f"Query length: {self.query_length} chars.",
            f"Num subjects: {self.n_subjects}",
            f"Sum of DB length: {self.padded8_sum} chars.",
            f"Time elapsed: {wall:g} seconds.",
            f"Performance: {gcups:g} GCUPS.",
        ]
        return "\n".join(lines)
