"""Phase timing and GCUPS accounting (copy of ``swtpu.utils.metrics``).

The reference CLI reports one GCUPS figure, ``1e-9 * qlen * subjectLengthSum
/ wall``, whose numerator counts its pad-to-8 residues.  That formula stays
available for the METRICS block; the engine also reports true-cell GCUPS over
wall and over device time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, Optional


@dataclasses.dataclass
class PhaseTimer:
    """Accumulating wall-clock phase timer."""

    phases: Dict[str, float] = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.phases[name] = self.phases.get(name, 0.0) + time.perf_counter() - t0


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
    transfer_seconds: float = 0.0  # score array device -> host
    kernel_launches: int = 0

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
