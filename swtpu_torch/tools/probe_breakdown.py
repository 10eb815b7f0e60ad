"""K6 on the card: K1's band sweep with one stage at a time switched off.

The counterpart of ``tools/probe_breakdown.py``, on the port's kernels: every
variant of ``swtpu_torch.ops.wave_lab.sw_wave_skip``, which runs K1's linear
band sweep at H = 64 rows a band on K1's own 32-row-band profile ("none",
then no subject loads, no carry reads or writes, no cell DP;
``csrc/sw_wave_lab.cu`` defines each one's result over those 64-row bands),
and K1 (``wave_sw.sw_wave``) on P01008's 27 buckets of the SwissProt-shaped
database, timed bucket by bucket in turns with CUDA events in 3 rounds, a
bucket's time the median of its rounds (``buckets.main``).  Prints a table
of milliseconds a bucket with each variant's ratio to K1 for the narrow,
mid and full buckets and its spread across rounds, whether "none" gives
K1's scores bit for bit in every round, and each variant's shape.  The
other variants' scores are held to their plain versions by
``chip_smoke.py``.  Exits 1 without a CUDA device.

Run: ``python -m swtpu_torch.tools.probe_breakdown``
"""

from __future__ import annotations

import sys

from ..ops import wave_lab
from . import buckets
from . import wave_lab as wave_lab_tool

VARIANTS: buckets.Variants = {f"skip={s}": (wave_lab.sw_wave_skip, dict(skip=s)) for s in wave_lab.SKIPS}


def main() -> int:
    code = buckets.main("probe_breakdown", VARIANTS)
    if code == 0:
        for name, shape in wave_lab_tool.sweep_shapes(VARIANTS).items():
            print(f"{name}: {shape}")
    return code


if __name__ == "__main__":
    sys.exit(main())
