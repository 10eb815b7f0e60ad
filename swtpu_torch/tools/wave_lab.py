"""K4 and K5 on the card: the wavefront sweep's band height, block size and prefetch depth.

The counterpart of ``tools/pallas_wave.py`` (K4, the V5 wavefront and its
knobs) and ``tools/pallas_wave2.py`` (K5, staging pipelined under the DP),
on the port's kernels: ``swtpu_torch.ops.wave_lab.sw_wave_band`` at every
(height, block) and ``sw_wave_prefetch`` at every depth, beside K1
(``wave_sw.sw_wave``), on P01008's 27 buckets of the SwissProt-shaped
database, timed bucket by bucket in turns with CUDA events
(``buckets.main``).  Prints a table of milliseconds a bucket with each
variant's ratio to K1 for the narrow, mid and full buckets, and whether
every variant gives K1's scores bit for bit.  Exits 1 without a CUDA device.

Run: ``python -m swtpu_torch.tools.wave_lab``
"""

from __future__ import annotations

import sys

from ..ops import wave_lab
from . import buckets

VARIANTS: buckets.Variants = {
    **{f"H{h}/B{blk}": (wave_lab.sw_wave_band, dict(height=h, block=blk))
       for h in wave_lab.HEIGHTS for blk in wave_lab.BLOCKS},
    **{f"D{d}": (wave_lab.sw_wave_prefetch, dict(depth=d)) for d in wave_lab.DEPTHS},
}


def main() -> int:
    return buckets.main("wave_lab", VARIANTS)


if __name__ == "__main__":
    sys.exit(main())
