"""K4 and K5 on the card: the wavefront's band height and block size, the band sweep's prefetch depth.

The counterpart of ``tools/pallas_wave.py`` (K4, the V5 wavefront and its
knobs) and ``tools/pallas_wave2.py`` (K5, staging pipelined under the DP),
on the port's kernels: ``swtpu_torch.ops.wave_lab.sw_wave_band`` (K1's warp
wavefront) at every (height, block) and ``sw_wave_prefetch`` at every
depth, which runs K1's linear band sweep at H = 64 rows a band on K1's own
32-row-band profile, beside K1 (``wave_sw.sw_wave``), on P01008's 27
buckets of the SwissProt-shaped database, timed bucket by bucket in turns
with CUDA events in 3 rounds, a bucket's time the median of its rounds
(``buckets.main``), and beside K1 (its own choice of schedule a bucket) K1
forced to its warp wavefront and to its band sweep on every bucket.  Prints
a table of milliseconds a bucket with each variant's ratio to K1 for the
narrow, mid and full buckets and its spread across rounds, whether every
variant gives K1's scores bit for bit in every round, each K4 variant's
schedule for the query (bands a pass, passes, shared stage, blocks and
warps an SM) and each K5 variant's shape.  Exits 1 without a CUDA device.

Run: ``python -m swtpu_torch.tools.wave_lab``
"""

from __future__ import annotations

import sys
from typing import Dict

from ..ops import wave_lab, wave_sw
from . import buckets

VARIANTS: buckets.Variants = {
    **{f"H{h}/B{blk}": (wave_lab.sw_wave_band, dict(height=h, block=blk))
       for h in wave_lab.HEIGHTS for blk in wave_lab.BLOCKS},
    **{f"D{d}": (wave_lab.sw_wave_prefetch, dict(depth=d)) for d in wave_lab.DEPTHS},
}


def k1_schedules(n_rows: int) -> buckets.Variants:
    """K1 forced to its warp wavefront (``wave_shape``'s G for a query of
    ``n_rows`` residues, H = 32) and to its band sweep (H = 64) on every
    bucket."""
    wave = wave_sw.wave_shape(-(-n_rows // wave_sw.W), 1, 1)
    return {"K1 wavefront": (wave_sw.sw_wave, dict(shape=wave)),
            "K1 band sweep": (wave_sw.sw_wave, dict(shape=(1, wave_sw.BAND_H[False])))}


def k4_schedules(n_rows: int, device="cuda") -> Dict[str, dict]:
    """Each K4 variant's launch for a query of ``n_rows`` residues: its
    bands a pass (G), passes, shared stage, and blocks and warps an SM by
    the runtime's occupancy calculator on ``device``."""
    out = {}
    for name, (_, kw) in VARIANTS.items():
        if "height" not in kw:
            continue
        h, blk = kw["height"], kw["block"]
        sched = wave_lab.band_schedule(-(-n_rows // h), h, blk, 1)
        per_sm = wave_lab.blocks_per_sm(h, blk, sched.g, device)
        out[name] = dict(g=sched.g, passes=sched.passes, stage_bytes=sched.stage_bytes, blocks_per_sm=per_sm,
                         warps_per_sm=per_sm * blk // 32)
    return out


def sweep_shapes(variants: buckets.Variants, device="cuda") -> Dict[str, dict]:
    """Each K5 or K6 variant of ``variants``: K1's band sweep's height and
    block, its shared stage, and blocks and warps an SM by the runtime's
    occupancy calculator on ``device``."""
    out = {}
    for name, (fn, kw) in variants.items():
        if fn not in (wave_lab.sw_wave_prefetch, wave_lab.sw_wave_skip):
            continue
        per_sm = wave_lab.blocks_per_sm(wave_lab.SWEEP_HEIGHT, wave_lab.K1_BLOCK, 0, device,
                                        depth=kw.get("depth", 1), skip=kw.get("skip", "none"))
        out[name] = dict(height=wave_lab.SWEEP_HEIGHT, block=wave_lab.K1_BLOCK,
                         stage_bytes=wave_lab.SWEEP_STAGE_BYTES, blocks_per_sm=per_sm,
                         warps_per_sm=per_sm * wave_lab.K1_BLOCK // 32)
    return out


def main() -> int:
    n_rows = buckets.swissprot_query().length
    code = buckets.main("wave_lab", {**k1_schedules(n_rows), **VARIANTS})
    if code == 0:
        for name, sched in {**k4_schedules(n_rows), **sweep_shapes(VARIANTS)}.items():
            print(f"{name}: {sched}")
    return code


if __name__ == "__main__":
    sys.exit(main())
