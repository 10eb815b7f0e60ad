"""K9 on the card: packed int16 against int32, on tiles and in dependent chains.

The counterpart of ``tools/probe_i16.py``, on the port's kernels
(``swtpu_torch.ops.i16_probe``).  Where the TPU probe asked whether Mosaic
compiled each op, this runs them:

* the ten tiles of its ``run``: max, add, sub, select and dp_row on
  (16, 512) int16 and int32 tiles of ``run``'s inputs (a = arange % 1000,
  b = (3a + 7) % 997), each against its plain version;
* the sustained rate of each op in a dependent chain on every SM, int16
  packed in pairs against int32, and of the SW cell's fused ops (addmax =
  max(acc + y, x), max3 = max(acc, y, x); DPX for int16), in element
  operations a second against the int32 peak every int32 bound divides by
  (``roofline.INT32_OPS_PER_S``).

Exits 1 without a CUDA device.

Run: ``python -m swtpu_torch.tools.probe_i16``
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np
import torch

from ..ops import i16_probe
from .roofline import INT32_OPS_PER_S, _cuda, card, events_ms

TILE = (16, 512)
CHAIN_COLS = 512  # 32-bit words a chain row: 512 int32 or 1,024 int16 columns


def tile_inputs(dtype: torch.dtype, device="cpu"):
    """``tools/probe_i16.py``'s run inputs as a (16, 512) tile of ``dtype``."""
    a = np.arange(TILE[0] * TILE[1]).reshape(TILE) % 1000
    b = (a * 3 + 7) % 997
    return (torch.from_numpy(a).to(dtype).to(device), torch.from_numpy(b).to(dtype).to(device))


def chain_inputs(dtype: torch.dtype, device="cpu", seed: int = 2):
    """A chain's (32, cols) tiles: x in [0, 1000), y in [-2, 1), so
    addmax and max3 stay where they started and add and sub wrap."""
    cols = CHAIN_COLS * (2 if dtype == torch.int16 else 1)
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(0, 1000, (i16_probe.ROWS, cols))).to(dtype).to(device)
    y = torch.from_numpy(rng.integers(-2, 1, (i16_probe.ROWS, cols))).to(dtype).to(device)
    return x, y


def run_tiles(device="cuda", reps: int = 100, ops=i16_probe.OPS) -> List[Dict]:
    """Every (op, dtype) tile of ``ops``: the kernel's result (its last
    timed call's), its plain version's, and both times (ms a call, CUDA
    events over ``reps`` calls of the kernel, 10 of the plain version, after
    one plain call to warm; calls this small are bound by the host's launch
    rate).  The kernel launches ``reps`` times a tile."""
    dev = _cuda(device)
    rows = []
    for dtype in i16_probe.DTYPES:
        a, b = tile_inputs(dtype, dev)
        for op in ops:
            ms, out = events_ms(lambda: i16_probe.i16_op(a, b, op), reps)
            i16_probe.i16_op_plain(a, b, op)
            plain_ms, plain = events_ms(lambda: i16_probe.i16_op_plain(a, b, op), 10)
            rows.append(dict(op=op, dtype=str(dtype).split(".")[-1], out=out, plain=plain, ms=ms, plain_ms=plain_ms))
    return rows


def measure_chains(iters: int = 16384, device="cuda", reps: int = 3) -> List[Dict]:
    """Every (op, dtype) chain at full occupancy: ms a launch, element
    operations a launch and a second (``OPS_PER_ELEMENT`` a link), its
    share of the int32 peak, and its tile (``out``, the last timed launch's;
    with ``x`` and ``y``, its inputs).  A chain launches once to warm, then
    ``reps`` times timed."""
    dev = _cuda(device)
    rows = []
    for op in i16_probe.CHAIN_OPS:
        for dtype in i16_probe.DTYPES:
            x, y = chain_inputs(dtype, dev)
            blocks = i16_probe.chain_blocks(CHAIN_COLS, op, dtype, dev)
            i16_probe.i16_chain(x, y, op, 1, blocks)  # warm
            ms, out = events_ms(lambda: i16_probe.i16_chain(x, y, op, iters, blocks), reps)
            ops = i16_probe.OPS_PER_ELEMENT[op] * x.numel() * iters * i16_probe.UNROLL * blocks
            rate = ops / (ms * 1e-3)
            rows.append(dict(op=op, dtype=str(dtype).split(".")[-1], iters=iters, blocks=blocks, ms=ms, ops=ops,
                             ops_per_s=rate, share_of_int32_peak=rate / INT32_OPS_PER_S, x=x, y=y, out=out))
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_i16: no CUDA device: the kernels and rates are the card's", file=sys.stderr)
        return 1
    print(f"device: {card()}")
    ok = True
    for r in run_tiles():
        equal = torch.equal(r["out"], r["plain"])
        ok &= equal
        print(f"{r['op']:7s} {r['dtype']}: {'OK' if equal else 'MISMATCH'}  {r['ms'] * 1e3:8.2f} us a tile "
              f"(plain {r['plain_ms'] * 1e3:9.2f} us)")
    for r in measure_chains():
        print(f"chain {r['op']:7s} {r['dtype']}: {r['ops_per_s'] / 1e12:7.2f} T element ops/s "
              f"({r['ms']:.3f} ms a launch; {100 * r['share_of_int32_peak']:.1f}% of the int32 peak "
              f"{INT32_OPS_PER_S / 1e12:.2f})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
