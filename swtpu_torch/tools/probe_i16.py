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

``--route-ab PARENT`` times the tiles' launch route of the checkout at
PARENT against this one's instead (``route_ab``).  Exits 1 without a CUDA
device.

Run: ``python -m swtpu_torch.tools.probe_i16 [--route-ab PARENT]``
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


LIBRARY = {"max": torch.maximum, "add": torch.add, "sub": torch.sub,
           "select": lambda a, b: torch.where(a < b, b, a)}  # one PyTorch call of each elementwise op


def route_split(device="cuda", reps: int = 2000, turns: int = 3, op: str = "max",
                dtype: torch.dtype = torch.int16) -> Dict[str, List[float]]:
    """Host microseconds a call of each piece of ``i16_op``'s launch route
    on the (16, 512) tile, and of the wrapper and the library call whole:
    every piece ``reps`` calls on a host clock, the pieces in turns,
    ``turns`` times ({piece: [us a call, a turn]}).  The C pieces
    (cudaGetDevice, the entry's check of the current device;
    cudaSetDevice of the current device, which the entry no longer makes;
    the launch alone; cudaGetLastError) are timed inside the library
    (``i16_tile_route_us``); ctypes' own cost is a call of an entry that
    does nothing (``i16_route_noop``) with the launch's arguments.  The
    public stream getter, which the route no longer takes, is timed beside
    the raw one.  Launches queue on the current stream and are synchronised
    between pieces."""
    import ctypes
    import time

    from ..ops import _build

    dev = _cuda(device)
    a, b = tile_inputs(dtype, dev)
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    lib = i16_probe._kernel_lib()
    out = torch.empty_like(a)
    packed = dtype == torch.int16
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], a.shape[1] // (2 if packed else 1),
            i16_probe._CODE[op], packed, idx, _build.stream(idx))
    lib_call = LIBRARY[op]
    pieces = {
        "i16_op (the whole wrapper)": lambda: i16_probe.i16_op(a, b, op),
        "library call (whole)": lambda: lib_call(a, b),
        "_check": lambda: i16_probe._check(a, b, op, i16_probe.OPS),
        "is_contiguous and 16-byte alignment": lambda: (a.is_contiguous() and b.is_contiguous()
                                                        and not (a.data_ptr() | b.data_ptr()) & 15),
        "torch.empty_like": lambda: torch.empty_like(a),
        "_kernel_lib()": i16_probe._kernel_lib,
        "_build.stream(index)": lambda: _build.stream(idx),
        "torch.cuda.current_stream(dev).cuda_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "three data_ptr()": lambda: (a.data_ptr(), b.data_ptr(), out.data_ptr()),
        "ctypes call of a no-op entry (9 arguments)": lambda: lib.i16_route_noop(*args),
        "launch counter += 1": lambda: setattr(i16_probe.i16_op, "launches", i16_probe.i16_op.launches),
    }
    split: Dict[str, List[float]] = {name: [] for name in pieces}
    c_names = ("cudaGetDevice", "cudaSetDevice (current device)", "the launch alone (C)", "cudaGetLastError")
    split.update({name: [] for name in c_names})
    us = (ctypes.c_double * 4)()
    for fn in pieces.values():  # warm
        fn()
    torch.cuda.synchronize()
    for _ in range(turns):
        for name, fn in pieces.items():
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            split[name].append((time.perf_counter() - t0) / reps * 1e6)
            torch.cuda.synchronize()
        rc = lib.i16_tile_route_us(*args, reps, us)
        _build.check(rc, lib.i16_probe_error_string, "i16_tile_route_us")
        torch.cuda.synchronize()
        for name, v in zip(c_names, us):
            split[name].append(v)
    return split


def device_split(device="cuda", reps: int = 100) -> Dict[str, Dict[str, float]]:
    """Device microseconds a call of K9's elementwise tiles and of the
    library call of the same op and type, from ``torch.profiler``'s trace
    (``utils.profiling.trace_summary``): one trace an (op, dtype) of
    ``reps`` kernel calls, then ``reps`` library calls.  {"op dtype":
    {"k9_us", "library_us", "k9_kernels", "library_kernels"}}; the kernels
    are the trace's labels."""
    import tempfile

    from ..utils import profiling

    dev = _cuda(device)
    out = {}
    with tempfile.TemporaryDirectory(prefix="probe_i16_") as tmp:
        for dtype in i16_probe.DTYPES:
            a, b = tile_inputs(dtype, dev)
            for op, lib_call in LIBRARY.items():
                i16_probe.i16_op(a, b, op), lib_call(a, b)  # warm
                torch.cuda.synchronize()
                with profiling.trace(tmp, dev) as path:
                    for _ in range(reps):
                        i16_probe.i16_op(a, b, op)
                    for _ in range(reps):
                        lib_call(a, b)
                    torch.cuda.synchronize()
                kernels = profiling.trace_summary(path)["kernel_ms"]
                mine = {k: v for k, v in kernels.items() if "i16_tile_kernel" in k}
                other = {k: v for k, v in kernels.items() if k not in mine}
                out[f"{op} {str(dtype).split('.')[-1]}"] = dict(
                    k9_us=1e3 * sum(mine.values()) / reps, library_us=1e3 * sum(other.values()) / reps,
                    k9_kernels=sorted(mine), library_kernels=sorted(other))
    return out


# One turn of ``route_ab``, run in a subprocess from a checkout's root: the
# elementwise tiles timed as ``run_tiles`` times them, the library calls the
# same way, and ``route_split``.  It names only what every version of this
# tool since the split was first measured has.
ROUTE_TURN = """
import json, torch
from swtpu_torch.tools import probe_i16 as p
from swtpu_torch.tools.roofline import events_ms
ops = tuple(op for op in p.i16_probe.OPS if op != "dp_row")
for dtype in p.i16_probe.DTYPES:  # warm: the first call builds and loads the library
    p.i16_probe.i16_op(*p.tile_inputs(dtype, "cuda"), "max")
torch.cuda.synchronize()
tiles = {f"{r['op']} {r['dtype']}": r["ms"] for r in p.run_tiles(ops=ops)}
lib = {}
for dtype in p.i16_probe.DTYPES:
    a, b = p.tile_inputs(dtype, "cuda")
    for op in ops:
        fn = p.LIBRARY[op]
        fn(a, b)
        lib[f"{op} {str(dtype).split('.')[-1]}"] = events_ms(lambda: fn(a, b), 100)[0]
print("ROUTE_TURN " + json.dumps(dict(tiles_ms=tiles, library_ms=lib, host_us=p.route_split())))
"""


def route_ab(parent: str) -> Dict[str, List[dict]]:
    """The launch route of the package at ``parent`` (a checkout's root)
    against this one's, in turns parent, this, this, parent, each turn a
    fresh process on the card with no profiler before it:
    {"parent": [turn, turn], "this": [turn, turn]}, a turn holding the eight
    elementwise tiles' ms a call (CUDA events over 100 calls, as
    ``run_tiles``), the library calls' the same way, and ``route_split``."""
    import json
    import subprocess
    from pathlib import Path

    here = Path(__file__).resolve().parents[2]
    out: Dict[str, List[dict]] = {"parent": [], "this": []}
    for name, root in (("parent", parent), ("this", here), ("this", here), ("parent", parent)):
        run = subprocess.run([sys.executable, "-c", ROUTE_TURN], cwd=root, capture_output=True, text=True,
                             timeout=600)
        line = [ln for ln in run.stdout.splitlines() if ln.startswith("ROUTE_TURN ")]
        if run.returncode or not line:
            raise RuntimeError(f"route_ab: the {name} turn failed ({run.returncode}):\n{run.stderr[-2000:]}")
        out[name].append(json.loads(line[0].split(" ", 1)[1]))
    return out


def main(argv=()) -> int:
    """``--route-ab PARENT``: ``route_ab`` against the checkout at PARENT,
    printed as JSON; otherwise the tiles, their route's host split, their
    device split and the chains."""
    import argparse

    args = argparse.ArgumentParser(prog="python -m swtpu_torch.tools.probe_i16")
    args.add_argument("--route-ab", metavar="PARENT", help="a checkout's root whose launch route to time against this")
    opts = args.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_i16: no CUDA device: the kernels and rates are the card's", file=sys.stderr)
        return 1
    print(f"device: {card()}")
    if opts.route_ab:
        import json

        print(json.dumps(route_ab(opts.route_ab)))
        return 0
    ok = True
    for r in run_tiles():
        equal = torch.equal(r["out"], r["plain"])
        ok &= equal
        print(f"{r['op']:7s} {r['dtype']}: {'OK' if equal else 'MISMATCH'}  {r['ms'] * 1e3:8.2f} us a tile "
              f"(plain {r['plain_ms'] * 1e3:9.2f} us)")
    for name, v in route_split().items():  # before the profiler: a trace leaves the host slower after it
        print(f"host {name:45s}: " + ", ".join(f"{x:7.3f}" for x in v) + " us a call")
    for name, v in device_split().items():
        print(f"device {name:12s}: K9 {v['k9_us']:6.2f} us a call, library {v['library_us']:6.2f} us "
              f"({', '.join(v['library_kernels'])})")
    for r in measure_chains():
        print(f"chain {r['op']:7s} {r['dtype']}: {r['ops_per_s'] / 1e12:7.2f} T element ops/s "
              f"({r['ms']:.3f} ms a launch; {100 * r['share_of_int32_peak']:.1f}% of the int32 peak "
              f"{INT32_OPS_PER_S / 1e12:.2f})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
