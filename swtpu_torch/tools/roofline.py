"""Sustained int8 tensor-core and int32 chain rates of the card.

The counterpart of ``tools/roofline.py``'s two rate probes, on the port's
kernels, timed with CUDA events after a warm-up launch:

* ``measure_mxu_staging`` (K7): ``int8_mma.mma_probe``, independent int8
  (128, 384) x (384, 512) dots perturbed by ``a ^ (i + j)`` and max-reduced,
  on enough warps to fill every SM: the sustained mma.sync int8 MAC rate,
  against the 989.5 T MAC/s dense peak of an H100 SXM (1,979 int8 TOPS);
* ``measure_vpu_chain`` (K8): ``vpu_chain.vpu_chain``, the dependent
  ``acc = max(acc + y, x)`` chain on (32, 512) int32 tiles on every SM (K9's
  int32 ``addmax`` chain kernel),
  counted as 2 operations a link, against the int32 peak every int32 bound
  divides by: 132 SMs x 64 lanes x 1.98 GHz issue 16.7 T instructions a
  second, and one instruction (VIADDMNMX, add then max) does at most two
  operations, so 33.5 T ops/s.

Each returns (rate a second, ms a launch, work a launch).  There is no
counterpart of ``measure_wave_kernel``: ``chip_smoke.py`` times the
wavefront kernel at its main path's shapes.  Without a CUDA device the
measurements raise and ``main`` exits 1.

Run: ``python -m swtpu_torch.tools.roofline``
"""

from __future__ import annotations

import subprocess
import sys
from typing import Callable, Tuple, TypeVar

import numpy as np
import torch

from ..ops import int8_mma, vpu_chain

T = TypeVar("T")

INT8_MACS_PER_S = 1979e12 / 2  # dense int8 peak of an H100 SXM at 700 W, in MACs (data sheet)
# 132 SMs x 64 int32 lanes x 1.98 GHz boost, two operations an instruction (a fused add and max)
INT32_OPS_PER_S = 2 * 132 * 64 * 1.98e9


def events_ms(fn: Callable[[], T], reps: int = 1) -> Tuple[float, T]:
    """Mean milliseconds of fn() over ``reps`` back-to-back calls on the
    current stream (CUDA events), and the last call's result."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = None
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, out


def card(check: bool = False) -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them: every
    time a tool prints stands beside them.  Without a reading it returns
    "nvidia-smi: no reading", or with ``check`` raises."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    lines = smi.stdout.strip().splitlines() if smi.returncode == 0 else []
    if not lines and check:
        raise RuntimeError(f"nvidia-smi gave no reading (rc {smi.returncode}): {smi.stderr.strip()}")
    return lines[0] if lines else "nvidia-smi: no reading"


def _cuda(device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"the rate probes measure a CUDA device, not {dev}")
    return dev


def measure_mxu_staging(m: int = 128, k: int = 384, n: int = 512, iters: int = 512, unroll: int = 64,
                        device="cuda", reps: int = 3) -> Tuple[float, float, int]:
    """K7: (sustained int8 MAC/s, ms a launch, MACs a launch) of the probe
    at K7's shape (128, 384) x (384, 512), iters and unroll."""
    dev = _cuda(device)
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-5, 5, (m, k), dtype=np.int8)).to(dev)
    b = torch.from_numpy(rng.integers(0, 2, (k, n), dtype=np.int8)).to(dev)
    warps = int8_mma.probe_warps(m, n, dev)
    int8_mma.mma_probe(a, b, 1, unroll, warps)  # warm: builds and loads the library
    ms, _ = events_ms(lambda: int8_mma.mma_probe(a, b, iters, unroll, warps), reps)
    macs = warps * iters * unroll * int8_mma.PROBE_TILE[0] * int8_mma.PROBE_TILE[1] * k
    return macs / (ms * 1e-3), ms, macs


def measure_vpu_chain(m: int = vpu_chain.ROWS, n: int = 512, iters: int = 65536, device="cuda",
                      reps: int = 3) -> Tuple[float, float, int]:
    """K8: (sustained int32 ops/s, ms a launch, operations a launch) of
    ``iters * UNROLL`` dependent links on a (32, 512) tile in every block."""
    dev = _cuda(device)
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(0, 1000, (m, n), dtype=np.int32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 3, (m, n), dtype=np.int32)).to(dev)
    blocks = vpu_chain.chain_blocks(n, dev)
    vpu_chain.vpu_chain(x, y, 1, blocks)  # warm
    ms, _ = events_ms(lambda: vpu_chain.vpu_chain(x, y, iters, blocks), reps)
    ops = 2 * iters * vpu_chain.UNROLL * m * n * blocks
    return ops / (ms * 1e-3), ms, ops


def main() -> int:
    if not torch.cuda.is_available():
        print("roofline: no CUDA device: the rates are the card's and are not measured elsewhere", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)} (cuda)")
    mxu, mxu_ms, _ = measure_mxu_staging()
    chain, chain_ms, _ = measure_vpu_chain()
    print(f"sustained int8 mma.sync (staging shape): {mxu / 1e12:7.1f} TMAC/s  ({mxu_ms:.3f} ms a launch; "
          f"dense peak {INT8_MACS_PER_S / 1e12:.1f}, {100 * mxu / INT8_MACS_PER_S:.1f}%)")
    print(f"sustained int32 dep-chain (add, max)    : {chain / 1e12:7.2f} Tops/s  ({chain_ms:.3f} ms a launch; "
          f"peak {INT32_OPS_PER_S / 1e12:.2f}, {100 * chain / INT32_OPS_PER_S:.1f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
