"""What a ``torch.profiler`` trace of the measured window says.

The harness marks the window (``bench.window``) and each request
(``bench.request``) with ``record_function``; the profiler's Chrome trace
puts those host spans and the device's events (kernels, copies, fills) on
one clock.  Everything here is arithmetic on intervals: unions clipped to a
span, idle gaps between device events, and what the host was doing in each
gap (the innermost host event open at its midpoint).
"""

from __future__ import annotations

import bisect
import json
from itertools import accumulate
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
WINDOW, REQUEST = "bench.window", "bench.request"

Interval = Tuple[float, float]


def kernel_label(name: str) -> str:
    """A kernel's trace name without its return type, anonymous namespaces
    and parameter list: ``sw_wave_kernel<false, false, 16>``."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    depth = 0
    for k, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0:
            return name[:k]
    return name


def merged(intervals: Sequence[Interval], lo: float = float("-inf"), hi: float = float("inf")) -> List[Interval]:
    """The union of ``intervals`` clipped to [lo, hi], as sorted disjoint
    intervals."""
    out: List[Interval] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def gaps(busy: List[Interval], lo: float, hi: float) -> List[Interval]:
    """The stretches of [lo, hi] that ``busy`` (merged) leaves open."""
    out, t = [], lo
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


class Cover:
    """Sorted disjoint intervals, with the time they cover inside any span
    in logarithmic time."""

    def __init__(self, intervals: Sequence[Interval]):
        self.iv = merged(intervals)
        self.starts = [a for a, _ in self.iv]
        self.ends = [b for _, b in self.iv]
        self.prefix = [0.0, *accumulate(b - a for a, b in self.iv)]

    def __call__(self, lo: float, hi: float) -> float:
        if hi <= lo or not self.iv:
            return 0.0
        i = bisect.bisect_right(self.ends, lo)  # first interval ending after lo
        j = bisect.bisect_left(self.starts, hi)  # intervals [i, j) start before hi
        if j <= i:
            return 0.0
        total = self.prefix[j] - self.prefix[i]
        total -= max(0.0, lo - self.starts[i])
        total -= max(0.0, self.ends[j - 1] - hi)
        return total


class Trace:
    """A Chrome trace's device events and host spans, in microseconds."""

    def __init__(self, events: List[dict]):
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        iv = lambda e: (float(e["ts"]), float(e["ts"]) + float(e["dur"]))  # noqa: E731
        self.device = [(*iv(e), e["name"], e["cat"]) for e in xs if e.get("cat") in DEVICE_CATS]
        self.kernels = [d for d in self.device if d[3] == "kernel"]
        self._busy = Cover([(a, b) for a, b, *_ in self.device])
        self._kernel_busy = Cover([(a, b) for a, b, *_ in self.kernels])
        spans = [e for e in xs if e.get("cat") == "user_annotation"]
        self.window_spans = [iv(e) for e in spans if e["name"] == WINDOW]
        self.requests = [iv(e) for e in spans if e["name"] == REQUEST]
        tid = next((e.get("tid") for e in spans if e["name"] == WINDOW), None)
        self.host = sorted(
            (*iv(e), e["name"]) for e in xs if e.get("cat") in HOST_CATS and e.get("tid") == tid
        )

    @classmethod
    def from_file(cls, path: Path) -> "Trace":
        return cls(json.loads(Path(path).read_text())["traceEvents"])

    def window(self) -> Interval:
        if not self.window_spans:
            raise ValueError(f"the trace holds no {WINDOW} span")
        return self.window_spans[0]

    def busy(self, lo: float, hi: float, kernels_only: bool = False) -> float:
        return (self._kernel_busy if kernels_only else self._busy)(lo, hi)

    def device_ops(self, lo: float, hi: float, top: int = 10) -> List[list]:
        """[[label, seconds]] of the device operations that took most time
        in [lo, hi], by kernel label."""
        by: Dict[str, float] = {}
        for a, b, name, cat in self.device:
            d = min(b, hi) - max(a, lo)
            if d > 0:
                label = kernel_label(name) if cat == "kernel" else name
                by[label] = by.get(label, 0.0) + d * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, lo: float, hi: float, top: int = 10) -> List[list]:
        """[[what the host was doing, seconds]]: the device's idle time in
        [lo, hi], summed by the innermost host event open at each gap's
        midpoint (``between requests: ...`` outside every request; the
        program's own Python and NumPy, which the trace does not break
        down, as ``host code outside any torch op``)."""
        open_gaps = gaps(merged(self._busy.iv, lo, hi), lo, hi)
        mids = sorted(((a + b) / 2, b - a) for a, b in open_gaps)
        by: Dict[str, float] = {}
        stack: List[Tuple[float, float, str]] = []
        k = 0
        for m, length in mids:
            while k < len(self.host) and self.host[k][0] <= m:
                ev = self.host[k]
                while stack and stack[-1][1] < ev[0]:
                    stack.pop()
                stack.append(ev)
                k += 1
            while stack and stack[-1][1] < m:
                stack.pop()
            inner = stack[-1][2] if stack else "no host event"
            in_request = any(name == REQUEST for _, _, name in stack)
            if inner in (REQUEST, WINDOW):
                inner = "host code outside any torch op"
            label = inner if in_request else f"between requests: {inner}"
            by[label] = by.get(label, 0.0) + length * 1e-6
        return [[k2, v] for k2, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def request_host_ms(self) -> List[float]:
        """Each request's wall time less the device's busy time inside it,
        in milliseconds."""
        return [((b - a) - self.busy(a, b)) * 1e-3 for a, b in self.requests]
