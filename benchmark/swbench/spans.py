"""The program's own spans in a trace, and the time they hold.

``swtpu_torch`` marks its host code with ``swtpu.<phase>`` spans
(``swtpu_torch.utils.profiling.span``) while a profiler records; they land
among ``Trace.host``'s events, on the device events' clock.  A program
without them leaves none, and every reader of them then reads nothing
(None), never 0.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional

from .trace import Interval, Trace, merged

PREFIX = "swtpu."


def window_spans(trace: Optional[Trace], *names: str) -> Optional[List[Interval]]:
    """The spans named ``swtpu.<name>`` in the traced window, clipped to it;
    None when there is no trace or it holds no ``swtpu.`` span at all."""
    if trace is None or not any(name.startswith(PREFIX) for _, _, name in trace.host):
        return None
    lo, hi = trace.window()
    want = {PREFIX + n for n in names}
    return [(max(a, lo), min(b, hi)) for a, b, name in trace.host if name in want and b > lo and a < hi]


def roots(intervals: List[Interval]) -> List[Interval]:
    """The intervals that lie inside no other one of the list: a nested
    search (the prefilter's exhaustive one) is not a second search."""
    out: List[Interval] = []
    for a, b in sorted(intervals, key=lambda iv: (iv[0], -iv[1])):
        if not out or b > out[-1][1]:
            out.append((a, b))
    return out


def held_us(intervals: List[Interval]) -> float:
    """Microseconds of the intervals' union: a span nested in another of
    them counts once."""
    return sum(b - a for a, b in merged(intervals))


def idle_us(trace: Trace, intervals: List[Interval]) -> float:
    """Microseconds of the intervals' union in which no device operation
    ran."""
    return sum((b - a) - trace.busy(a, b) for a, b in merged(intervals))


def per_root_ms(us: float, roots_: List[Interval]) -> Optional[float]:
    """``us`` over the number of roots, in milliseconds; None without one."""
    return us * 1e-3 / len(roots_) if roots_ else None


def self_times(trace: Optional[Trace]) -> Optional[Dict[str, List[float]]]:
    """{label: [wall ms, idle ms]} over the traced window, largest idle
    first: each stretch of the window goes to the innermost ``swtpu.``
    span open in it (its self time), or to ``(request, no span)`` or
    ``(between requests)``; idle is the stretch less the time a device
    operation ran in it.  None where ``window_spans`` reads nothing."""
    if window_spans(trace) is None:
        return None
    lo, hi = trace.window()
    sw = sorted(((a, b, n) for a, b, n in trace.host if n.startswith(PREFIX) and b > lo and a < hi),
                key=lambda s: (s[0], -s[1]))  # an outer span before one it holds that opens with it
    reqs = merged(trace.requests, lo, hi)
    req_starts = [a for a, _ in reqs]
    cuts = sorted({lo, hi, *(x for a, b, _ in sw for x in (a, b) if lo < x < hi), *(x for iv in reqs for x in iv)})
    by: Dict[str, List[float]] = {}
    stack: list = []
    k = 0
    for a, b in zip(cuts[:-1], cuts[1:]):
        m = (a + b) / 2
        while k < len(sw) and sw[k][0] <= m:
            stack.append(sw[k])
            k += 1
        stack = [s for s in stack if s[1] > m]
        if stack:
            label = stack[-1][2]  # the latest to open is the innermost
        else:
            j = bisect.bisect_right(req_starts, m) - 1
            label = "(request, no span)" if j >= 0 and m < reqs[j][1] else "(between requests)"
        wall_idle = by.setdefault(label, [0.0, 0.0])
        wall_idle[0] += (b - a) * 1e-3
        wall_idle[1] += ((b - a) - trace.busy(a, b)) * 1e-3
    return dict(sorted(by.items(), key=lambda kv: -kv[1][1]))
