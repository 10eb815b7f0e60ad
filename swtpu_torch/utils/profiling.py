"""The program's spans, a ``torch.profiler`` trace of a block, and what
its device events say.

``span(name)`` marks a stretch of the program's host code in a trace:
``record_function(name)`` while a profiler session records, so that the
span lands in the same Chrome trace as the device's kernels and copies, on
one clock; otherwise a shared context that does nothing.  Every span the
program opens is named ``swtpu.<what>``; ``PhaseTimer.phase`` opens one
around each phase it times.
``trace(out_dir, device)`` records CPU activity, and CUDA activity when
``device`` is a CUDA device, over the ``with`` block, marks the block with a
``swtpu.profile`` span and writes one Chrome trace,
``out_dir/swtpu_torch_trace.json`` (the CLI's ``--profile DIR``; swtpu
writes ``jax.profiler``'s layout there instead, D18).
``trace_summary`` reads such a file: its events, its device events (kernels,
copies and fills on the card), the kernel time by name, and the device's
busy share over the ``swtpu.profile`` span.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import Dict

import torch

TRACE_NAME = "swtpu_torch_trace.json"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # the Chrome trace's categories of device work
PROFILE_SPAN = "swtpu.profile"
_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A context that marks its block as ``name`` in a recording profiler's
    trace; with no profiler recording, a shared no-op (an unguarded
    ``record_function`` costs 10-14 us a call even then)."""
    if _recording():
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def trace(out_dir, device):
    """Profile the block; yields the trace's path, written when the block
    ends.  The directory is created.  Whatever the profiler raises, the
    caller sees."""
    from torch.profiler import ProfilerActivity, profile

    path = Path(out_dir) / TRACE_NAME
    path.parent.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with span(PROFILE_SPAN):
            yield path
    prof.export_chrome_trace(str(path))


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


def trace_summary(path) -> Dict:
    """Counts and device time of a Chrome trace: ``events``, ``device_events``,
    ``kernel_ms`` (milliseconds by ``kernel_label``, largest first),
    ``device_ms`` (the sum of every device event), ``window_ms`` (the
    profiled block's ``swtpu.profile`` span; in a trace without one, the
    first device event's start to the last one's end) and ``busy_share``
    (the device events' time inside the window over window_ms: above 1 only
    where events overlap; None without device events)."""
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    kernel_ms: Dict[str, float] = {}
    for e in device:
        if e["cat"] == "kernel":
            label = kernel_label(e["name"])
            kernel_ms[label] = kernel_ms.get(label, 0.0) + e["dur"] / 1e3
    out = dict(events=len(events), device_events=len(device),
               kernel_ms=dict(sorted(kernel_ms.items(), key=lambda kv: -kv[1])),
               device_ms=sum(e["dur"] for e in device) / 1e3, window_ms=0.0, busy_share=None)
    block = next((e for e in events if e["name"] == PROFILE_SPAN), None)
    if block is not None:
        lo = float(block["ts"])
        hi = lo + float(block["dur"])
    elif device:
        lo = min(float(e["ts"]) for e in device)
        hi = max(float(e["ts"]) + float(e["dur"]) for e in device)
    else:
        return out
    out["window_ms"] = (hi - lo) / 1e3
    if device:
        inside = sum(max(0.0, min(hi, float(e["ts"]) + float(e["dur"])) - max(lo, float(e["ts"]))) for e in device)
        out["busy_share"] = inside / 1e3 / max(out["window_ms"], 1e-9)
    return out
