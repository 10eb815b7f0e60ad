"""A ``torch.profiler`` trace of a span, and what its device events say.

``trace(out_dir, device)`` records CPU activity, and CUDA activity when
``device`` is a CUDA device, over the ``with`` block and writes one Chrome
trace, ``out_dir/swtpu_torch_trace.json`` (the CLI's ``--profile DIR``;
swtpu writes ``jax.profiler``'s layout there instead, D18).
``trace_summary`` reads such a file: its events, its device events (kernels,
copies and fills on the card), the kernel time by name, and the device's
busy share over the window from its first device event to its last.
"""

from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import Dict

import torch

TRACE_NAME = "swtpu_torch_trace.json"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")  # the Chrome trace's categories of device work


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
    ``device_ms`` (the sum of every device event), ``window_ms`` (first
    device event's start to last one's end) and ``busy_share`` (device_ms
    over window_ms: above 1 only where events overlap; None without device
    events)."""
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
    if device:
        start = min(float(e["ts"]) for e in device)
        out["window_ms"] = (max(float(e["ts"]) + float(e["dur"]) for e in device) - start) / 1e3
        out["busy_share"] = out["device_ms"] / max(out["window_ms"], 1e-9)
    return out
