"""Device-memory probing for the residency budget and launch scratch, and
out-of-memory classification.

The budgets honour the card's actual free memory, as reported by
``torch.cuda.mem_get_info``; on the CPU the configured budget stands and
scratch is not capped.  Over a mesh the residency budget counts each
distinct device once: a mesh that names one card four times plans one
card's worth of residency, not four.  ``is_oom`` tells an exhausted device
(the one failure worth retrying with a smaller footprint) from every other
error, and ``reraise_oom`` turns it into an actionable message.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

# Share of free device memory given to resident subjects, and separately to
# the band carry of one batched launch.
SAFETY = 0.35


def device_free_bytes(device: torch.device) -> Optional[int]:
    """Free bytes on a CUDA device, or None for the CPU."""
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    return int(free)


def resident_cell_budget(
    configured: int, devices: Union[torch.device, Sequence[torch.device]], safety: float = SAFETY
) -> int:
    """Residency budget (int8 subject cells) honouring free device memory.

    The packed database costs 1 byte a cell, but each kernel launch also
    takes a band carry of 4 bytes a column-cell of its bucket (8 with
    affine gaps) for each of its queries, so only ``safety`` of free memory
    goes to resident subjects.  ``devices``: one device, or a mesh's; the
    budget is a device's (``configured``, capped by the least free memory
    of the distinct devices) times the count of distinct devices, as swtpu
    multiplies its budget by the mesh size.
    """
    if isinstance(devices, torch.device):
        devices = (devices,)
    distinct = tuple(dict.fromkeys(devices))
    free = [device_free_bytes(d) for d in distinct]
    per_device = configured
    if all(f is not None for f in free):
        per_device = min(configured, int(min(free) * safety))
    return per_device * len(distinct)


def scratch_budget_bytes(device: torch.device, safety: float = SAFETY) -> Optional[int]:
    """Bytes one launch may take for scratch (the band carry of all its
    queries) on ``device``: ``safety`` of its free memory, or None (no cap)
    on the CPU.  Under a mesh each shard's launch asks of its own device."""
    free = device_free_bytes(device)
    return None if free is None else int(free * safety)


def is_oom(exc: BaseException) -> bool:
    """True when ``exc`` is a device memory exhaustion: torch's
    ``torch.cuda.OutOfMemoryError``, a kernel entry point's
    ``cudaErrorMemoryAllocation`` (``ops._build.check`` raises "<what>
    failed: out of memory (2)"), or :func:`reraise_oom`'s own message.
    Every other error, CUDA's included, is not: a deterministic fault must
    not be retried."""
    return isinstance(exc, torch.cuda.OutOfMemoryError) or "out of memory" in str(exc).lower()


def reraise_oom(exc: BaseException, what: str) -> None:
    """Re-raise a device memory exhaustion as an actionable error naming
    ``what`` the caller was doing, and any other exception as it is."""
    if is_oom(exc):
        raise RuntimeError(
            f"device out of memory while {what}; lower SWConfig.device_resident_cells "
            "(or set device_resident=False to stream the database), or reduce max_batch_cells"
        ) from exc
    raise exc
