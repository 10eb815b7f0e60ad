"""Device-memory probing for the residency budget.

The budget honours the card's actual free memory, as reported by
``torch.cuda.mem_get_info``; on the CPU the configured budget stands.
"""

from __future__ import annotations

from typing import Optional

import torch


def device_free_bytes(device: torch.device) -> Optional[int]:
    """Free bytes on a CUDA device, or None for the CPU."""
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    return int(free)


def resident_cell_budget(configured: int, device: torch.device, safety: float = 0.35) -> int:
    """Residency budget (int8 subject cells) honouring free device memory.

    The packed database costs 1 byte a cell, but each kernel launch also
    takes a band carry of 4 bytes a column-cell of its bucket, so only
    ``safety`` of free memory goes to resident subjects.
    """
    free = device_free_bytes(device)
    if free is None:
        return configured
    return min(configured, int(free * safety))
