"""The device mesh (counterpart of ``swtpu.parallel.mesh``).

A mesh is a tuple of torch devices along one axis.  The model is swtpu's
database sharding: every device holds a contiguous lane shard of every
bucket, queries are replicated, and per-shard results merge on the primary
device (the first of the mesh).  One host thread enqueues every shard's work
on its device's current stream; torch's cross-device copies order
themselves with CUDA events on both devices' streams.

An explicit device list may name one device more than once (``("cpu",) *
8`` in the tests, one card n times in ``chip_smoke.py``): the counterpart of
swtpu's forced host devices.  Such a mesh runs every shard's kernels, the
lane split and the merge for real, but shows no copy between cards and no
scaling.  Without a list the mesh takes distinct cards and raises when there
are fewer than asked for.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

DB_AXIS = "db"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh: ``devices`` in mesh order along ``axis``."""

    devices: Tuple[torch.device, ...]
    axis: str = DB_AXIS

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def primary(self) -> torch.device:
        """The device that gathers the shards' results."""
        return self.devices[0]

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices, each once, in first-seen order."""
        return tuple(dict.fromkeys(self.devices))


def _canonical(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but no CUDA device is available")
        if dev.index >= torch.cuda.device_count():
            raise ValueError(f"device {dev} requested, only {torch.cuda.device_count()} CUDA devices present")
    return dev


def make_mesh(n_devices: Optional[int] = None, axis: str = DB_AXIS, devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh: ``devices`` as given (a device may repeat), or the first
    ``n_devices`` cards, ``cuda:0 ... cuda:n-1`` (default: every card).
    Raises ValueError when n is more than the cards present, or disagrees
    with an explicit list."""
    if devices is not None:
        devs = tuple(_canonical(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"n_devices={n_devices} but {len(devs)} devices given")
        return Mesh(devs, axis)
    present = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = present if n_devices is None else n_devices
    if n < 1:
        raise ValueError(f"requested {n} devices; a mesh needs at least one CUDA device")
    if n > present:
        raise ValueError(f"requested {n} devices, only {present} available")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


def lane_bounds(lanes: int, n: int) -> List[Tuple[int, int]]:
    """[lo, hi) lanes of each of n equal contiguous shards (lanes % n == 0)."""
    if lanes % n:
        raise ValueError(f"{lanes} lanes do not split into {n} equal shards")
    step = lanes // n
    return [(k * step, (k + 1) * step) for k in range(n)]


def shard_lanes(stack: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """A stack as n contiguous shards of its dimension 1, shard k on device
    k (swtpu's ``P(None, axis)`` sharding): a ``(L2, B)`` wave bucket's
    lanes, or a ``(C, rows, ...)`` row group's rows."""
    return tuple(
        stack[:, lo:hi].contiguous().to(dev, non_blocking=True)
        for (lo, hi), dev in zip(lane_bounds(stack.shape[1], mesh.size), mesh.devices)
    )


def replicate(t, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """A tensor (or host array) on every device of the mesh, one per mesh
    position; a device named twice shares one copy."""
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t))
    copies = {dev: t.to(dev, non_blocking=True) for dev in mesh.distinct}
    return tuple(copies[dev] for dev in mesh.devices)


def replicate_tiles(stack: torch.Tensor, bt: int, mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """A ``(L2, B)`` stack tile-major, ``(B / bt, L2, bt)``, replicated to
    every device of the mesh (query-band sharding scores every lane tile on
    every device): tile j is the contiguous ``[j]``, where a column slice of
    the stack is not contiguous.  A device named twice shares one copy."""
    L2, B = stack.shape
    if B % bt:
        raise ValueError(f"{B} lanes are not a whole number of {bt}-lane tiles")
    tiles = stack.reshape(L2, B // bt, bt).permute(1, 0, 2).contiguous()
    return replicate(tiles, mesh)


def on_device(dev: torch.device):
    """The context in which a shard's work is enqueued: ``torch.cuda.device``
    for a card (every kernel entry point sets the thread's CUDA device
    itself, so without it a later call that names no device lands on the
    last shard's card), nothing for the CPU."""
    import contextlib

    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()
