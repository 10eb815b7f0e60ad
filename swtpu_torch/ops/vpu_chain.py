"""K8: the dependent int32 add/max chain, as a rate probe.

Counterpart of ``tools/roofline.py:101`` ``measure_vpu_chain``: ``acc =
max(acc + y, x)`` from ``acc = x`` over a (32, cols) int32 tile, ``iters *
UNROLL`` links, two operations a link.  For tensors on the card
``vpu_chain`` launches K9's int32 ``addmax`` chain kernel
(``csrc/i16_probe.cu``, ``i16_chain_kernel<I32, ADDMAX>``: one VIADDMNMX a
link) on enough blocks to fill every SM (each block computes the same
tile); for tensors on the CPU it runs ``vpu_chain_plain``; a CUDA tensor
reaches the kernel or raises.  ``vpu_chain.launches`` counts launches.
Bound by int32 operations; ``swtpu_torch.tools.roofline`` turns its time
into a rate.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import i16_probe

ROWS = i16_probe.ROWS  # the tile's rows, a compile-time constant of the kernel
UNROLL = i16_probe.UNROLL  # links of one chain a loop body of the kernel
MAX_COLS = i16_probe.MAX_COLS  # threads a block: one column a thread


def _check(x: torch.Tensor, y: torch.Tensor, iters: int) -> None:
    if x.dtype != torch.int32 or y.dtype != torch.int32 or x.dim() != 2 or x.shape != y.shape:
        raise ValueError(f"vpu_chain takes two equal (32, cols) int32 tiles, got {tuple(x.shape)} {x.dtype} "
                         f"and {tuple(y.shape)} {y.dtype}")
    if x.device != y.device or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"vpu_chain runs on CPU or CUDA tensors on one device, not {x.device} and {y.device}")
    if iters < 0:
        raise ValueError("iters must be >= 0")


def chain_blocks(cols: int, device) -> int:
    """Blocks of ``cols`` threads that fill every SM of ``device`` (a CUDA
    device) at the kernel's occupancy."""
    return i16_probe.chain_blocks(cols, "addmax", torch.int32, device)


def vpu_chain(x: torch.Tensor, y: torch.Tensor, iters: int, blocks: Optional[int] = None) -> torch.Tensor:
    """``iters * UNROLL`` links of acc = max(acc + y, x) from acc = x, (32,
    cols) int32.  On the card cols <= 512; ``blocks`` (``chain_blocks`` when
    None) sets how many blocks repeat the tile."""
    _check(x, y, iters)
    if x.device.type == "cpu":
        return vpu_chain_plain(x, y, iters)
    rows, cols = x.shape
    if rows != ROWS or not 0 < cols <= MAX_COLS:
        raise ValueError(f"the chain kernel takes a ({ROWS}, cols) tile with 0 < cols <= {MAX_COLS}, got {tuple(x.shape)}")
    if blocks is None:
        blocks = chain_blocks(cols, x.device)
    out = i16_probe.launch_chain(x.contiguous(), y.contiguous(), "addmax", torch.int32, iters, blocks)
    vpu_chain.launches += 1
    return out


vpu_chain.launches = 0  # kernel launches since the count was last set to 0


def vpu_chain_plain(x: torch.Tensor, y: torch.Tensor, iters: int) -> torch.Tensor:
    """Plain PyTorch version, on any device: the same links, one tensor
    operation pair each."""
    _check(x, y, iters)
    acc = x.clone()
    for _ in range(iters * UNROLL):
        acc = torch.maximum(acc + y, x)
    return acc
