"""K8: the dependent int32 add/max chain, as a rate probe.

Counterpart of ``tools/roofline.py:101`` ``measure_vpu_chain``: ``acc =
max(acc + y, x)`` from ``acc = x`` over a (32, cols) int32 tile, ``iters *
UNROLL`` links, two operations a link.  For tensors on the card
``vpu_chain`` launches the hand-written CUDA kernel of ``csrc/vpu_chain.cu``
on enough blocks to fill every SM (each block computes the same tile), for
tensors on the CPU it runs ``vpu_chain_plain``; a CUDA tensor reaches the
kernel or raises.  ``vpu_chain.launches`` counts launches.  Bound by int32
operations; ``swtpu_torch.tools.roofline`` turns its time into a rate.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

ROWS = 32  # the tile's rows, a compile-time constant of the kernel
UNROLL = 8  # links of one chain a loop body of the kernel
MAX_COLS = 512  # threads a block: one column a thread


def _kernel_lib() -> ctypes.CDLL:
    return _build.load(
        "vpu_chain",
        vpu_chain_full_blocks=[ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
        vpu_chain_launch=[ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
    )


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
    lib = _kernel_lib()
    blocks = ctypes.c_int(0)
    rc = lib.vpu_chain_full_blocks(cols, _build.where(torch.device(device))[0], ctypes.byref(blocks))
    _build.check(rc, lib.vpu_chain_error_string, "vpu_chain occupancy query")
    return blocks.value


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
    if blocks < 1:
        raise ValueError(f"blocks={blocks} must be >= 1")
    x, y = x.contiguous(), y.contiguous()
    out = torch.empty_like(x)
    lib = _kernel_lib()
    rc = lib.vpu_chain_launch(x.data_ptr(), y.data_ptr(), out.data_ptr(), cols, iters, blocks, *_build.where(x.device))
    _build.check(rc, lib.vpu_chain_error_string, "vpu_chain kernel launch")
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
