"""K9: packed int16 against int32 elementwise ops, on tiles and as rate chains.

Counterpart of ``tools/probe_i16.py:32`` ``run``: the five ops of its
kernels (``k_max``, ``k_add``, ``k_sub``, ``k_select``, ``k_dp_row``) on a
(rows, cols) int16 or int32 tile, exactly as the JAX functions compute them,
int16 wrapping as JAX's does.  On the card int16 runs as packed pairs
(``__vmaxs2``, ``__vadd2``, ``__vsub2``, ``__vcmplts2``).  ``i16_chain``
times each op in a dependent chain (``acc = op(acc, y)``, and the SW cell's
fused ``addmax`` = max(acc + y, x) and ``max3`` = max(acc, y, x), DPX for
int16).  Its int32 ``addmax`` chain is also K8's kernel: ``vpu_chain``
launches it through ``launch_chain``.

For tensors on the card ``i16_op`` and ``i16_chain`` launch the hand-written
CUDA kernels of ``csrc/i16_probe.cu``; for tensors on the CPU they run
``i16_op_plain`` and ``i16_chain_plain``; a CUDA tensor reaches a kernel or
raises.  ``i16_op.launches`` and ``i16_chain.launches`` count launches.

``i16_op``'s tile is small enough that its device time is about a
microsecond, so its route to the launch is kept short: the library's entry
points are bound once (``_build.Library``), the device index and the
current stream are read raw (``_build.stream``), the tiles go to the kernel
as they are (contiguous and 16-byte aligned, else copied), and the kernel
(one of ``TILE_INSTANCES``) is picked in C.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

OPS = ("max", "add", "sub", "select", "dp_row")  # probe_i16's five kernels
CHAIN_OPS = ("max", "add", "sub", "select", "addmax", "max3")
_CODE = {"max": 0, "add": 1, "sub": 2, "select": 3, "dp_row": 4, "addmax": 5, "max3": 6}
# Elementwise operations an element: select is a compare and a select; dp_row
# an add, two max and a subtract, then three Kogge-Stone max (shifts are not
# counted); addmax and max3 two each.
OPS_PER_ELEMENT = {"max": 1, "add": 1, "sub": 1, "select": 2, "dp_row": 7, "addmax": 2, "max3": 2}
DTYPES = (torch.int16, torch.int32)
ROWS = 32  # a chain tile's rows, a compile-time constant of the kernel
UNROLL = 8  # links of one chain a loop body of the kernel
MAX_COLS = 512  # a chain block's threads: one column of 32-bit words a thread
# The tile kernel's ten instantiations, i16_tile_kernel<type, op>: (op, dtype).
TILE_INSTANCES = tuple((op, dtype) for dtype in DTYPES for op in OPS)


_kernel_lib = _build.Library(
    "i16_probe",
    i16_tile_launch=[ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    i16_chain_full_blocks=[ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)],
    i16_chain_launch=[ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    i16_route_noop=[ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    i16_tile_route_us=[ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p, ctypes.c_int,
                                                                  ctypes.POINTER(ctypes.c_double)],
)


def _check(a: torch.Tensor, b: torch.Tensor, op: str, ops) -> torch.device:
    """Validate two tiles for ``op``; returns their device."""
    if op not in ops:
        raise ValueError(f"op must be one of {ops}, got {op!r}")
    dtype, shape = a.dtype, a.shape
    if dtype not in DTYPES or dtype != b.dtype or len(shape) != 2 or shape != b.shape:
        raise ValueError(f"two equal 2-D int16 or int32 tiles, got {tuple(shape)} {dtype} and "
                         f"{tuple(b.shape)} {b.dtype}")
    if dtype == torch.int16 and shape[1] % 2:
        raise ValueError(f"an int16 tile needs an even column count (packed pairs), got {shape[1]}")
    dev = a.device
    if dev != b.device or dev.type not in ("cpu", "cuda"):
        raise ValueError(f"CPU or CUDA tensors on one device, not {dev} and {b.device}")
    return dev


def _words(t: torch.Tensor) -> torch.Tensor:
    """The tile as (rows, 32-bit words): int16 pairs share a word, column 2w
    in its low half."""
    return t.contiguous().view(torch.int32)


def i16_op(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """One of ``OPS`` on two equal (rows, cols) int16 or int32 tiles."""
    dev = _check(a, b, op, OPS)
    if dev.type == "cpu":
        return i16_op_plain(a, b, op)
    rows, cols = a.shape
    if rows == 0 or cols == 0:
        raise ValueError(f"the tile kernel takes a non-empty tile, got {tuple(a.shape)} {a.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()) or (a.data_ptr() | b.data_ptr()) & 15:
        a, b = a.clone(memory_format=torch.contiguous_format), b.clone(memory_format=torch.contiguous_format)
    packed = a.dtype == torch.int16
    out = torch.empty_like(a)  # a is contiguous, so out is
    lib = _kernel_lib()
    rc = lib.i16_tile_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), rows, cols // 2 if packed else cols,
                             _CODE[op], packed, dev.index, _build.stream(dev.index))
    if rc:
        _build.check(rc, lib.i16_probe_error_string, "i16_op kernel launch")
    i16_op.launches += 1
    return out


i16_op.launches = 0  # kernel launches since the count was last set to 0


def _wrap(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int64 values wrapped to int16 or int32, two's complement."""
    half = 1 << (15 if dtype == torch.int16 else 31)
    return (x + half) % (2 * half) - half


def _shift(t: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """Columns shifted right by k, ``fill`` in the first k."""
    cols = t.shape[1]
    pad = torch.full((t.shape[0], min(k, cols)), fill, dtype=t.dtype, device=t.device)
    return torch.cat([pad, t[:, : max(cols - k, 0)]], dim=1)


def i16_op_plain(a: torch.Tensor, b: torch.Tensor, op: str) -> torch.Tensor:
    """Plain PyTorch version, on any device: int64 arithmetic, each add and
    subtract wrapped back to the tile's type."""
    _check(a, b, op, OPS)
    x, y = a.long(), b.long()
    if op == "max":
        r = torch.maximum(x, y)
    elif op == "add":
        r = _wrap(x + y, a.dtype)
    elif op == "sub":
        r = _wrap(x - y, a.dtype)
    elif op == "select":
        r = torch.where(x < y, y, x)
    else:  # dp_row
        d = _shift(x, 1, -2)
        r = torch.maximum(torch.maximum(y, _wrap(d + y, a.dtype)), _wrap(x - 2, a.dtype))
        for k in (1, 2, 4):
            r = torch.maximum(r, _shift(r, k, -32768))
    return r.to(a.dtype)


def _check_chain(x: torch.Tensor, y: torch.Tensor, op: str, iters: int) -> None:
    _check(x, y, op, CHAIN_OPS)
    if iters < 0:
        raise ValueError("iters must be >= 0")


def chain_blocks(cols: int, op: str, dtype: torch.dtype, device) -> int:
    """Blocks of ``cols`` threads of the (op, dtype) chain that fill every SM
    of ``device`` (a CUDA device) at the kernel's occupancy."""
    lib = _kernel_lib()
    blocks = ctypes.c_int(0)
    rc = lib.i16_chain_full_blocks(cols, _CODE[op], int(dtype == torch.int16), _build.where(torch.device(device))[0],
                                   ctypes.byref(blocks))
    _build.check(rc, lib.i16_probe_error_string, "i16_chain occupancy query")
    return blocks.value


def i16_chain(x: torch.Tensor, y: torch.Tensor, op: str, iters: int, blocks: Optional[int] = None) -> torch.Tensor:
    """``iters * UNROLL`` links of acc = op(acc, y) (``addmax`` and ``max3``
    also take x) from acc = x, on (32, cols) int32 or (32, 2 * cols) int16
    tiles.  On the card cols <= 512 words; ``blocks`` (``chain_blocks`` when
    None) sets how many blocks repeat the tile."""
    _check_chain(x, y, op, iters)
    if x.device.type == "cpu":
        return i16_chain_plain(x, y, op, iters)
    xw, yw = _words(x), _words(y)
    rows, cols = xw.shape
    if rows != ROWS or not 0 < cols <= MAX_COLS:
        raise ValueError(f"the chain kernel takes {ROWS} rows of 1 to {MAX_COLS} words, got {tuple(x.shape)} {x.dtype}")
    if blocks is None:
        blocks = chain_blocks(cols, op, x.dtype, x.device)
    out = launch_chain(xw, yw, op, x.dtype, iters, blocks)
    i16_chain.launches += 1
    return out.view(x.dtype)


i16_chain.launches = 0  # kernel launches since the count was last set to 0


def launch_chain(xw: torch.Tensor, yw: torch.Tensor, op: str, dtype: torch.dtype, iters: int,
                 blocks: int) -> torch.Tensor:
    """One launch of the (op, dtype) chain kernel on (32, cols) tiles of
    contiguous 32-bit words on the card, uncounted: the caller's wrapper
    (``i16_chain``, K8's ``vpu_chain.vpu_chain``) counts it."""
    if blocks < 1:
        raise ValueError(f"blocks={blocks} must be >= 1")
    out = torch.empty_like(xw)
    lib = _kernel_lib()
    rc = lib.i16_chain_launch(xw.data_ptr(), yw.data_ptr(), out.data_ptr(), xw.shape[1], iters, blocks, _CODE[op],
                              int(dtype == torch.int16), *_build.where(xw.device))
    _build.check(rc, lib.i16_probe_error_string, "i16_chain kernel launch")
    return out


def i16_chain_plain(x: torch.Tensor, y: torch.Tensor, op: str, iters: int) -> torch.Tensor:
    """Plain PyTorch version, on any device: the same links in int64, each
    add wrapped back to the tile's type."""
    _check_chain(x, y, op, iters)
    xs, ys, acc = x.long(), y.long(), x.long()
    for _ in range(iters * UNROLL):
        if op == "max":
            acc = torch.maximum(acc, ys)
        elif op == "add":
            acc = _wrap(acc + ys, x.dtype)
        elif op == "sub":
            acc = _wrap(acc - ys, x.dtype)
        elif op == "select":
            acc = torch.where(acc < ys, ys, acc)
        elif op == "addmax":
            acc = torch.maximum(_wrap(acc + ys, x.dtype), xs)
        else:  # max3
            acc = torch.maximum(torch.maximum(acc, ys), xs)
    return acc.to(x.dtype)
