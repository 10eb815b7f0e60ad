"""int8 tensor-core products: the prefilter's coarse counts and K7's MAC-rate probe.

* ``coarse_counts(sig_qs, sig_db)`` -- (Q, n) int32 dot products of Q query
  signatures (Q, dim) against n subject signatures (n, dim), all int8: the
  coarse pass of ``ops.prefilter`` (swtpu leaves it to XLA's ``jnp.dot``,
  ``swtpu/ops/prefilter.py:136``, ``:166``, ``:188``).  Bound by bytes: the
  (n, dim) matrix is read once for all Q queries.
* ``mma_probe(a, b, iters, unroll)`` -- K7, ``tools/roofline.py:65``
  ``measure_mxu_staging``: the max over i < iters, j < unroll of the int32
  product (a ^ int8(i + j)) @ b, (M, 384) x (384, N), on enough warps to fill
  the card.  Bound by tensor-core operations; ``swtpu_torch.tools.roofline``
  turns its time into a MAC rate.

For tensors on the card both launch the hand-written CUDA kernels of
``csrc/int8_mma.cu`` (mma.sync m16n8k32 s8; the coarse pass on a persistent
grid fed by a ring of TMA loads, laid out by ``coarse_grid``; plain C ABI, built by
``_build``); for tensors on the CPU they run their plain versions,
``coarse_counts_plain`` and ``mma_probe_plain``.  A CUDA tensor reaches its
kernel or raises.  Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build

PROBE_K = 384  # K7's depth, a compile-time constant of the probe kernel
# Subject rows a tile and queries a block of the coarse kernel (csrc/int8_mma.cu
# TILE_M, QTILE: its launcher refuses a grid that does not fit them).
COARSE_ROWS, COARSE_QUERIES = 128, 32
PROBE_TILE = (16, 32)  # (rows, columns) of a probe warp's output tile


_kernel_lib = _build.Library(
    "int8_mma",
    int8_mma_coarse_counts_launch=[ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    int8_mma_probe_warps=[ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)],
    int8_mma_probe_launch=[ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)


def _device_of(*tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"inputs on different devices: {[str(t.device) for t in tensors]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the int8 kernels run on CPU or CUDA tensors, not {dev}")
    return dev


# --- coarse counts ---------------------------------------------------------------


def coarse_counts(sig_qs: torch.Tensor, sig_db: torch.Tensor) -> torch.Tensor:
    """(Q, n) int32: sig_qs (Q, dim) int8 times sig_db (n, dim) int8 transposed.

    On the card dim must be a multiple of 32 and both operands contiguous
    and 16-byte aligned (every row then is: its 16-byte loads stay aligned)."""
    if sig_qs.dtype != torch.int8 or sig_db.dtype != torch.int8 or sig_qs.dim() != 2 or sig_db.dim() != 2:
        raise ValueError(f"coarse_counts takes (Q, dim) and (n, dim) int8, got {tuple(sig_qs.shape)} "
                         f"{sig_qs.dtype} and {tuple(sig_db.shape)} {sig_db.dtype}")
    if sig_qs.shape[1] != sig_db.shape[1]:
        raise ValueError(f"signature widths differ: {sig_qs.shape[1]} and {sig_db.shape[1]}")
    if _device_of(sig_qs, sig_db).type == "cpu":
        return coarse_counts_plain(sig_qs, sig_db)
    return _coarse_counts_cuda(sig_qs, sig_db)


coarse_counts.launches = 0  # kernel launches since the count was last set to 0


def _coarse_counts_cuda(sig_qs: torch.Tensor, sig_db: torch.Tensor) -> torch.Tensor:
    (Q, dim), n = sig_qs.shape, sig_db.shape[0]
    if dim % 32:
        raise ValueError(f"the coarse-count kernel takes a signature width that is a multiple of 32, not {dim}")
    for name, t in (("sig_qs", sig_qs), ("sig_db", sig_db)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if max(n, Q) >= 2**31 or Q > 65535 * 32:
        raise ValueError(f"{Q} queries x {n} subjects exceed the kernel's grid")
    dev = sig_db.device
    out = torch.empty(Q, n, dtype=torch.int32, device=dev)
    if Q == 0 or n == 0:
        return out
    lib = _kernel_lib()
    grid = coarse_grid(n, Q, torch.cuda.get_device_properties(dev).multi_processor_count)
    rc = lib.int8_mma_coarse_counts_launch(sig_db.data_ptr(), sig_qs.data_ptr(), out.data_ptr(), n, Q, dim, *grid,
                                           *_build.where(dev))
    _build.check(rc, lib.int8_mma_error_string, "coarse_counts kernel launch")
    coarse_counts.launches += 1
    return out


def coarse_grid(n: int, Q: int, sms: int) -> Tuple[int, int]:
    """(grid_x, grid_y) of the coarse kernel on a card of ``sms`` SMs: one
    block of 32 queries a query group (grid axis y), and a persistent axis x
    of one block an SM (the kernel's shared memory allows no more) shared by
    the groups, at most one a 128-row subject tile; block x walks tiles x,
    x + grid_x, ..."""
    tiles, groups = -(-n // COARSE_ROWS), -(-Q // COARSE_QUERIES)
    return max(1, min(tiles, sms // groups)), groups


def coarse_counts_plain(sig_qs: torch.Tensor, sig_db: torch.Tensor, rows: int = 1 << 16) -> torch.Tensor:
    """Plain PyTorch version, on any device: float64 products, ``rows``
    subjects at a time.  Exact: every partial sum is an integer of
    magnitude at most dim * 128**2, far below 2**53 (and no TF32 mode
    touches float64)."""
    Q, n = sig_qs.shape[0], sig_db.shape[0]
    out = torch.empty(Q, n, dtype=torch.int32, device=sig_db.device)
    q = sig_qs.to(torch.float64)
    for lo in range(0, n, rows):
        out[:, lo : lo + rows] = (q @ sig_db[lo : lo + rows].to(torch.float64).T).to(torch.int32)
    return out


# --- K7: the MAC-rate probe ---------------------------------------------------------


def _check_probe(a: torch.Tensor, b: torch.Tensor, iters: int, unroll: int) -> None:
    if a.dtype != torch.int8 or b.dtype != torch.int8 or a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"mma_probe takes (M, K) and (K, N) int8, got {tuple(a.shape)} {a.dtype} and "
                         f"{tuple(b.shape)} {b.dtype}")
    if iters < 0 or unroll < 0:
        raise ValueError("iters and unroll must be >= 0")


def probe_warps(m: int, n: int, device) -> int:
    """Warps of a probe launch that fill every SM of ``device`` (a CUDA
    device) at the kernel's occupancy, and cover every (16, 32) tile of an
    (m, n) output; every warp computes 16 * 32 * 384 MACs an (i, j) step."""
    lib = _kernel_lib()
    dev = torch.device(device)
    warps = ctypes.c_int(0)
    rc = lib.int8_mma_probe_warps(m, n, _build.where(dev)[0], ctypes.byref(warps))
    _build.check(rc, lib.int8_mma_error_string, "probe occupancy query")
    return warps.value


def mma_probe(a: torch.Tensor, b: torch.Tensor, iters: int, unroll: int = 8, warps: Optional[int] = None) -> torch.Tensor:
    """K7: max(0, max over i < iters, j < unroll of (a ^ int8(i + j)) @ b),
    (M, N) int32.  On the card K must be 384, M a multiple of 16 and N of
    32; ``warps`` (a multiple of 4; ``probe_warps`` when None) sets how many
    warps repeat the tiles, all storing the same values."""
    _check_probe(a, b, iters, unroll)
    if _device_of(a, b).type == "cpu":
        return mma_probe_plain(a, b, iters, unroll)
    (M, K), N = a.shape, b.shape[1]
    if K != PROBE_K or M % PROBE_TILE[0] or N % PROBE_TILE[1] or M == 0 or N == 0:
        raise ValueError(f"the probe kernel takes (M, {PROBE_K}) x ({PROBE_K}, N), M % 16 == N % 32 == 0, "
                         f"got ({M}, {K}) x ({b.shape[0]}, {N})")
    if warps is None:
        warps = probe_warps(M, N, a.device)
    tiles = (M // PROBE_TILE[0]) * (N // PROBE_TILE[1])
    if warps % 4 or warps < tiles:
        raise ValueError(f"warps={warps} must be a multiple of 4 and cover the {tiles} tiles")
    a = a.contiguous()
    bt = b.t().contiguous()
    out = torch.empty(M, N, dtype=torch.int32, device=a.device)
    lib = _kernel_lib()
    rc = lib.int8_mma_probe_launch(a.data_ptr(), bt.data_ptr(), out.data_ptr(), M, N, iters, unroll, warps, *_build.where(a.device))
    _build.check(rc, lib.int8_mma_error_string, "mma_probe kernel launch")
    mma_probe.launches += 1
    return out


mma_probe.launches = 0  # kernel launches since the count was last set to 0


def mma_probe_plain(a: torch.Tensor, b: torch.Tensor, iters: int, unroll: int = 8) -> torch.Tensor:
    """Plain PyTorch version, on any device: one exact float64 product for
    each distinct perturbation int8(s), s = i + j < iters + unroll - 1 (at
    most 256 of them), and their running max from 0."""
    _check_probe(a, b, iters, unroll)
    best = torch.zeros(a.shape[0], b.shape[1], dtype=torch.int32, device=a.device)
    if iters == 0 or unroll == 0:
        return best
    bf = b.to(torch.float64)
    for s in sorted({s & 0xFF for s in range(iters + unroll - 1)}):
        x = torch.tensor(s - 256 if s > 127 else s, dtype=torch.int8, device=a.device)
        best = torch.maximum(best, (torch.bitwise_xor(a, x).to(torch.float64) @ bf).to(torch.int32))
    return best
