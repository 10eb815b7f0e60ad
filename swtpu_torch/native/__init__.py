"""The port's native host runtime: ctypes bindings of ``csrc/sw_native.cpp``.

Counterpart of ``swtpu.native``, under its names: fused FASTA parse and
encode, the row-major and segment packers of the row path, the transposed
packer of the wavefront path's host buckets, and the prefilter's k-mer
signatures.  ``g++`` builds the library into ``swtpu_torch/build/`` at first
use (``ops/_build.py``; never at import).  Unlike swtpu's module there is no
fallback: a failed build raises with the compiler's output, and every
function returns arrays.  The NumPy twins (``parse_database_plain``,
``pack_batch_plain``, ``gather_wave_stack``, ``pack_segments_plain``,
``database_signatures_plain``) are the plain versions that the tests and
``chip_smoke.py`` hold these to, bit for bit.

Each packer takes an optional ``out`` array (C-contiguous int8 of the
output's shape), so a caller writes straight into a slice of a larger stack.
ctypes releases the interpreter lock during each call.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..ops import _build

_P, _I64, _I8 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int8


_lib = _build.Library(
    "sw_native",
    sw_fasta_record_bound=[ctypes.c_char_p, _I64, _P],
    sw_parse_fasta=[ctypes.c_char_p, _I64, _P, _P, _I64, _P],
    sw_pack_batch=[_P, _P, _I64, _P, _I64, _I64, _I64, _I8, _P],
    sw_pack_segments=[_P, _P, _I64, _P, _P, _I64, _I64, _I64, _I8, _P],
    sw_pack_bucket_T=[_P, _P, _I64, _P, _I64, _I64, _I64, _I8, _P],
    sw_build_signatures=[_P, _P, _I64, _I64, _P, _P],
)


def _call(entry: str, *args) -> None:
    lib = _lib()
    _build.check(getattr(lib, entry)(*args), lib.sw_native_error_string, entry)


def _database(residues: np.ndarray, offsets: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The flat buffer and its offsets as contiguous int8 and int64, checked
    to bound every record the native code may read."""
    residues = np.ascontiguousarray(residues, dtype=np.int8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    if offsets.ndim != 1 or offsets.shape[0] < 1 or offsets[0] < 0 or offsets[-1] > residues.shape[0]:
        raise ValueError(f"offsets of shape {offsets.shape} do not bound a buffer of {residues.shape[0]} residues")
    return residues, offsets


def _out(out: Optional[np.ndarray], shape: Tuple[int, ...]) -> np.ndarray:
    if out is None:
        return np.empty(shape, dtype=np.int8)
    if out.dtype != np.int8 or out.shape != shape or not out.flags.c_contiguous:
        raise ValueError(f"out must be C-contiguous int8 of shape {shape}, got {out.dtype} {out.shape}")
    return out


def parse_fasta_bytes(data: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """Fused parse and encode: FASTA bytes -> (residues int8, offsets int64),
    bit-equal to ``swtpu.native.parse_fasta_bytes`` (record rules in
    ``csrc/sw_native.cpp``)."""
    data = bytes(data)
    max_records = ctypes.c_int64(0)
    _call("sw_fasta_record_bound", data, len(data), ctypes.byref(max_records))
    residues = np.empty(max(len(data), 1), dtype=np.int8)
    offsets = np.empty(max_records.value + 1, dtype=np.int64)
    n_rec = ctypes.c_int64(0)
    _call("sw_parse_fasta", data, len(data), residues.ctypes.data, offsets.ctypes.data, max_records, ctypes.byref(n_rec))
    offsets.resize(n_rec.value + 1, refcheck=False)  # shrunk in place: no copy of the buffers
    residues.resize(int(offsets[-1]), refcheck=False)
    return residues, offsets


def pack_batch_native(
    residues: np.ndarray, offsets: np.ndarray, ids: np.ndarray, rows: int, width: int, pad: int,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(rows, width) int8 row-major batch: member r (``ids`` int32) at row r,
    cut at ``width``, the rest ``pad``."""
    residues, offsets = _database(residues, offsets)
    ids32 = np.ascontiguousarray(ids, dtype=np.int32)
    out = _out(out, (rows, width))
    _call("sw_pack_batch", residues.ctypes.data, offsets.ctypes.data, offsets.shape[0] - 1, ids32.ctypes.data,
          ids32.shape[0], rows, width, pad, out.ctypes.data)
    return out


def pack_segments_native(
    residues: np.ndarray, offsets: np.ndarray, ids: np.ndarray, starts: np.ndarray, width: int, pad: int,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(rows, width) int8 segment-shared rows: ``ids`` (rows, s_max) int64
    (-1 ends a row) at column ``starts`` (rows, s_max) int32, each cut at the
    row's end; ``utils.segpack.SegBatch``'s fields."""
    residues, offsets = _database(residues, offsets)
    ids64 = np.ascontiguousarray(ids, dtype=np.int64)
    starts32 = np.ascontiguousarray(starts, dtype=np.int32)
    if ids64.ndim != 2 or starts32.shape != ids64.shape:
        raise ValueError(f"ids {ids64.shape} and starts {starts32.shape} must be one (rows, s_max) shape")
    rows, s_max = ids64.shape
    out = _out(out, (rows, width))
    _call("sw_pack_segments", residues.ctypes.data, offsets.ctypes.data, offsets.shape[0] - 1, ids64.ctypes.data,
          starts32.ctypes.data, rows, s_max, width, pad, out.ctypes.data)
    return out


def pack_bucket_T_native(
    residues: np.ndarray, offsets: np.ndarray, ids: np.ndarray, l2: int, bpad: int, pad: int,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(l2, bpad) int8 transposed wavefront bucket: member b (``ids`` int32)
    down lane b, cut at ``l2`` rows, the rest ``pad``."""
    residues, offsets = _database(residues, offsets)
    ids32 = np.ascontiguousarray(ids, dtype=np.int32)
    out = _out(out, (l2, bpad))
    _call("sw_pack_bucket_T", residues.ctypes.data, offsets.ctypes.data, offsets.shape[0] - 1, ids32.ctypes.data,
          ids32.shape[0], l2, bpad, pad, out.ctypes.data)
    return out


def build_signatures_native(residues: np.ndarray, offsets: np.ndarray, dim: int, k: int, mix: np.ndarray) -> np.ndarray:
    """(n, dim) int8 k-mer presence signatures with the multipliers ``mix``
    (``ops.prefilter._MIX``).  The library hashes 3-mers only, the
    prefilter's ``K``; any other ``k`` raises."""
    if k != 3:
        raise ValueError(f"the native signatures hash 3-mers only, got k = {k}")
    residues, offsets = _database(residues, offsets)
    mix32 = np.ascontiguousarray(mix, dtype=np.uint32)
    if mix32.shape[0] < 3:
        raise ValueError(f"k = 3 needs 3 multipliers, got {mix32.shape[0]}")
    out = np.empty((offsets.shape[0] - 1, dim), dtype=np.int8)
    _call("sw_build_signatures", residues.ctypes.data, offsets.ctypes.data, offsets.shape[0] - 1, dim,
          mix32.ctypes.data, out.ctypes.data)
    return out
