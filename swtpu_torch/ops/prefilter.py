"""Heuristic k-mer prefilter: an int8 coarse pass feeding the exact engine.

Counterpart of ``swtpu.ops.prefilter`` (an optional subsystem beyond the
reference, which scores every subject; off unless ``SWConfig.prefilter`` is
set):

* every sequence is summarised once as a (DIM,) int8 presence signature of
  its hashed k-mers (k = 3, DIM = 1024), cached per database: built on the
  card from the resident residues (``database_signatures_cuda``, the CUDA
  kernel of ``csrc/kmer_signatures.cu``), or on the host by one native pass
  over the flat residue buffer (swtpu_torch.native);
* the coarse score of query q against subject s starts from the number of
  hashed k-mer buckets they share, ``sig_s . sig_q``: the whole database is
  one (Q, DIM) x (n, DIM)^T int8 product, ``int8_mma.coarse_counts`` (on the
  card the CUDA kernel of ``csrc/int8_mma.cu``);
* candidates are ranked by the binomial z-score ``(c - E) * rsqrt(max(E,
  1))`` with ``E = qk * popcount(sig_s) / DIM`` (float32, written as swtpu
  writes it), which removes the raw count's length bias, and by the raw
  count; the top ids of each signal merge round-robin into the candidate
  set that the engine scores exactly.

Rankings break ties by the lowest id, as ``lax.top_k`` does, through a
stable descending sort.  ``gather_stack`` packs a candidate bucket on the
device straight from the resident residue buffer, byte for byte the layout
``sw_wave`` takes.  The coarse pass is a heuristic: a true top-K member
outside the candidate set is missed; every reported score is exact.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from .. import native
from . import _build, int8_mma
from .profile import PAD_SUBJECT
from .wave_sw import W

# Hash-space size: a ~400-aa subject marks <= ~40% of the buckets, and the
# SwissProt signature matrix stays modest (559k x 1024 int8 = 573 MB).
DIM = 1024
K = 3  # k-mer length

# Odd 32-bit mixing constants; uint32 wrap-around is the hash.  Distinct
# multipliers per position keep permuted k-mers distinct.
_MIX = np.array([2654435761, 2246822519, 3266489917], dtype=np.uint32)


def kmer_hashes(residues: np.ndarray, dim: int = DIM, k: int = K) -> np.ndarray:
    """Hash bucket of every k-mer window of one encoded sequence."""
    r = np.asarray(residues, dtype=np.uint32)
    if r.shape[0] < k:
        return np.zeros((0,), dtype=np.int64)
    acc = np.zeros(r.shape[0] - k + 1, dtype=np.uint32)
    for j in range(k):
        acc += r[j : r.shape[0] - k + 1 + j] * _MIX[j]
    # Low bits of a multiplicative hash are the weakest: fold in high bits.
    return ((acc >> np.uint32(20)) ^ acc).astype(np.int64) & (dim - 1)


def signature(residues: np.ndarray, dim: int = DIM, k: int = K) -> np.ndarray:
    """(dim,) int8 presence signature of one sequence."""
    sig = np.zeros((dim,), dtype=np.int8)
    sig[kmer_hashes(residues, dim, k)] = 1
    return sig


def database_signatures(db, dim: int = DIM, k: int = K) -> np.ndarray:
    """(n, dim) int8 presence signatures for a whole database: one native
    pass over the flat residue buffer with this module's ``_MIX``."""
    return native.build_signatures_native(db.residues, db.offsets, dim, k, _MIX)


_signature_lib = _build.Library(
    "kmer_signatures",
    kmer_signatures_launch=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_uint] * 3
    + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p],
)


def database_signatures_cuda(residues: torch.Tensor, offsets: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """((n, DIM) int8 signatures, (n,) int32 popcounts) of the database
    whose int8 residues and (n + 1,) int64 offsets are on the card, built
    there by ``csrc/kmer_signatures.cu`` (DIM and K compiled in): byte for
    byte :func:`database_signatures`, and no host copy of the index."""
    if residues.dtype != torch.int8 or offsets.dtype != torch.int64 or residues.dim() != 1 or offsets.dim() != 1:
        raise ValueError(f"residues must be 1-D int8 and offsets 1-D int64, got {residues.dtype} {tuple(residues.shape)} "
                         f"and {offsets.dtype} {tuple(offsets.shape)}")
    if offsets.numel() < 1:
        raise ValueError("offsets must hold n + 1 >= 1 entries, got none")
    if residues.device != offsets.device or residues.device.type != "cuda":
        raise ValueError(f"the signature kernel takes tensors on one CUDA device, not {residues.device}, {offsets.device}")
    residues, offsets = residues.contiguous(), offsets.contiguous()
    n = offsets.numel() - 1
    if n:  # every record inside the buffer, none ending before it starts (one sync, once a database)
        lo, hi = offsets[:-1], offsets[1:]
        if bool(((hi < lo) | (lo < 0) | (hi > residues.numel())).any()):
            raise ValueError(f"offsets do not bound records inside a buffer of {residues.numel()} residues")
    sig = torch.empty(n, DIM, dtype=torch.int8, device=residues.device)
    pop = torch.empty(n, dtype=torch.int32, device=residues.device)
    lib = _signature_lib()
    rc = lib.kmer_signatures_launch(residues.data_ptr(), offsets.data_ptr(), n, *(int(m) for m in _MIX),
                                    sig.data_ptr(), pop.data_ptr(), *_build.where(residues.device))
    _build.check(rc, lib.kmer_signatures_error_string, "kmer_signatures kernel launch")
    database_signatures_cuda.launches += 1
    return sig, pop


database_signatures_cuda.launches = 0  # kernel launches since the count was last set to 0


def database_signatures_plain(db, dim: int = DIM, k: int = K, chunk: int = 1 << 24) -> np.ndarray:
    """NumPy version of :func:`database_signatures`.

    Vectorised over the flat residue buffer: every position's record comes
    from the offsets, k-mers that would straddle a record boundary are
    masked out, and presence bits are scattered with one flat assignment
    per chunk of ``chunk`` positions (~24 bytes of temporaries each).
    """
    n = db.n
    sig = np.zeros((n, dim), dtype=np.int8)
    total = db.length_sum
    if total < k or n == 0:
        return sig
    flat = np.asarray(db.residues, dtype=np.uint32)
    offsets = np.asarray(db.offsets, dtype=np.int64)
    lengths = db.lengths
    rec_of = np.repeat(np.arange(n, dtype=np.int64), lengths)
    # A flat position starts a k-mer unless it lies in the last k-1
    # positions of its record, marked straight off the offsets.
    n_starts = total - k + 1
    valid_all = np.ones(n_starts, dtype=bool)
    for j in range(1, k):
        idx = offsets[1:][lengths >= j] - j
        valid_all[idx[idx < n_starts]] = False
    sig_flat = sig.reshape(-1)
    for lo in range(0, n_starts, chunk):
        hi = min(lo + chunk, n_starts)
        acc = np.zeros(hi - lo, dtype=np.uint32)
        for j in range(k):
            acc += flat[lo + j : hi + j] * _MIX[j]
        v = valid_all[lo:hi]
        h = (((acc >> np.uint32(20)) ^ acc).astype(np.int64) & (dim - 1))[v]
        sig_flat[rec_of[lo:hi][v] * dim + h] = 1
    return sig


# --- the coarse pass ------------------------------------------------------------------


def coarse_scores(sig_db: torch.Tensor, sig_q: torch.Tensor) -> torch.Tensor:
    """(n,) int32 shared-bucket counts of one query signature."""
    return int8_mma.coarse_counts(sig_q.to(torch.int8)[None], sig_db)[0]


def _zscores(counts: torch.Tensor, popcounts: torch.Tensor, sig_qs: torch.Tensor, dim: int) -> torch.Tensor:
    """(Q, n) float32 z-scores of (Q, n) counts, in swtpu's float32 steps."""
    qk = sig_qs.to(torch.float32).sum(dim=1, keepdim=True)  # (Q, 1)
    e = qk * popcounts.to(torch.float32)[None, :] / dim
    return (counts.to(torch.float32) - e) * torch.rsqrt(torch.clamp_min(e, 1.0))


def coarse_zscores(sig_db: torch.Tensor, popcounts: torch.Tensor, sig_q: torch.Tensor) -> torch.Tensor:
    """(n,) float32 length-corrected coarse scores (the ranking signal): the
    binomial z-score of the shared-bucket count against the chance overlap
    E = qk * popcount_s / DIM.  ``popcounts``: the (n,) signature popcounts."""
    q = sig_q.to(torch.int8)[None]
    return _zscores(int8_mma.coarse_counts(q, sig_db), popcounts, q, sig_db.shape[1])[0]


def _top_ids(x: torch.Tensor, n_cand: int) -> torch.Tensor:
    """Ids of the n_cand largest values along the last axis, descending,
    equal values by ascending id (``lax.top_k``'s order): a stable sort."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :n_cand]


def candidates_from_counts(
    counts: torch.Tensor, popcounts: torch.Tensor, sig_qs: torch.Tensor, n_cand: int
) -> torch.Tensor:
    """The ranking half of the coarse pass: (Q, 3, n_cand) int64 from the
    (Q, n) counts ``int8_mma.coarse_counts(sig_qs, sig_db)`` of the (Q, DIM)
    int8 query signatures: [q, 0] z-ranked ids, [q, 1] raw-ranked ids,
    [q, 2] the max raw count (the engine's no-signal check), swtpu's packed
    layout (``swtpu.ops.prefilter.coarse_candidates_many``)."""
    z = _zscores(counts, popcounts, sig_qs, sig_qs.shape[1])
    z_ids, r_ids = _top_ids(z, n_cand), _top_ids(counts, n_cand)
    mx = counts.amax(dim=1, keepdim=True).to(torch.int64).expand_as(z_ids)
    return torch.stack([z_ids, r_ids, mx], dim=1)


# --- candidates and their bucket ---------------------------------------------------------


def gather_stack(flat: torch.Tensor, offsets: torch.Tensor, cand: torch.Tensor, width: int) -> torch.Tensor:
    """(width + W, bpad) int8 transposed candidate bucket on ``flat``'s device.

    ``flat``/``offsets`` are the database's residue buffer and record
    offsets, resident once per database, so a rescore uploads only the
    (bpad,) id vector ``cand``, padded with -1: pad lanes read length 0.
    Columns past a subject's length and the trailing W columns hold
    PAD_SUBJECT: ``pack_wave_group``'s layout with one subject a lane.
    """
    safe = cand.clamp_min(0)
    starts = offsets[safe]
    lens = torch.where(cand >= 0, offsets[safe + 1] - starts, 0)
    pos = torch.arange(width, dtype=starts.dtype, device=flat.device)[:, None]  # (width, 1)
    stack = torch.full((width + W, cand.shape[0]), PAD_SUBJECT, dtype=torch.int8, device=flat.device)
    if flat.shape[0]:
        src = (starts[None, :] + pos).clamp_(max=flat.shape[0] - 1)
        stack[:width] = torch.where(pos < lens[None, :], flat[src], PAD_SUBJECT)
    return stack


def merge_candidates(z_ids: np.ndarray, r_ids: np.ndarray, n_cand: int) -> np.ndarray:
    """Round-robin merge of per-signal top-id lists (dedup keeps the first).

    Exactly :func:`select_candidates`'s merge given each list is its
    signal's descending-order prefix.  Returns ids sorted ascending.
    """
    out = np.empty(n_cand, dtype=np.int64)
    seen = set()
    filled = 0
    for i in range(n_cand):
        for ids in (z_ids, r_ids):
            v = int(ids[i])
            if v not in seen:
                seen.add(v)
                out[filled] = v
                filled += 1
                if filled == n_cand:
                    return np.sort(out)
    return np.sort(out[:filled])


def select_candidates(signals, n_cand: int) -> np.ndarray:
    """Top ``n_cand`` ids, merged round-robin across ranked signals.

    ``signals`` is one score array or a list of them; ids are taken
    alternately from each signal's descending-score order (dedup keeps the
    first), ties by ascending id.  Returns ids sorted ascending.
    """
    if isinstance(signals, np.ndarray):
        signals = [signals]
    n = signals[0].shape[0]
    n_cand = min(n_cand, n)
    if n_cand >= n:
        return np.arange(n, dtype=np.int64)
    orders = [np.lexsort((np.arange(n), -np.asarray(s, dtype=np.float64))) for s in signals]
    seen = np.zeros(n, dtype=bool)
    out = np.empty(n_cand, dtype=np.int64)
    filled = 0
    for i in range(n):
        for o in orders:
            v = o[i]
            if not seen[v]:
                seen[v] = True
                out[filled] = v
                filled += 1
                if filled == n_cand:
                    return np.sort(out)
    return np.sort(out[:filled])
