"""Lane-sharded database search across a device mesh (counterpart of
``swtpu.parallel.search``).

The production multi-device engine is ``models.search.SearchEngine`` with
``SWConfig(mesh_shape=(n,))``: the same wavefront buckets as on one device,
each bucket's lanes split over the mesh, with the device top-K merged from
the shards.  :class:`ShardedSearchEngine` is a thin wrapper over it, and
:func:`make_sharded_step` the explicit building block over a plain ``(B,
L)`` batch: each shard scores its rows with the row kernel K3 (or the
PyTorch row scorers), takes its own top-k, and the primary merges the n x k
candidates.

Ties: each candidate is one int64 key, score in the high word and
``_ID_MASK - global id`` in the low word, so the merged top-K has the
engine's (score desc, id asc) order with no tie left for ``torch.topk``
to break.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops import bucket_sw, row_sw
from .mesh import Mesh, lane_bounds, on_device, replicate

_ID_MASK = (1 << 32) - 1


def make_sharded_step(
    mesh: Mesh,
    *,
    gap: int,
    strip: int = 32,
    top_k: int = 8,
    use_pallas: bool = False,
    fast16: bool = False,
) -> Callable:
    """A sharded scoring step: ``step(profile, subjects)`` with a (qpad, 32)
    int8 profile and (B, L) int8 subjects on any device, B % n == 0 and B /
    n >= top_k, returns (scores (B,), top_ids (K,), top_scores (K,)) on the
    mesh's primary device, K = top_k; shard k scores rows [k B/n, (k+1) B/n)
    on device k.

    ``use_pallas`` scores with K3 (``bucket_sw.sw_score_bucket``; its plain
    version on CPU tensors), else with the exact int32 PyTorch scorer.
    ``fast16=True`` takes the int16 u-space scorer where its ceiling
    ``row_sw.fast16_sat(gap, L)`` is at least 4096: scores below it are
    exact, those at it clamped lower bounds, as in swtpu (the engine rescores
    them; this building block does not)."""
    n = mesh.size

    def kernel(prof, subj):
        if use_pallas:
            return bucket_sw.sw_score_bucket(prof, subj, gap=gap, strip=strip)
        sat = row_sw.fast16_sat(gap, subj.shape[1])
        if fast16 and sat >= 4096:
            return row_sw.sw_score_bucket_fast16(prof, subj, gap=gap, strip=strip, sat=sat)
        return row_sw.sw_score_bucket(prof, subj, gap=gap, strip=strip)

    def step(profile: torch.Tensor, subjects: torch.Tensor):
        B = subjects.shape[0]
        bounds = lane_bounds(B, n)
        k = top_k
        if B // n < k:
            raise ValueError(f"{B // n} rows a shard cannot give a top-{k}")
        profiles = replicate(profile, mesh)
        scores, keys = [], []
        for (lo, hi), dev, prof in zip(bounds, mesh.devices, profiles):
            with on_device(dev):
                local = kernel(prof, subjects[lo:hi].contiguous().to(dev, non_blocking=True))
                ids = torch.arange(lo, hi, dtype=torch.int64, device=dev)
                key = torch.topk((local.to(torch.int64) << 32) | (_ID_MASK - ids), k, largest=True, sorted=True).values
            scores.append(local.to(mesh.primary, non_blocking=True))
            keys.append(key.to(mesh.primary, non_blocking=True))
        # The merge: every shard's k candidates on the primary, one top-k.
        top = torch.topk(torch.cat(keys), k, largest=True, sorted=True).values
        return torch.cat(scores), _ID_MASK - (top & _ID_MASK), (top >> 32).to(torch.int32)

    return step


class ShardedSearchEngine:
    """Multi-device search through the engine: ``SearchEngine`` with
    ``mesh_shape=(n,)`` on this mesh's devices (its wavefront buckets
    lane-sharded, the device top-K merged from the shards)."""

    def __init__(self, mesh: Mesh, config=None):
        from ..config import SWConfig
        from ..models.search import SearchEngine

        self.mesh = mesh
        self.n = mesh.size
        self.config = (config or SWConfig()).replace(mesh_shape=(self.n,), mesh_axes=(mesh.axis,))
        self._engine = SearchEngine(self.config, device=mesh.devices)
        self.matrix = self._engine.matrix

    def plan(self, db):
        return self._engine.plan(db)

    def search(self, query, db, top_k: int = 10):
        """A full sharded search: (scores (n,), [(id, score)] top-k, metrics)."""
        result = self._engine.search(query, db)
        return result.scores, result.top_k(top_k), result.metrics
