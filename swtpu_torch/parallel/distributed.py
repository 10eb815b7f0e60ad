"""Multi-process database search over ``torch.distributed`` (counterpart of
``swtpu.parallel.distributed``).

The deployment model is swtpu's database sharding with process-local
compute:

* every process owns a contiguous shard of the database, its slice of a
  shared FASTA file (``Database.shard``) or a file of its own, so parse and
  pack never cross processes;
* each process scores its shard on its own device with the single-process
  engine (itself a mesh engine when ``config.mesh_shape`` says so);
* only the results cross processes: each process's top-K candidates (score,
  global id) and, under ``config.evalue``, its null-distribution scalars go
  through one ``all_gather`` a batch, and every process reduces the n x K
  candidates to the same global top-K.

The backend is gloo: what moves is a small host array, as over swtpu's DCN,
and gloo lets several processes share one card (NCCL refuses two ranks on
one GPU).  Every process must call :meth:`DistributedSearchEngine.search`
or :meth:`~DistributedSearchEngine.search_many` collectively, with the same
queries and top_k.

Three choices differ from swtpu's (ROADMAP D13-D15):

* whether the null scalars travel is the config's ``evalue``, not whether
  every local result holds them, so every process gathers the same
  payload; a query whose statistics are missing on some process gets no
  null statistics on any;
* each process ships its top ``ceil(trim x the global count)`` score
  values, and collects that many locally (``process_count`` times the
  engine's trim), so the merged list holds the global trim's values
  whatever the shards' skew;
* ``DistributedResult.hit_stats`` raises for a trim above what the merged
  list covers, as ``SearchResult.top_k_stats`` does.
"""

from __future__ import annotations

import dataclasses
import os
import time
from datetime import timedelta
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import SWConfig
from ..io.fasta import Database, Query, shard_range
from ..stats import DEFAULT_TRIM

# Seconds a process waits for the others at a collective before it fails
# (a rank that died before the merge leaves the rest there).
TIMEOUT_SECONDS = 600.0


@dataclasses.dataclass
class DistributedResult:
    """Global top-K hits and this process's local scores."""

    hits: List[Tuple[int, int]]  # (global id, score), score desc, id asc
    # (n_local,) this process's shard in file order; None in the default
    # top-K-first mode (construct the engine with full_scores=True to keep it).
    local_scores: Optional[np.ndarray]
    shard_base: int  # global id of this process's first sequence
    # Global null statistics (swtpu_torch.stats.NullStats) under
    # config.evalue: the shards' sufficient statistics merged, the same on
    # every process; top_vals holds only the leading global top values that
    # the shipped lists determine exactly.  Length bins are dropped (their
    # edges are shard-local quantiles), so E-values use the pooled fit.
    null_stats: Optional[object] = None
    # Seconds this process spent in the batch's collectives, the wait for
    # the slowest process included.
    collective_seconds: float = 0.0

    def hit_stats(self, trim: float = DEFAULT_TRIM):
        """Significance (E-value, bit score) of the merged global hits.
        Raises for a trim whose top scores the merged list does not cover."""
        if self.null_stats is None:
            raise ValueError(
                "hit_stats needs merged null statistics: run the engine with SWConfig.evalue=True "
                "(every process's local search must collect them)"
            )
        from ..stats import hit_significance

        ns = self.null_stats
        needed = int(np.ceil(trim * ns.count)) if trim > 0 else 0
        if needed > np.asarray(ns.top_vals).size:
            raise ValueError(
                f"trim={trim} needs the top {needed} scores but the merge covers "
                f"{np.asarray(ns.top_vals).size}; use the engine-default trim"
            )
        return hit_significance(ns, self.hits, trim=trim)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    timeout: float = TIMEOUT_SECONDS,
) -> None:
    """Bring up ``torch.distributed`` with gloo over TCP (idempotent).

    ``coordinator_address`` is process 0's ``host:port``.  With none of the
    three given, torchrun's ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` are read (swtpu reads a TPU pod's the same way), and
    without those this is one process.  A no-op for one process and when
    the group is already up.  ``timeout``: seconds a collective waits."""
    import torch.distributed as dist

    if coordinator_address is None and num_processes is None and process_id is None and "WORLD_SIZE" in os.environ:
        env = os.environ
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes, process_id = int(env["WORLD_SIZE"]), int(env["RANK"])
    if num_processes is None or num_processes <= 1 or dist.is_initialized():
        return
    if coordinator_address is None or process_id is None:
        raise ValueError("a fleet of several processes needs coordinator_address and process_id")
    dist.init_process_group(
        "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=timedelta(seconds=timeout),
    )


def process_device(process_id: int, device=None) -> torch.device:
    """A process's device: ``device`` when the caller names one (``"cpu"``
    for the plain version), else a card: ``cuda:<LOCAL_RANK>`` under
    torchrun, else ``cuda:<process_id>``, modulo the cards present, so that
    every process on a one-card host takes ``cuda:0``."""
    if device is not None and torch.device(device) != torch.device("cuda"):
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the plain PyTorch version")
    local = os.environ.get("LOCAL_RANK")
    return torch.device("cuda", (int(local) if local is not None else process_id) % torch.cuda.device_count())


class DistributedSearchEngine:
    """One process of a multi-process search fleet.

    Call :func:`initialize` before constructing.  ``device``: as
    :func:`process_device` for a one-device config; under ``mesh_shape``
    the local mesh engine's (None: the first n cards, ``"cpu"``: n CPU
    shards)."""

    def __init__(self, config: SWConfig = SWConfig(), full_scores: bool = False, device=None):
        import torch.distributed as dist

        self.config = config
        self.full_scores = full_scores
        up = dist.is_available() and dist.is_initialized()
        self.process_id = dist.get_rank() if up else 0
        self.process_count = dist.get_world_size() if up else 1
        self.device = device if config.n_devices > 1 else process_device(self.process_id, device)
        # Local engines cached per effective top_k: in top-K-first mode the
        # local engine reduces on its device and transfers only candidates;
        # full_scores=True strips top_k so the full local array is kept.
        self._engines: dict = {}

    def _local_engine(self, config: SWConfig):
        from ..models.search import SearchEngine

        # Every process collects process_count times the trim's top values,
        # so it can ship ceil(trim x the global count) of them (D14).
        return SearchEngine(config, device=self.device, top_trim=min(1.0, DEFAULT_TRIM * self.process_count))

    def _engine(self, top_k: Optional[int]):
        key = None if self.full_scores else top_k
        eng = self._engines.get(key)
        if eng is None:
            eng = self._engines[key] = self._local_engine(self.config.replace(top_k=key))
        return eng

    def shard_of(self, db: Database) -> Tuple[Database, int]:
        """This process's contiguous shard of a globally parsed database,
        and the global id of its first sequence."""
        lo, _ = shard_range(db.n, self.process_id, self.process_count)
        return db.shard(self.process_id, self.process_count), lo

    def pack(self, local_db: Database, top_k: int = 10) -> bool:
        """Pack this process's shard on its device ahead of the first search
        (the local engine's residency, or under the prefilter its
        signatures); True when it is resident, False when the searches
        will stream it (over the residency budget of the device's free
        memory)."""
        eng = self._engine(top_k)
        if self.config.prefilter is not None:
            eng._prefilter_signatures(local_db)
            return True
        return eng._resident_packed(local_db) is not None

    def _search_local(self, method: str, queries, local_db: Database, top_k: int):
        """The local engine's search, with swtpu's one retry: a failure that
        ``utils.memory.is_oom`` classifies as device memory exhaustion runs
        once more through a streaming (non-resident) engine on the same
        device before it takes the fleet down; both failures are chained.
        Any other error propagates at once: a blind retry would hide it."""
        from ..utils.memory import is_oom

        try:
            return getattr(self._engine(top_k), method)(queries, local_db)
        except Exception as exc:
            if not is_oom(exc):
                raise
            retry = self._local_engine(
                self.config.replace(device_resident=False, top_k=None if self.full_scores else top_k)
            )
            try:
                return getattr(retry, method)(queries, local_db)
            except Exception as exc2:  # chain: both failures are evidence
                raise exc2 from exc

    def _all_gather(self, payload: np.ndarray) -> np.ndarray:
        """(process_count, *payload.shape): every process's array, by rank."""
        import torch.distributed as dist

        if self.process_count == 1:
            return payload[None]
        t = torch.from_numpy(np.ascontiguousarray(payload))
        out = [torch.empty_like(t) for _ in range(self.process_count)]
        dist.all_gather(out, t)
        return torch.stack(out).numpy()

    def _merge_hits(self, results, local_db: Database, shard_base: int, top_k: int) -> List[DistributedResult]:
        """The cross-process merge of per-query local results: one
        ``all_gather`` of a fixed (Q, 2K + 6) int64 array a batch, every
        process's candidates (score, global id; -1 pads, so an empty shard
        takes part and never wins) and, under evalue, its null scalars
        (count, subjects, whether it has them; and the float32 bits of the
        score sum, the sum of squares and the summed subject length, swtpu's
        wire precision); under evalue one more of the top score values.
        Every process then reduces to the same (score desc, id asc) top-K."""
        nq, kk = len(results), 2 * top_k
        payload = np.full((nq, kk + 6), -1, dtype=np.int64)
        k = min(top_k, max(local_db.n, 1))
        have_null = self.config.evalue  # from the config: every process gathers the same (D13)
        for qi, r in enumerate(results):
            for rank, (sid, score) in enumerate(r.top_k(k)):
                payload[qi, 2 * rank : 2 * rank + 2] = (score, shard_base + sid)
            ns = r.null_stats
            if have_null and ns is not None:
                payload[qi, kk : kk + 3] = (ns.count, ns.n_subjects, 1)
                scal_f = (ns.total, ns.total_sq, ns.n_subjects * ns.mean_subject_length)
                payload[qi, kk + 3 :] = np.asarray(scal_f, np.float32).view(np.int32)
            else:
                payload[qi, kk:] = 0
        t0 = time.perf_counter()
        gathered = self._all_gather(payload)  # (P, Q, 2K + 6)
        cand = gathered[:, :, :kk].reshape(self.process_count, nq, top_k, 2)
        si = gathered[:, :, kk : kk + 3]
        sf = gathered[:, :, kk + 3 :].astype(np.int32).view(np.float32).astype(np.float64)

        tops = None
        if have_null:
            # Every process ships its top ceil(trim x the global count)
            # values (D14); all compute the same size from the gathered
            # counts, so the shapes agree.
            topn = max(1, int(np.ceil(DEFAULT_TRIM * int(si[:, :, 0].sum(axis=0).max()))))
            mine = np.zeros((nq, topn), dtype=np.float32)
            for qi, r in enumerate(results):
                if r.null_stats is not None:
                    tv = np.asarray(r.null_stats.top_vals, np.float64)[:topn]
                    mine[qi, : tv.size] = tv
            tops = self._all_gather(mine)  # (P, Q, topn)
        collective_s = time.perf_counter() - t0

        out = []
        for qi, r in enumerate(results):
            c = cand[:, qi].reshape(-1, 2)
            c = c[c[:, 0] >= 0]
            order = np.lexsort((c[:, 1], -c[:, 0]))[:top_k]
            null = None
            if have_null and si[:, qi, 2].all():
                null = self._merged_null(si[:, qi], sf[:, qi], tops[:, qi], r.metrics.query_length)
            out.append(DistributedResult(
                hits=[(int(c[i, 1]), int(c[i, 0])) for i in order],
                local_scores=r.scores,
                shard_base=shard_base,
                null_stats=null,
                collective_seconds=collective_s,
            ))
        return out

    @staticmethod
    def _merged_null(si: np.ndarray, sf: np.ndarray, tops: np.ndarray, query_length: int):
        """One query's global NullStats from every process's scalars (si:
        count, subjects, flag; sf: sum, sum of squares, summed length) and
        shipped top values (P, topn).  The merged values are the global top
        down to V, the largest last shipped value of a process that had
        more: every value above V is in the list, and one equal to V is V
        wherever it came from, so the list is cut after its last value >= V."""
        from ..stats import NullStats

        merged, cut_at = [], None
        for p in range(tops.shape[0]):
            vals = tops[p][tops[p] > 0].astype(np.float64)
            merged.append(vals)
            if vals.size < si[p, 0]:  # this process had more than it shipped
                last = vals[-1] if vals.size else np.inf
                cut_at = last if cut_at is None else max(cut_at, last)
        tv = -np.sort(-np.concatenate(merged))
        if cut_at is not None:
            tv = tv[tv >= cut_at]
        n_subj = int(si[:, 1].sum())
        return NullStats(
            count=int(si[:, 0].sum()),
            total=float(sf[:, 0].sum()),
            total_sq=float(sf[:, 1].sum()),
            top_vals=tv,
            n_subjects=n_subj,
            query_length=int(query_length),
            mean_subject_length=float(sf[:, 2].sum()) / max(n_subj, 1),
        )

    def search(self, query: Query, local_db: Database, shard_base: int, top_k: int = 10) -> DistributedResult:
        """Collective search: local scoring and the cross-process top-K
        merge.  ``local_db``: this process's shard; ``shard_base``: the
        global id of its sequence 0."""
        result = self._search_local("search", query, local_db, top_k)
        return self._merge_hits([result], local_db, shard_base, top_k)[0]

    def search_many(
        self, queries: List[Query], local_db: Database, shard_base: int, top_k: int = 10
    ) -> List[DistributedResult]:
        """Collective batched search: each process scores the whole batch
        against its shard with ``SearchEngine.search_many`` (shared
        launches, the device top-K and, with ``config.prefilter``, the
        prefilter on its own shard), then one collective merges the batch
        (one more under evalue)."""
        if not queries:
            return []
        results = self._search_local("search_many", queries, local_db, top_k)
        return self._merge_hits(results, local_db, shard_base, top_k)
