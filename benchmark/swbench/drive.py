"""The requests of a window: what one returns, and the record it leaves.

A request is one call of the program's entry (the mix's ``call``:
``calls/<name>.py``) and ends when its answers are on the host: the full
score array in file order, or the top hits with their E-values.  The mix's
``loop`` (``loops/<name>.py``) sends them.  A record keeps a request's
times and outcome, not its answers: the check's sample takes what it
reads as each answer arrives (``swbench.check.Sample``), and the rest is
dropped, as a client that has read it would.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from .spec import plugin


def answer_fn(returns: dict) -> Callable:
    """What a user takes from one search result."""
    k, with_evalue = returns.get("top_k"), returns.get("evalue", False)

    def answer(res):
        if k is None:
            return res.scores
        if with_evalue:
            return [(h.id, h.score, h.evalue, h.bits) for h in res.top_k_stats(k)]
        return [(i, s, None, None) for i, s in res.top_k(k)]

    return answer


def caller(engine, db, qobjs: list, call: str, returns: dict) -> Callable[[List[int]], tuple]:
    """A request: the answers of the program's entry for these queries, and
    the device seconds the program's own CUDA events gave them (a
    diagnostic, not a metric)."""
    answer = answer_fn(returns)
    run = plugin("calls", call).make(engine, db, qobjs)

    def go(idx):
        results = run(idx)
        return [answer(r) for r in results], sum(r.metrics.device_seconds for r in results)

    return go


class Record:
    __slots__ = ("t0", "t1", "idx", "error", "device_s")

    def __init__(self, t0: float, t1: float, idx: List[int], error: Optional[str], device_s: float = 0.0):
        self.t0, self.t1, self.idx, self.error, self.device_s = t0, t1, idx, error, device_s
