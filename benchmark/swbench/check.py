"""Whether the window's answers are right: the comparison with the plain
reference that decides ``correct``.

A unit is one query's answer inside one request.  Every unit the window
issued must have answered (``answers_missing``).  As each answer arrives,
``Sample`` keeps those the check will read, drawn from the seed: every
answer of the queries the mix names under ``always``, and uniform seeded
samples of fixed size (reservoirs) of the rest; it drops every other one.
Once the window has closed:

* full score arrays: each sampled unit's scores at the ids of the query's
  planted homologs and at ``subjects`` seeded random ids (the only scores
  a sampled answer keeps) must equal the reference's, exactly
  (``score_mismatches``);
* top hits with E-values: ``full_scans`` sampled units (of queries not
  named under ``no_full_scan``) are scored by the reference against the
  whole database, and their hits must equal the reference's top hits
  exactly (``hit_mismatches``) and their E-values and bits lie within
  ``evalue_rel_err`` of the reference's; on ``units`` sampled units each
  hit's score must equal the reference's score of that pair, the hits must
  come in (score desc, id asc) order, and no planted homolog may rank above
  the last hit and be missing.

``control=True`` puts the control in the program's place: the reference
at the next precision down (saturating int16 scores, float32 E-value
arithmetic), which must come out not correct.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from reference import hits as ref_hits
from reference import scoring, sw

from .data import STREAM_CHECK, STREAM_CHECK_IDS, rng

SAMPLE_RATIO = 3.0  # few, wide tiles for a sample's few subjects: fewer launches a query row


class Sample:
    """The answers the check reads, taken as they arrive: ``offer`` each
    unit's answer (None when it never came).  A unit is (request number,
    position in the request)."""

    def __init__(self, plan: dict, qs: List[dict], n: int, top_k, planted: List[np.ndarray], seed: int):
        self.n, self.k, self.planted = n, top_k, planted
        self.subjects = min(plan.get("subjects", 0), n)
        always, no_scan = set(plan.get("always", [])), set(plan.get("no_full_scan", []))
        self.always = {i for i, q in enumerate(qs) if q["name"] in always}
        self.scannable = {i for i, q in enumerate(qs) if q["name"] not in no_scan}
        self.size = dict(units=plan["units"], scans=plan.get("full_scans", 0) if top_k is not None else 0)
        self.pools: Dict[str, list] = dict(units=[], scans=[])
        self.seen = dict(units=0, scans=0)
        self.kept: Dict[tuple, tuple] = {}  # unit -> (query, what the check reads of its answer)
        self.missing = 0
        self.gen, self.gen_ids = rng(seed, STREAM_CHECK), rng(seed, STREAM_CHECK_IDS)

    def offer_request(self, number: int, record, answers) -> None:
        """Every unit of one request (``answers`` None when it failed)."""
        whole = answers is not None and len(answers) == len(record.idx)
        for pos, q in enumerate(record.idx):
            self.offer((number, pos), q, answers[pos] if whole else None)

    def offer(self, unit: tuple, q: int, answer) -> None:
        if answer is None or (np.shape(answer) != (self.n,) if self.k is None else len(answer) != min(self.k, self.n)):
            self.missing += 1
            return
        keep = q in self.always
        keep |= self._draw("units", unit)
        if q in self.scannable:
            keep |= self._draw("scans", unit)
        if keep:
            self.kept[unit] = (q, self._taken(q, answer))

    def units(self, pool: str) -> List[tuple]:
        """The kept units of a reservoir, with every unit of an ``always``
        query for ``units``."""
        extra = {u for u, (q, _) in self.kept.items() if q in self.always} if pool == "units" else set()
        return sorted(set(self.pools[pool]) | extra)

    def _draw(self, pool: str, unit: tuple) -> bool:
        """Reservoir sampling: the i-th unit offered takes a place with
        probability size / (i + 1), in place of a seeded one."""
        i, size = self.seen[pool], self.size[pool]
        self.seen[pool] += 1
        if i < size:
            self.pools[pool].append(unit)
            return True
        j = int(self.gen.integers(0, i + 1))
        if j >= size:
            return False
        old, self.pools[pool][j] = self.pools[pool][j], unit
        if old in self.kept and self.kept[old][0] not in self.always and all(old not in p for p in self.pools.values()):
            del self.kept[old]
        return True

    def _taken(self, q: int, answer):
        """A full array keeps its scores at the planted ids and at seeded
        random ids; hits are kept whole."""
        if self.k is not None:
            return list(answer)
        ids = np.concatenate([self.planted[q], self.gen_ids.choice(self.n, self.subjects, replace=False)])
        return ids, np.asarray(answer)[ids].copy()


def _rel(a: float, b: float) -> float:
    if a == b:
        return 0.0
    return abs(a - b) / max(abs(b), 1e-300)


def check(cfg: dict, qs: list, residues: np.ndarray, offsets: np.ndarray, planted: list, sample: Sample,
          device, control: bool = False) -> Dict[str, dict]:
    """{number: {"value", "limit"}} of the comparison, and how long the
    reference took under ``"reference_seconds"``."""
    t_ref = time.perf_counter()
    limits = cfg["limits"]
    gaps = cfg["scoring"]["gaps"]
    matrix = scoring.matrix(cfg["scoring"]["matrix"])
    k = cfg["returns"].get("top_k")
    n = offsets.size - 1
    lengths = np.diff(offsets)
    res_dev = torch.from_numpy(residues).to(device)
    out = {"answers_missing": dict(value=sample.missing, limit=limits["answers_missing"])}

    def scores_at(q: int, ids: np.ndarray, precision: str = "int32") -> Dict[int, int]:
        ids = np.unique(ids)
        got = sw.best_scores(qs[q]["residues"], res_dev, offsets, ids, matrix, gaps, device, precision, ratio=SAMPLE_RATIO)
        return dict(zip(ids.tolist(), got.tolist()))

    if k is None:
        picked = sample.units("units")
        by_q: Dict[int, list] = {}
        for u in picked:
            q, (ids, _) = sample.kept[u]
            by_q.setdefault(q, []).append(ids)
        ref = {q: scores_at(q, np.concatenate(v)) for q, v in by_q.items()}
        ctl = {q: scores_at(q, np.concatenate(v), "int16") for q, v in by_q.items()} if control else None
        bad, gap, pairs = 0, 0, 0
        for u in picked:
            q, (ids, got) = sample.kept[u]
            if control:
                got = np.array([ctl[q][i] for i in ids])
            exp = np.array([ref[q][i] for i in ids])
            bad += int((got != exp).sum())
            gap = max(gap, int(np.abs(got.astype(np.int64) - exp).max()))
            pairs += ids.size
        out["score_mismatches"] = dict(value=bad, limit=limits["score_mismatches"])
        out["reference_seconds"] = time.perf_counter() - t_ref
        out["_detail"] = dict(units=len(picked), pairs=pairs, max_abs_gap=gap)
        return out

    bad, worst = 0, 0.0
    scanned = sample.units("scans")
    full: Dict[int, tuple] = {}
    for u in scanned:
        q, got = sample.kept[u]
        if q not in full:
            qres, qlen = qs[q]["residues"], qs[q]["residues"].size
            ref = sw.best_scores(qres, res_dev, offsets, np.arange(n), matrix, gaps, device)
            ref_top = ref_hits.top_hits(ref, k)
            with_ev = bool(cfg["returns"].get("evalue"))
            ref_ev = ref_hits.evalues(ref, lengths, qlen, ref_top) if with_ev else None
            ctl_got = None
            if control:
                ctl = sw.best_scores(qres, res_dev, offsets, np.arange(n), matrix, gaps, device, "int16")
                ctl_top = ref_hits.top_hits(ctl, k)
                ctl_ev = ref_hits.evalues(ctl, lengths, qlen, ctl_top, np.float32) if with_ev else [(None, None)] * k
                ctl_got = [(i, sc, *ev) for (i, sc), ev in zip(ctl_top, ctl_ev)]
            full[q] = (ref_top, ref_ev, ctl_got)
        if control:
            got = full[q][2]
        ref_top, ref_ev = full[q][:2]
        bad += abs(len(got) - len(ref_top))
        for j, ((gi, gs, ge, gb), (ri, rs)) in enumerate(zip(got, ref_top)):
            if (gi, gs) != (ri, rs):
                bad += 1
            elif ref_ev is not None:
                worst = max(worst, _rel(ge, ref_ev[j][0]), _rel(gb, ref_ev[j][1]))
    partial = [] if control else sample.units("units")
    by_q = {}
    for u in partial:
        q, got = sample.kept[u]
        by_q.setdefault(q, []).extend([planted[q], np.array([h[0] for h in got], dtype=np.int64)])
    ref = {q: scores_at(q, np.concatenate(v)) for q, v in by_q.items()}
    for u in partial:
        q, got = sample.kept[u]
        keys = [(-s, i) for i, s, *_ in got]
        bad += sum(ref[q][i] != s for i, s, *_ in got)
        bad += keys != sorted(keys)
        have = {i for i, *_ in got}
        last = keys[-1]
        bad += sum(1 for p in planted[q].tolist() if p not in have and (-ref[q][p], p) < last)
    out["hit_mismatches"] = dict(value=bad, limit=limits["hit_mismatches"])
    if cfg["returns"].get("evalue"):
        out["evalue_rel_err"] = dict(value=worst, limit=limits["evalue_rel_err"])
    out["reference_seconds"] = time.perf_counter() - t_ref
    out["_detail"] = dict(full_scans=[qs[sample.kept[u][0]]["name"] for u in scanned], units=len(partial))
    return out
