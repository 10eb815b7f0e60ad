"""Whether a prefiltered search's answers are right: the comparison with the
plain reference of the same heuristic (``reference.prefilter``).

A configuration names this check with ``"check": "prefilter"``; its
engine states the heuristic's knobs (``prefilter``,
``prefilter_min_candidates``, ``top_k``), which the reference reads.  A
prefiltered search returns the best hits among its candidates, with
E-values from a fixed calibration sample, so the exhaustive answer is not
the one to hold it to.  Every kept unit of the sample (the ``units`` and
``full_scans`` reservoirs, and every answer of the ``always`` queries) is
worked out again whole by the reference heuristic, once a query:

* ``answers_missing``: units the window issued that never answered;
* ``hit_mismatches``: hits (id, score) unequal to the reference
  heuristic's, position by position, and any difference in their count;
* ``evalue_rel_err``: the largest relative gap of an E-value or bits
  against the reference's sampled null, over hits that match (with
  E-values only);
* ``planted_missed``: planted homologs whose exact score ranks above the
  last hit but are absent from the hits: the heuristic's recall, with the
  limit the configuration states.

``full_scans`` units are also scored against the whole database; how many
of the exhaustive top hits they hold is a reading in ``_detail``, not a
limit (``exhaustive_overlap``; a check that cannot afford the scans calls
``compare`` alone).  ``control=True`` puts the reference heuristic at the
next precision down (saturating int16 scores, float32 E-value arithmetic)
in the program's place, on the same candidates.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from reference import hits as ref_hits
from reference import prefilter as ref_pf
from reference import scoring, sw
from swbench.check import SAMPLE_RATIO, Sample, _rel


def check(cfg: dict, qs: list, residues: np.ndarray, offsets: np.ndarray, planted: list, sample: Sample,
          device, control: bool = False) -> Dict[str, dict]:
    """{number: {"value", "limit"}} of the comparison, how long the
    reference took under ``"reference_seconds"``, readings under ``"_detail"``."""
    t_ref = time.perf_counter()
    res_dev = torch.from_numpy(residues).to(device)
    out, judged = compare(cfg, qs, res_dev, offsets, planted, sample, device, control)
    t_scan = time.perf_counter()
    out["_detail"]["exhaustive_overlap"] = exhaustive_overlap(cfg, qs, res_dev, offsets, sample, judged, device)
    out["_detail"]["seconds"]["exhaustive"] = time.perf_counter() - t_scan
    out["reference_seconds"] = time.perf_counter() - t_ref
    return out


def compare(cfg: dict, qs: list, residues: torch.Tensor, offsets: np.ndarray, planted: list, sample: Sample,
            device, control: bool = False):
    """The numbers and their ``_detail``, without the full scans, and the
    answers judged ({unit: hits}: the program's, or the control's)."""
    t0 = time.perf_counter()
    limits, engine = cfg["limits"], cfg["engine"]["config"]
    gaps = cfg["scoring"]["gaps"]
    matrix = scoring.matrix(cfg["scoring"]["matrix"])
    k, with_ev = cfg["returns"]["top_k"], bool(cfg["returns"].get("evalue"))
    n_cand = ref_pf.n_candidates(offsets.size - 1, engine["prefilter"], engine["prefilter_min_candidates"],
                                 engine["top_k"])

    units = sorted(sample.kept)
    qids = sorted({sample.kept[u][0] for u in units})
    qres = [qs[q]["residues"] for q in qids]
    cands = ref_pf.candidates(qres, residues, offsets, n_cand, with_ev, device)
    t_cand = time.perf_counter()
    ref = dict(zip(qids, ref_pf.answers(qres, cands, residues, offsets, matrix, gaps, k, with_ev, device)))
    ctl = dict(zip(qids, ref_pf.answers(qres, cands, residues, offsets, matrix, gaps, k, with_ev, device, "int16",
                                        np.float32))) if control else {}
    exact = sw.best_scores_many(qres, [planted[q] for q in qids], residues, offsets, matrix, gaps, device,
                                ratio=SAMPLE_RATIO)
    planted_scores = {q: list(zip(planted[q].tolist(), e.tolist())) for q, e in zip(qids, exact)}

    bad, worst, missed, judged = 0, 0.0, [], {}
    for u in units:
        q, got = sample.kept[u]
        judged[u] = got = ctl[q] if control else got
        bad += abs(len(got) - len(ref[q]))
        for (gi, gs, ge, gb), (ri, rs, re, rb) in zip(got, ref[q]):
            if (gi, gs) != (ri, rs):
                bad += 1
            elif with_ev:
                worst = max(worst, _rel(ge, re), _rel(gb, rb))
        have = {h[0] for h in got}
        last = (-got[-1][1], got[-1][0]) if got else None
        missed += [[qs[q]["name"], s] for p, s in planted_scores[q] if p not in have and (last is None or (-s, p) < last)]

    out = {"answers_missing": dict(value=sample.missing, limit=limits["answers_missing"]),
           "hit_mismatches": dict(value=bad, limit=limits["hit_mismatches"])}
    if with_ev:
        out["evalue_rel_err"] = dict(value=worst, limit=limits["evalue_rel_err"])
    out["planted_missed"] = dict(value=len(missed), limit=limits["planted_missed"])
    out["_detail"] = dict(units=len(units), queries=len(qids), n_cand=n_cand,
                          seconds=dict(candidates=t_cand - t0, exact=time.perf_counter() - t_cand),
                          scored=[int(min(c.size for c in cands)), int(max(c.size for c in cands))] if cands else [],
                          planted=sum(len(planted_scores[sample.kept[u][0]]) for u in units), missed=missed[:20])
    return out, judged


def exhaustive_overlap(cfg: dict, qs: list, residues: torch.Tensor, offsets: np.ndarray, sample: Sample,
                       judged: dict, device) -> list:
    """[query, hits among the exhaustive top hits, their count] of each
    ``full_scans`` unit: its query scored against the whole database."""
    gaps, k = cfg["scoring"]["gaps"], cfg["returns"]["top_k"]
    matrix = scoring.matrix(cfg["scoring"]["matrix"])
    out, exhaustive = [], {}
    for u in sample.units("scans"):
        q = sample.kept[u][0]
        if q not in exhaustive:
            full = sw.best_scores(qs[q]["residues"], residues, offsets, np.arange(offsets.size - 1), matrix, gaps, device)
            exhaustive[q] = {i for i, _ in ref_hits.top_hits(full, k)}
        out.append([qs[q]["name"], len(exhaustive[q] & {h[0] for h in judged[u]}), len(exhaustive[q])])
    return out
