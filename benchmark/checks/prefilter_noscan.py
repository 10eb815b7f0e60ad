"""Whether a prefiltered search's answers are right, without the full
scans: ``checks/prefilter.py``'s comparison (``compare``) alone.

A configuration whose database is too large for the plain reference to
score a query against all of it inside a run names this check with
``"check": "prefilter_noscan"``: at a UniRef50 quarter (~5.6 G residues)
one full scan at the reference's 10-14 GCUPS takes two minutes or more.
Every number and limit is ``checks/prefilter.py``'s (``answers_missing``,
``hit_mismatches``, ``evalue_rel_err``, ``planted_missed``); the share of
the exhaustive top hits is not read.
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from swbench.check import Sample
from swbench.spec import plugin


def check(cfg: dict, qs: list, residues: np.ndarray, offsets: np.ndarray, planted: list, sample: Sample,
          device, control: bool = False) -> Dict[str, dict]:
    """{number: {"value", "limit"}} of the comparison, how long the
    reference took under ``"reference_seconds"``, readings under ``"_detail"``."""
    t_ref = time.perf_counter()
    res_dev = torch.from_numpy(residues).to(device)
    out, _ = plugin("checks", "prefilter").compare(cfg, qs, res_dev, offsets, planted, sample, device, control)
    out["reference_seconds"] = time.perf_counter() - t_ref
    return out
