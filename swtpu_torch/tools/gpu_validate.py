"""One-command acceptance battery of the port on the card.

The counterpart of ``tools/tpu_validate.py``: its checks, in its order,
through the port's engine and kernels on ``cuda``:

   1. subset golden       engine vs the committed golden_P02232_subset (111)
   2. scale golden        engine vs the 10k golden (``synth.synth_scale_db``)
   3. saturation golden   29k-magnitude scores, exact int32
   4. kernel fuzz         ``card_fuzz.main`` (K1 linear, random buckets)
      chained fuzz        ``card_fuzz.main_chain`` (K1, subjects chained)
  4b. affine kernel       K1 affine (11/1) vs the scalar Gotoh oracle
      affine split        two band groups handing the H and F carry on ==
                          one launch over every band
  4c. affine engine       the engine at gaps 11/1 vs the oracle (subset)
   5. streaming           a database streamed on the row ladder (K3 on the
                          card) == the resident wavefront search
   6. search_many         the batched multi-query search == single searches
   7. query shard         the query-band pipeline on a mesh that names the
                          device once == the row scorer
   9. prefilter           5% of 10k recalls five planted mutants: its top-5
                          == the exhaustive top-5
  11. queued top-K        search_queued with the device top-K == the
                          full-array top-5 of each query
  12. E-values            device-moment E-values vs the full-array fit:
                          log-E within 5%, bits within 1%

swtpu's check 8 (``wave_unroll_block=16`` == full unroll) is left out: the
unroll block is a Mosaic compile-time knob of the TPU kernel, and the port's
config has no such field (ROADMAP.md, Rules: "Config").  So are its two
checks 10 (composed dispatch, linear and affine): the port has no composed
dispatch, whose power-of-two rungs bound the TPU's compiled kernels and buy
nothing on the card (ROADMAP.md, D21); the hand-off kernel mode they chain
is fuzzed by ``card_fuzz.main_shapes`` and checked split by ``affine split``
here.  Each check prints
``NAME: OK|FAIL``; the tool exits 1 if any failed.  A check that raises ends
the run with its traceback.

Run: ``python -m swtpu_torch.tools.gpu_validate [--device cuda]
[--checks subset,scale,...]``
"""

from __future__ import annotations

import argparse
import functools
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import synth
from ..config import SWConfig
from ..io.fasta import Query, parse_database, parse_query
from ..matrices import get_matrix
from ..models.search import SearchEngine, resolve_device
from ..ops import oracle, row_sw, wave_sw
from ..ops.profile import PAD_SUBJECT, make_profile
from ..parallel.mesh import make_mesh
from ..parallel.query_shard import wave_query_sharded_scores
from . import card_fuzz

DATA = Path(__file__).resolve().parents[2] / "tests" / "data"


class Battery:
    """The inputs the checks share, built on first use."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)

    def engine(self, **kw) -> SearchEngine:
        return SearchEngine(SWConfig(**kw), device=self.device)

    @functools.cached_property
    def db(self):
        return parse_database(DATA / "uniprot_subset.fasta")

    @functools.cached_property
    def q(self) -> Query:
        return parse_query(DATA / "queries" / "P02232.fasta")

    @functools.cached_property
    def seqs10k(self) -> List[np.ndarray]:
        return synth.synth_scale_db(self.q.residues)

    @functools.cached_property
    def db10k(self):
        return synth.database_from_arrays(self.seqs10k)

    @functools.cached_property
    def golden10k(self) -> np.ndarray:
        return np.loadtxt(DATA / "golden_P02232_scale10k.txt", dtype=np.int64)

    @functools.cached_property
    def affine_subset(self) -> np.ndarray:
        """The subset's scores at gaps 11/1, fused."""
        return self.engine(gap_open=11, gap_extend=1).search(self.q, self.db).scores

    @functools.cached_property
    def affine_bucket(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, torch.Tensor, torch.Tensor]:
        """tpu_validate.py's affine bucket: a 150-residue query (seed 99),
        128 subjects of 0-200 residues; (query, subjects, lengths, profile,
        transposed bucket) with the width padded to 224 as there."""
        rng = np.random.default_rng(99)
        q = rng.integers(0, 25, 150).astype(np.int8)
        subj = np.full((128, 200), PAD_SUBJECT, np.int8)
        lens = rng.integers(0, 201, 128)
        for b in range(128):
            subj[b, : lens[b]] = rng.integers(0, 25, lens[b])
        prof = torch.from_numpy(make_profile(q, get_matrix("blosum50_ref"), pad_rows_to=160)).to(self.device)
        stack = torch.from_numpy(card_fuzz.chain_layout(subj, 1, 224, 128)).to(self.device)
        return q, subj, lens, prof, stack


def check_subset(b: Battery) -> bool:
    golden = np.loadtxt(DATA / "golden_P02232_subset.txt", dtype=np.int64)
    return bool(np.array_equal(b.engine().search(b.q, b.db).scores, golden))


def check_scale(b: Battery) -> bool:
    return bool(np.array_equal(b.engine().search(b.q, b.db10k).scores, b.golden10k))


def check_saturation(b: Battery) -> bool:
    query, seqs = synth.synth_sat_case()
    res = b.engine().search(Query("sat", query, ""), synth.database_from_arrays(seqs))
    return bool(np.array_equal(res.scores, np.loadtxt(DATA / "golden_sat_case.txt", dtype=np.int64)))


def check_fuzz(b: Battery) -> bool:
    return card_fuzz.main(10, seed=7, device=b.device) == 0


def check_chain_fuzz(b: Battery) -> bool:
    return card_fuzz.main_chain(4, seed=42, device=b.device) == 0


def check_affine_kernel(b: Battery) -> bool:
    q, subj, lens, prof, stack = b.affine_bucket
    got = wave_sw.sw_wave(prof, stack, gap_open=11, gap_extend=1).cpu().numpy()
    mat = get_matrix("blosum50_ref")
    return all(int(got[i]) == oracle.sw_affine_score_scalar(q, subj[i, : lens[i]], mat, 11, 1)
               for i in range(0, 128, 7))


def check_affine_split(b: Battery) -> bool:
    _, _, _, prof, stack = b.affine_bucket
    full = wave_sw.sw_wave(prof, stack, gap_open=11, gap_extend=1)
    s1, carry = wave_sw.sw_wave(prof[:64], stack, gap_open=11, gap_extend=1, return_carry=True)
    s2 = wave_sw.sw_wave(prof[64:].contiguous(), stack, carry, gap_open=11, gap_extend=1)
    return bool(torch.equal(torch.maximum(s1, s2), full))


def check_affine_engine(b: Battery) -> bool:
    mat = get_matrix("blosum50_ref")
    return all(int(b.affine_subset[i]) == oracle.sw_affine_score_scalar(b.q.residues, b.db.sequence(i), mat, 11, 1)
               for i in range(0, b.db.n, 9))


def check_streaming(b: Battery) -> bool:
    q2 = Query("q", np.random.default_rng(9).integers(0, 25, 200).astype(np.int8), "")
    resident = b.engine().search(q2, b.db10k)
    streamed = b.engine(device_resident=False, use_wave=False).search(q2, b.db10k)
    return bool(np.array_equal(resident.scores, streamed.scores))


def check_search_many(b: Battery) -> bool:
    rng = np.random.default_rng(9)
    rng.integers(0, 25, 200)  # tpu_validate.py draws check 5's query from this generator first
    queries = [Query(f"m{i}", rng.integers(0, 25, int(n)).astype(np.int8), "") for i, n in enumerate((150, 155, 160, 280))]
    many = b.engine().search_many(queries, b.db10k)
    return all(np.array_equal(m.scores, b.engine().search(q, b.db10k).scores) for m, q in zip(many, queries))


def check_query_shard(b: Battery) -> bool:
    rng = np.random.default_rng(13)
    B, L = 700, 333
    subj = np.full((B, L), PAD_SUBJECT, dtype=np.int8)
    for i in range(B):
        n = int(rng.integers(5, L))
        subj[i, :n] = rng.integers(0, 25, n)
    q = rng.integers(0, 25, 500).astype(np.int8)
    mat = get_matrix("blosum50_ref")
    got = wave_query_sharded_scores(make_mesh(devices=[b.device]), q, subj, mat, gap=2)
    prof = torch.from_numpy(make_profile(q, mat, pad_rows_to=32)).to(b.device)
    want = row_sw.sw_score_bucket(prof, torch.from_numpy(subj).to(b.device), gap=2, strip=32).cpu().numpy()
    return bool(np.array_equal(got, want))


def check_prefilter(b: Battery) -> bool:
    rng = np.random.default_rng(21)
    mutants = []
    for frac in (0.1, 0.2, 0.3, 0.4, 0.5):
        m = b.q.residues.copy()
        idx = rng.choice(m.shape[0], int(frac * m.shape[0]), replace=False)
        m[idx] = rng.integers(0, 25, idx.shape[0]).astype(np.int8)
        mutants.append(m)
    db_hom = synth.database_from_arrays(b.seqs10k + mutants)
    exact5 = b.engine(top_k=5).search(b.q, db_hom).top_k(5)
    pre = b.engine(prefilter=0.05, top_k=5, prefilter_min_candidates=64).search(b.q, db_hom)
    return pre.hits == exact5


def check_queued_topk(b: Battery) -> bool:
    batch = [b.q, Query("m", b.q.residues[:96].copy(), "")]
    res = b.engine(top_k=5).search_queued(batch, b.db10k)
    full = b.engine()
    return all(r.top_k(5) == full.search(q, b.db10k).top_k(5) for q, r in zip(batch, res))


def check_evalues(b: Battery) -> bool:
    dev = b.engine(top_k=5, evalue=True).search(b.q, b.db10k).top_k_stats(5)
    full = b.engine(evalue=True).search(b.q, b.db10k).top_k_stats(5)
    return [h.id for h in dev] == [h.id for h in full] and all(
        abs(np.log(max(a.evalue, 1e-300)) - np.log(max(f.evalue, 1e-300))) <= 0.05
        and abs(a.bits - f.bits) <= 0.01 * abs(f.bits)
        for a, f in zip(dev, full)
    )


# (key, printed name, check), in tools/tpu_validate.py's order
CHECKS: Tuple[Tuple[str, str, Callable[[Battery], bool]], ...] = (
    ("subset", "subset golden (111 seqs)", check_subset),
    ("scale", "scale golden (10k seqs, oracle-verified)", check_scale),
    ("saturation", "saturation golden (scores to 29333)", check_saturation),
    ("fuzz", "kernel fuzz (random shapes/gaps/matrices)", check_fuzz),
    ("chain_fuzz", "chained-lane fuzz (n_segs vs plain and oracle)", check_chain_fuzz),
    ("affine_kernel", "affine gaps (Gotoh) vs oracle, K1", check_affine_kernel),
    ("affine_split", "affine band-carry split == full (H+F planes)", check_affine_split),
    ("affine_engine", "affine engine search == oracle (subset db)", check_affine_engine),
    ("streaming", "streaming row ladder (K3) == resident wavefront", check_streaming),
    ("search_many", "batched serving == per-query (multi-query launches)", check_search_many),
    ("query_shard", "query-shard pipeline (band carry hand-off)", check_query_shard),
    ("prefilter", "prefilter (5% of 10k) recalls planted homologs", check_prefilter),
    ("queued_topk", "queued x device top-K == full-array top-5 (10k db)", check_queued_topk),
    ("evalues", "device-moment E-values == full-array fit (log-E 5%)", check_evalues),
)


def run(keys: Optional[Sequence[str]] = None, device="cuda") -> Dict[str, bool]:
    """Run the checks named by ``keys`` (default: all), in CHECKS' order,
    printing ``NAME: OK|FAIL`` and the seconds of each; {key: passed}."""
    known = [k for k, _, _ in CHECKS]
    unknown = sorted(set(keys or ()) - set(known))
    if unknown:
        raise ValueError(f"unknown checks {unknown}; choose from {known}")
    battery = Battery(device)
    results = {}
    for key, name, fn in CHECKS:
        if keys is not None and key not in keys:
            continue
        t0 = time.perf_counter()
        results[key] = bool(fn(battery))
        print(f"{name}: {'OK' if results[key] else 'FAIL'} ({time.perf_counter() - t0:.3f} s)", flush=True)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="swtpu_torch.tools.gpu_validate", description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    p.add_argument("--checks", default=None, help="comma-separated check keys (default: all): "
                   + ",".join(k for k, _, _ in CHECKS))
    args = p.parse_args(argv)
    results = run(None if args.checks is None else args.checks.split(","), device=args.device)
    failed = [k for k, ok in results.items() if not ok]
    print("gpu_validate:", "ALL OK" if not failed else f"{len(failed)} FAILURES ({','.join(failed)})", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
