"""Randomized differential fuzz of the kernels K1, K2 and K3 on the card.

The counterpart of ``tools/tpu_fuzz.py``, extended to the port's own
launch shapes.  Every K1, K2 and K3 launch runs in one of six compiled
(G, H) shapes (``wave_sw.SHAPES``, ``bucket_sw.SHAPES``), picked by
thresholds measured on one database (``wave_sw.BAND_THREADS`` and
``BAND_THREADS_AFFINE``, ``bucket_sw.BAND_ROWS``); this tool draws the inputs that the fixed cases
of ``chip_smoke.py`` do not.

swtpu's five functions:

* ``main``: K1 linear (B1a): random lanes, widths, query lengths, gaps 1-3,
  ``blosum50`` and ``blosum50_ref``, and empty subjects;
* ``main_multi``: B1c, 2-8 queries of one padded length in one launch,
  against one launch a query;
* ``main_shard``: the query-band pipeline (``parallel.query_shard`` on
  B1d) on a mesh that names the device 1, 2 or 4 times, linear and affine;
* ``main_chain``: B1b, 2-8 subjects a lane with empty segments; pad slots
  must score 0;
* ``main_affine``: B1e, open >= extend, extend 1-3.

Added for the port:

* ``main_shapes``: every (G, H) of ``wave_sw.SHAPES`` forced (``shape=``)
  in every K1 mode, on query lengths either side of each shape's pass
  boundaries (32 G k +- 1 rows), the H = 64 sweep's odd-band 32-row tail
  and 143 bands (the suite's 4,548-residue query); B1d as a chain of
  hand-off launches over query_shard's split of the bands at n = 4
  (``band_split``, ``hand_off_chain``) from a zero carry and from a seeded one;
* ``main_rows``: K2 on (C, B, L) stacks, C in {1, 2, 3, 17}, K3 (C = 1) and
  K2's fast16 clamp, every (G, H) of ``bucket_sw.SHAPES`` forced, widths 1
  to 6,000, and a self-alignment above 32,767;
* ``main_thresholds``: the shapes the wrappers pick themselves, on buckets
  of ``BAND_THREADS`` (``BAND_THREADS_AFFINE`` under affine gaps) +- {1,
  32} (lane, segment) pairs and stacks of
  ``BAND_ROWS`` +- {1, 32} rows x C, on one device and split into n = 2, 3, 4
  lane or row shards of those sizes (as a mesh launches them), so that both
  sides of each threshold run at every n.

The reference of a case: on the card, the kernel's plain PyTorch version
(``wave_sw.sw_wave_plain``, ``row_sw``'s scorers) over the whole output,
bit for bit; on every device, the NumPy oracle (``ops.oracle.sw_score_diag``,
and its affine form ``sw_affine_score_diag``) on a strided sample of at
least 8 subjects, so that the plain version is not the only anchor.  On the
CPU the wrappers run the plain version, so only the oracle applies there.
A mismatch prints the case and its replay key; the run goes on to the next
case, prints one summary line (cases, and launches by kernel, mode and
(G, H)) and exits 1.  There is no retry and no skip.

Run: ``python -m swtpu_torch.tools.card_fuzz [--cases N] [--seed S]
[--device cuda] [--only NAME] [--case I]``
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..matrices import get_matrix
from ..models.search import resolve_device
from ..ops import bucket_sw, oracle, row_sw, wave_sw
from ..ops.profile import PAD_SUBJECT, make_profile
from ..parallel.mesh import make_mesh
from ..parallel.query_shard import wave_layout, wave_query_sharded_scores
from ..utils.bucketing import _chain_seg_cols

W = wave_sw.W
ORACLE_LANES = 8  # subjects a case samples for the NumPy oracle
FUNCTIONS = ("main", "main_multi", "main_shard", "main_chain", "main_affine", "main_shapes", "main_rows",
             "main_thresholds")
K1_MODES = ("B1a", "B1b", "B1c", "B1d", "B1e")
SHARDS = (1, 2, 3, 4)  # main_thresholds' splits
OFFSETS = (-32, -1, 1, 32)  # main_thresholds' distances from a threshold


def shape_key(shape: Tuple[int, int]) -> str:
    return "G{}H{}".format(*shape)


def random_subjects(rng: np.random.Generator, n: int, max_len: int, min_len: int = 0):
    """(n, max(max_len, 1)) int8 subjects of random lengths in [min_len,
    max_len] (0: empty), pads PAD_SUBJECT; and their lengths."""
    lens = rng.integers(min_len, max_len + 1, n)
    width = max(max_len, 1)
    res = rng.integers(0, 25, (n, width), dtype=np.int8)
    return np.where(np.arange(width) < lens[:, None], res, np.int8(PAD_SUBJECT)).astype(np.int8), lens


def chain_layout(subj: np.ndarray, n_segs: int, ws: int, lanes: int) -> np.ndarray:
    """The (n_segs * ws + 32, lanes) transposed bucket of K1: subject k in
    segment k % n_segs of lane k // n_segs (flat output slot k), the rest pad."""
    n, L = subj.shape
    if n > lanes * n_segs or L > ws:
        raise ValueError(f"{n} subjects of width {L} do not fit {lanes} lanes x {n_segs} segments of {ws}")
    flat = np.full((lanes * n_segs, ws), PAD_SUBJECT, dtype=np.int8)
    flat[:n, :L] = subj
    stack = np.full((n_segs * ws + W, lanes), PAD_SUBJECT, dtype=np.int8)
    stack[: n_segs * ws] = flat.reshape(lanes, n_segs, ws).transpose(1, 2, 0).reshape(n_segs * ws, lanes)
    return stack


def seeded_carry(rng: np.random.Generator, virgin: torch.Tensor, gaps: dict) -> torch.Tensor:
    """A carry that a band's bottom row can hold: H >= 0, and under affine
    gaps F = H - open < H."""
    h = torch.from_numpy(rng.integers(0, 80, tuple(virgin.shape[:2])).astype(np.int32)).to(virgin.device)
    if "gap_open" in gaps:
        return torch.stack([h, h - gaps["gap_open"]], dim=-1).contiguous()
    return h.contiguous()


def band_split(n_bands: int, n: int = 4) -> Tuple[int, ...]:
    """The band counts of a hand-off chain: ``n`` contiguous slices, as
    ``parallel.query_shard`` splits a query's bands over n devices; where n
    does not divide the bands the first slices take one band more, and
    fewer bands than n give one band a slice."""
    if n_bands < 1 or n < 1:
        raise ValueError("n_bands and n must be >= 1")
    k = min(n, n_bands)
    return tuple(n_bands // k + (i < n_bands % k) for i in range(k))


def hand_off_chain(fn, profile, stack, carry, n_segs, gaps, **kw):
    """A profile's bands through ``fn`` (sw_wave or sw_wave_plain) as a
    chain of hand-off launches over ``band_split``'s slices, handing
    ``carry`` on: the running max of the slices' scores and every slice's
    (scores, carry)."""
    best, steps, band = None, [], 0
    for size in band_split(profile.shape[0] // W):
        part = profile[band * W : (band + size) * W]
        band += size
        scores, carry = fn(part, stack, carry, n_segs=n_segs, return_carry=True, **gaps, **kw)
        steps.append((scores, carry.clone()))
        best = scores if best is None else torch.maximum(best, scores)
    return best, steps


class Fuzz:
    """One fuzz run: its device, and what its cases counted and found.

    ``cap`` bounds query lengths, widths and lanes (the CPU tests);
    ``keep`` keeps every case's inputs and flat scores in ``kept``."""

    def __init__(self, device="cuda", cap: Optional[int] = None, keep: bool = False):
        self.device = resolve_device(device)
        self.card = self.device.type == "cuda"
        self.cap, self.keep = cap, keep
        self.cases: collections.Counter = collections.Counter()  # function -> cases run
        self.launches: collections.Counter = collections.Counter()  # "kernel mode GxHy" -> launches
        self.max_err: Dict[str, int] = collections.defaultdict(int)  # "kernel mode" -> largest |kernel - plain|
        self.failures: List[str] = []
        self.kept: Dict[Tuple[str, int], dict] = {}
        self.sides = set()  # main_thresholds: (kernel, shards, band sweep?) of each launch
        self._wrapper_start = self._wrapper_counts() if self.card else None

    # --- helpers ---------------------------------------------------------------

    @staticmethod
    def rng(name: str, seed: int, i: int) -> np.random.Generator:
        """Case i's generator: a case replays alone (``--case``)."""
        return np.random.default_rng([seed, FUNCTIONS.index(name), i])

    def capped(self, n: int) -> int:
        return n if self.cap is None else min(n, self.cap)

    def tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def count(self, kernel: str, mode: str, shape: Tuple[int, int], n: int = 1) -> None:
        self.launches[f"{kernel} {mode} {shape_key(tuple(shape))}"] += n

    def fail(self, name: str, seed: int, i: int, params: dict, what: str) -> None:
        self.failures.append(f"{name} case {i} {params}: {what}; replay: --seed {seed} --case {i} --only {name}")
        print("MISMATCH " + self.failures[-1], flush=True)

    def versus_plain(self, where, kernel: str, mode: str, got: torch.Tensor, want: Optional[torch.Tensor]) -> bool:
        """On the card, ``got`` (a kernel's) against ``want`` (its plain
        version's) over the whole output, bit for bit."""
        if not self.card:
            return True
        same_shape = tuple(got.shape) == tuple(want.shape)
        err = int((got.long() - want.long()).abs().max()) if same_shape and got.numel() else 0
        key = f"{kernel} {mode}"
        self.max_err[key] = max(self.max_err[key], err)
        if same_shape and torch.equal(got, want):
            return True
        self.fail(*where, f"{kernel} {mode} != plain ({tuple(got.shape)} vs {tuple(want.shape)}, max err {err})")
        return False

    def versus_oracle(self, where, scores: np.ndarray, queries: Sequence[np.ndarray], subj: np.ndarray,
                      lens: np.ndarray, mat: np.ndarray, gaps: dict, also: Sequence[int] = ()) -> bool:
        """``scores`` (n,) or (Q, n) against the NumPy oracle on a strided
        sample of the n subjects and on ``also`` (subject j against query
        j % Q)."""
        n = subj.shape[0]
        if n == 0:
            return True
        flat = scores.reshape(-1, n)
        sample = np.linspace(0, n - 1, min(n, ORACLE_LANES)).astype(np.int64)
        for j in np.unique(np.concatenate([sample, np.asarray(also, dtype=np.int64)])):
            k = int(j) % flat.shape[0]
            s = subj[j, : lens[j]]
            if "gap_open" in gaps:
                want = oracle.sw_affine_score_diag(queries[k], s, mat, gaps["gap_open"], gaps["gap_extend"])
            else:
                want = oracle.sw_score_diag(queries[k], s, mat, gaps["gap"])
            if int(flat[k, j]) != want:
                self.fail(*where, f"subject {int(j)} query {k}: {int(flat[k, j])} != oracle {want}")
                return False
        return True

    def keep_case(self, name: str, i: int, **case) -> None:
        if self.keep:
            self.kept[(name, i)] = case

    @staticmethod
    def _wrapper_counts() -> Dict[str, int]:
        return {"K1": wave_sw.sw_wave.launches, "K2": bucket_sw.sw_score_bucket_fused.launches,
                "K3": bucket_sw.sw_score_bucket.launches}

    def summary(self, seconds: float) -> dict:
        """The run's one summary: cases, launches by kernel, mode and (G,
        H), and on the card the wrappers' own launch counts, which must
        equal this run's."""
        by_kernel = collections.Counter()
        for key, n in self.launches.items():
            by_kernel[key.split()[0]] += n
        out = dict(device=str(self.device), cases=dict(self.cases), case_total=sum(self.cases.values()),
                   launches=dict(sorted(self.launches.items())), launch_total=sum(self.launches.values()),
                   failures=len(self.failures), max_abs_err=dict(self.max_err), tolerance="exact",
                   seconds=round(seconds, 3))
        if self.card:
            now = self._wrapper_counts()
            counted = {k: now[k] - self._wrapper_start[k] for k in now}
            out["wrapper_launches"] = counted
            if counted != {k: by_kernel.get(k, 0) for k in counted}:
                self.failures.append(f"the wrappers counted {counted} launches, the fuzz {dict(by_kernel)}")
                out["failures"] = len(self.failures)
        return out

    # --- K1 ----------------------------------------------------------------------

    def k1(self, where, mode: str, queries: List[np.ndarray], subj, lens, mat_name: str, gaps: dict, n_segs: int,
           ws: int, lanes: int, qpad: int = W, shapes: Sequence = (None,)) -> np.ndarray:
        """K1 on the subjects chained ``n_segs`` a lane: one query, or a
        (Q, qpad, 32) stack for several; each of ``shapes`` (None: the
        wrapper's) against the plain version, pad slots 0, the oracle sample.
        Returns the flat (n,) or (Q, n) scores."""
        mat = get_matrix(mat_name)
        profs = [make_profile(q, mat, pad_rows_to=qpad) for q in queries]
        prof = self.tensor(profs[0] if len(queries) == 1 else np.stack(profs))
        stack = self.tensor(chain_layout(subj, n_segs, ws, lanes))
        n, n_bands, affine = subj.shape[0], prof.shape[-2] // W, "gap_open" in gaps
        want = wave_sw.sw_wave_plain(prof, stack, n_segs=n_segs, **gaps) if self.card else None
        first = None
        for shape in shapes:
            got = wave_sw.sw_wave(prof, stack, n_segs=n_segs, shape=shape, **gaps)
            self.count("K1", mode, shape or wave_sw.wave_shape(n_bands, lanes, n_segs, affine))
            self.versus_plain(where, "K1", mode, got, want)
            if bool((got[..., n:] != 0).any()):
                self.fail(*where, f"K1 {mode} shape {shape}: a pad slot scored")
            first = got if first is None else first
        flat = first.cpu().numpy()[..., :n]
        self.versus_oracle(where, flat, queries, subj, lens, mat, gaps)
        return flat


# --- swtpu's five functions -------------------------------------------------------------


def _cases(fz: Fuzz, name: str, n_cases: int, case: Optional[int]):
    for i in range(n_cases) if case is None else (case,):
        fz.cases[name] += 1
        yield i


def _finish(fz: Fuzz, own: bool, n_fail: int, t0: float) -> int:
    if own:
        print("card_fuzz: " + json.dumps(fz.summary(time.perf_counter() - t0)), flush=True)
    return 1 if len(fz.failures) > n_fail else 0


def _fuzz(fuzz: Optional[Fuzz], device) -> Tuple[Fuzz, bool]:
    return (fuzz, False) if fuzz is not None else (Fuzz(device), True)


def main(n_cases: int = 14, seed: int = 123, *, device="cuda", fuzz: Optional[Fuzz] = None,
         case: Optional[int] = None) -> int:
    """K1 linear (B1a) on random buckets; 0 if every case agrees, else 1."""
    fz, own = _fuzz(fuzz, device)
    t0, n_fail = time.perf_counter(), len(fz.failures)
    for i in _cases(fz, "main", n_cases, case):
        rng = fz.rng("main", seed, i)
        L = fz.capped(int(rng.choice([32, 96, 160, 288, 480, 800, 1376])))
        B = fz.capped(int(rng.choice([128, 256, 512, 1024])))
        Q = fz.capped(int(rng.integers(5, 700)))
        gap = int(rng.choice([1, 2, 3]))
        mat = "blosum50_ref" if i % 3 else "blosum50"
        subj, lens = random_subjects(rng, B, L)
        q = rng.integers(0, 25, Q).astype(np.int8)
        params = dict(B=B, L=L, Q=Q, gap=gap, matrix=mat)
        scores = fz.k1(("main", seed, i, params), "B1a", [q], subj, lens, mat, dict(gap=gap), 1, L, B)
        fz.keep_case("main", i, queries=[q], subjects=subj, matrix=mat, gaps=dict(gap=gap), scores=scores)
    return _finish(fz, own, n_fail, t0)


def main_multi(n_cases: int = 4, seed: int = 321, *, device="cuda", fuzz: Optional[Fuzz] = None,
               case: Optional[int] = None) -> int:
    """B1c: 2-8 queries of one padded length in one launch, against one
    launch a query and the plain version."""
    fz, own = _fuzz(fuzz, device)
    t0, n_fail = time.perf_counter(), len(fz.failures)
    for i in _cases(fz, "main_multi", n_cases, case):
        rng = fz.rng("main_multi", seed, i)
        L = fz.capped(int(rng.choice([96, 288, 480])))
        B = fz.capped(int(rng.choice([256, 512])))
        nq = int(rng.integers(2, 9))
        qpad = int(rng.choice([64, 160, 320]))
        if fz.cap is not None:
            qpad = max(W, min(qpad, fz.cap // W * W))
        gap = int(rng.choice([1, 2]))
        subj, lens = random_subjects(rng, B, L)
        queries = [rng.integers(0, 25, int(rng.integers(qpad - 31, qpad + 1))).astype(np.int8) for _ in range(nq)]
        params = dict(B=B, L=L, nq=nq, qpad=qpad, gap=gap)
        where = ("main_multi", seed, i, params)
        multi = fz.k1(where, "B1c", queries, subj, lens, "blosum50_ref", dict(gap=gap), 1, L, B, qpad=qpad)
        stack = fz.tensor(chain_layout(subj, 1, L, B))
        for k, q in enumerate(queries):
            single = wave_sw.sw_wave(fz.tensor(make_profile(q, get_matrix("blosum50_ref"), pad_rows_to=qpad)),
                                     stack, gap=gap)
            fz.count("K1", "B1a", wave_sw.wave_shape(qpad // W, B, 1))
            if not np.array_equal(single.cpu().numpy(), multi[k]):
                fz.fail(*where, f"query {k}: the multi-query launch != its single launch")
        fz.keep_case("main_multi", i, queries=queries, subjects=subj, matrix="blosum50_ref", gaps=dict(gap=gap),
                     scores=multi)
    return _finish(fz, own, n_fail, t0)


def main_shard(n_cases: int = 3, seed: int = 555, *, device="cuda", fuzz: Optional[Fuzz] = None,
               case: Optional[int] = None) -> int:
    """The query-band pipeline (B1d hand-offs between pipeline stages) on a
    mesh that names the device n = 1, 2 or 4 times, linear and affine."""
    fz, own = _fuzz(fuzz, device)
    t0, n_fail = time.perf_counter(), len(fz.failures)
    for i in _cases(fz, "main_shard", n_cases, case):
        rng = fz.rng("main_shard", seed, i)
        L = fz.capped(int(rng.choice([150, 333, 700])))
        B = fz.capped(int(rng.integers(100, 900)))
        Q = fz.capped(int(rng.integers(40, 600)))
        n = int(rng.choice([1, 2, 4]))
        gaps = dict(gap=int(rng.choice([1, 2]))) if i % 2 == 0 else dict(gap_open=11, gap_extend=1)
        subj, lens = random_subjects(rng, B, L)
        q = rng.integers(0, 25, Q).astype(np.int8)
        mat = get_matrix("blosum50_ref")
        params = dict(B=B, L=L, Q=Q, n=n, **gaps)
        where = ("main_shard", seed, i, params)
        got = wave_query_sharded_scores(make_mesh(devices=[fz.device] * n), q, subj, mat, **gaps)
        subjT, bt = wave_layout(subj)
        prof = make_profile(q, mat, pad_rows_to=W * n)
        shape = wave_sw.wave_shape(prof.shape[0] // (W * n), bt, 1, "gap_open" in gaps)
        fz.count("K1", "B1d", shape, n * (subjT.shape[1] // bt))
        if fz.card:
            want = wave_sw.sw_wave_plain(fz.tensor(prof), fz.tensor(subjT), **gaps)[:B]
            fz.versus_plain(where, "K1", "B1d", fz.tensor(got), want)
        fz.versus_oracle(where, got, [q], subj, lens, mat, gaps)
        fz.keep_case("main_shard", i, queries=[q], subjects=subj, matrix="blosum50_ref", gaps=gaps, scores=got)
    return _finish(fz, own, n_fail, t0)


def main_chain(n_cases: int = 6, seed: int = 777, *, device="cuda", fuzz: Optional[Fuzz] = None,
               case: Optional[int] = None) -> int:
    """B1b: subjects chained 2-8 a lane with empty segments; every flat
    slot bit-exact and the pad slots 0."""
    fz, own = _fuzz(fuzz, device)
    t0, n_fail = time.perf_counter(), len(fz.failures)
    for i in _cases(fz, "main_chain", n_cases, case):
        rng = fz.rng("main_chain", seed, i)
        S = int(rng.choice([2, 3, 4, 6, 8]))
        max_len = fz.capped(int(rng.choice([48, 96, 150, 224])))
        ws = _chain_seg_cols(max_len, S) or max_len
        lanes = fz.capped(int(rng.choice([128, 256])))
        Q = fz.capped(int(rng.integers(5, 500)))
        gap = int(rng.choice([1, 2, 3]))
        mat = "blosum50_ref" if i % 2 else "blosum50"
        n_subj = lanes * S - int(rng.integers(0, lanes))
        subj, lens = random_subjects(rng, n_subj, max_len)
        q = rng.integers(0, 25, Q).astype(np.int8)
        params = dict(S=S, ws=ws, lanes=lanes, n_subj=n_subj, Q=Q, gap=gap, matrix=mat)
        scores = fz.k1(("main_chain", seed, i, params), "B1b", [q], subj, lens, mat, dict(gap=gap), S, ws, lanes)
        fz.keep_case("main_chain", i, queries=[q], subjects=subj, matrix=mat, gaps=dict(gap=gap), scores=scores)
    return _finish(fz, own, n_fail, t0)


def main_affine(n_cases: int = 5, seed: int = 888, *, device="cuda", fuzz: Optional[Fuzz] = None,
                case: Optional[int] = None) -> int:
    """B1e: affine gaps, open >= extend, extend 1-3, query lengths across
    band boundaries, empty subjects."""
    fz, own = _fuzz(fuzz, device)
    t0, n_fail = time.perf_counter(), len(fz.failures)
    for i in _cases(fz, "main_affine", n_cases, case):
        rng = fz.rng("main_affine", seed, i)
        L = fz.capped(int(rng.choice([96, 224, 480])))
        B = fz.capped(128)
        Q = fz.capped(int(rng.integers(5, 400)))
        ext = int(rng.integers(1, 4))
        gaps = dict(gap_open=ext + int(rng.integers(0, 12)), gap_extend=ext)
        mat = "blosum50_ref" if i % 2 else "blosum50"
        subj, lens = random_subjects(rng, B, L)
        q = rng.integers(0, 25, Q).astype(np.int8)
        params = dict(B=B, L=L, Q=Q, matrix=mat, **gaps)
        scores = fz.k1(("main_affine", seed, i, params), "B1e", [q], subj, lens, mat, gaps, 1, L, B)
        fz.keep_case("main_affine", i, queries=[q], subjects=subj, matrix=mat, gaps=gaps, scores=scores)
    return _finish(fz, own, n_fail, t0)


# --- the port's shapes ----------------------------------------------------------------


def shape_query_lengths() -> Tuple[int, ...]:
    """Query lengths across every shape's pass boundaries: 32 G k +- 1
    rows (k = 1, 2; a pass is G H rows), 96 rows (three bands: the H = 64
    sweep's odd-band 32-row tail) and 4,548 (143 bands)."""
    lens = {g * h * k + d for g, h in wave_sw.SHAPES for k in (1, 2) for d in (-1, 1)}
    return tuple(sorted(lens | {3 * W, 4548}))


def main_shapes(n_cases: Optional[int] = None, seed: int = 999, *, device="cuda", fuzz: Optional[Fuzz] = None,
                case: Optional[int] = None) -> int:
    """Every (G, H) of ``wave_sw.SHAPES`` forced in every K1 mode, on every
    length of ``shape_query_lengths`` (case i: mode i // lengths, length
    i % lengths)."""
    fz, own = _fuzz(fuzz, device)
    t0, n_fail = time.perf_counter(), len(fz.failures)
    qlens = [n for n in shape_query_lengths() if fz.cap is None or n <= fz.cap]
    total = len(K1_MODES) * len(qlens)
    for i in _cases(fz, "main_shapes", total if n_cases is None else min(n_cases, total), case):
        mode, qlen = K1_MODES[i // len(qlens)], qlens[i % len(qlens)]
        rng = fz.rng("main_shapes", seed, i)
        lanes = int(rng.integers(33, 301))
        ws = int(rng.integers(6, 65))
        S = {"B1a": 1, "B1b": int(rng.choice([2, 3, 8]))}.get(mode, int(rng.choice([1, 3])))
        affine = mode == "B1e" or (mode == "B1d" and i % 2 == 1)
        ext = int(rng.integers(1, 4))
        gaps = dict(gap_open=ext + int(rng.integers(0, 12)), gap_extend=ext) if affine else dict(
            gap=int(rng.choice([1, 2, 3])))
        nq = int(rng.choice([2, 3])) if mode == "B1c" else 1
        queries = [rng.integers(0, 25, max(1, qlen - k)).astype(np.int8) for k in range(nq)]
        subj, lens = random_subjects(rng, lanes * S - int(rng.integers(0, lanes)), ws)
        params = dict(mode=mode, qlen=qlen, lanes=lanes, ws=ws, S=S, nq=nq, **gaps)
        where = ("main_shapes", seed, i, params)
        qpad = -(-qlen // W) * W
        if mode != "B1d":
            scores = fz.k1(where, mode, queries, subj, lens, "blosum50_ref", gaps, S, ws, lanes, qpad=qpad,
                           shapes=wave_sw.SHAPES)
        else:
            scores = _hand_off_case(fz, where, rng, queries[0], subj, lens, gaps, S, ws, lanes)
        fz.keep_case("main_shapes", i, queries=queries, subjects=subj, matrix="blosum50_ref", gaps=gaps,
                     scores=scores)
    return _finish(fz, own, n_fail, t0)


def _hand_off_case(fz: Fuzz, where, rng, q, subj, lens, gaps, S, ws, lanes) -> np.ndarray:
    """B1d at every shape: the hand-off chain from a zero and from a seeded
    carry, every slice's scores and carry against the plain chain's; the
    zero chain's running max against the oracle."""
    mat = get_matrix("blosum50_ref")
    prof = fz.tensor(make_profile(q, mat, pad_rows_to=W))
    stack = fz.tensor(chain_layout(subj, S, ws, lanes))
    virgin = wave_sw.virgin_carry(stack, "gap_open" in gaps)
    starts = (virgin, seeded_carry(rng, virgin, gaps))
    plain = [hand_off_chain(wave_sw.sw_wave_plain, prof, stack, c.clone(), S, gaps)[1] for c in starts] if fz.card else None
    split = band_split(prof.shape[0] // W)
    best = None
    for shape in wave_sw.SHAPES:
        for k, start in enumerate(starts):
            run_best, steps = hand_off_chain(wave_sw.sw_wave, prof, stack, start.clone(), S, gaps, shape=shape)
            fz.count("K1", "B1d", shape, len(steps))
            best = run_best if best is None else best
            for r, (s, c) in enumerate(steps):
                at = {**where[3], "shape": shape_key(shape), "start": ("zero", "seeded")[k], "slice": f"{r} of {split}"}
                if fz.card:
                    fz.versus_plain((*where[:3], at), "K1", "B1d", s, plain[k][r][0])
                    fz.versus_plain((*where[:3], at), "K1", "B1d", c, plain[k][r][1])
    if bool((best[subj.shape[0]:] != 0).any()):
        fz.fail(*where, "B1d: a pad slot scored")
    flat = best.cpu().numpy()[: subj.shape[0]]
    fz.versus_oracle(where, flat, [q], subj, lens, mat, gaps)
    return flat


ROW_QUERY_LENGTHS = (1, 20, 31, 33, 100, 464, 511, 513, 1000, 1025)
SELF_RESIDUES = np.array([4, 8, 14, 17], dtype=np.int8)  # C, H, P, W: 10-15 against themselves


def main_rows(n_cases: int = 10, seed: int = 1010, *, device="cuda", fuzz: Optional[Fuzz] = None,
              case: Optional[int] = None) -> int:
    """K2 on (C, B, L) stacks and K3 on one of their buckets, at every
    (G, H) of ``bucket_sw.SHAPES`` and at the wrapper's, and K2's fast16
    clamp; case 0 plants a 4,548-residue query in a row, its
    self-alignment above 32,767."""
    fz, own = _fuzz(fuzz, device)
    t0, n_fail = time.perf_counter(), len(fz.failures)
    for i in _cases(fz, "main_rows", n_cases, case):
        rng = fz.rng("main_rows", seed, i)
        mat_name = "blosum50_ref" if i % 2 else "blosum50"
        mat = get_matrix(mat_name)
        gap = int(rng.choice([1, 2, 11]))
        C = int(rng.choice([1, 2, 3, 17]))
        planted = i == 0 and fz.cap is None
        if planted:
            qlen, C, B, L, gap = 4548, 3, 9, 4600, 2
            q = rng.choice(SELF_RESIDUES, qlen)
            stack, lens = random_subjects(rng, C * B, 64)
            stack = np.pad(stack, ((0, 0), (0, L - stack.shape[1])), constant_values=PAD_SUBJECT)
            stack[B + 0, :qlen], lens[B + 0] = q, qlen  # chunk 1, row 0
        else:
            L = fz.capped(int(np.exp(rng.uniform(0, np.log(6000)))) + 1)
            qlen = fz.capped(int(rng.choice(ROW_QUERY_LENGTHS)))
            if L > 1000:
                qlen = min(qlen, 600)
            # at most 4M cells a stack and 4e9 a launch: the plain version and the oracle stay quick
            B = fz.capped(max(1, min(int(rng.integers(1, 301)), 4_000_000 // (C * L), 4_000_000_000 // (C * L * qlen))))
            q = rng.integers(0, 25, qlen).astype(np.int8)
            stack, lens = random_subjects(rng, C * B, L)
        params = dict(qlen=qlen, C=C, B=B, L=L, gap=gap, matrix=mat_name)
        where = ("main_rows", seed, i, params)
        prof = fz.tensor(make_profile(q, mat, pad_rows_to=W))
        dev_stack = fz.tensor(stack.reshape(C, B, L))
        n_bands = prof.shape[0] // W
        want = row_sw.sw_score_stack(prof, dev_stack, gap=gap, strip=W) if fz.card else None
        for shape in bucket_sw.SHAPES + (None,):
            got = bucket_sw.sw_score_bucket_fused(prof, dev_stack, gap=gap, shape=shape)
            fz.count("K2", "stack", shape or bucket_sw.rows_shape(n_bands, C * B))
            fz.versus_plain(where, "K2", "stack", got, want)
            one = bucket_sw.sw_score_bucket(prof, dev_stack[C - 1], gap=gap, shape=shape)
            fz.count("K3", "bucket", shape or bucket_sw.rows_shape(n_bands, B))
            fz.versus_plain(where, "K3", "bucket", one, None if want is None else want[C - 1])
        sat = row_sw.fast16_sat(gap, L)
        if sat > 0:  # the fast16 contract holds only for a bucket narrow enough for int16
            clamp = bucket_sw.sw_score_bucket_fast16(prof, dev_stack[0], gap=gap, sat=sat)
            fz.count("K2", "fast16", bucket_sw.rows_shape(n_bands, B))
            if fz.card:
                fz.versus_plain(where, "K2", "fast16", clamp, row_sw.sw_score_bucket_fast16(
                    prof, dev_stack[0], gap=gap, strip=W, sat=sat, stage_int8=int(mat.max()) + gap <= 127))
        scores = got.reshape(-1).cpu().numpy()
        if planted and int(scores.max()) <= 32767:
            fz.fail(*where, f"the planted self-alignment scored {int(scores.max())}, within int16")
        fz.versus_oracle(where, scores, [q], stack, lens, mat, dict(gap=gap), also=[B] if planted else ())
        fz.keep_case("main_rows", i, queries=[q], subjects=stack, matrix=mat_name, gaps=dict(gap=gap), scores=scores)
    return _finish(fz, own, n_fail, t0)


def main_thresholds(n_cases: Optional[int] = None, seed: int = 1111, *, device="cuda",
                    fuzz: Optional[Fuzz] = None, case: Optional[int] = None) -> int:
    """The wrappers' own shape choice on both sides of ``BAND_THREADS``
    (K1) and ``BAND_ROWS`` (K2, K3): case i is (kernel, n, d) of the
    product K1/K2 x SHARDS x OFFSETS, a bucket of n (T + d) (lane, segment)
    pairs or rows x C, launched whole and as n shards of T + d."""
    fz, own = _fuzz(fuzz, device)
    t0, n_fail = time.perf_counter(), len(fz.failures)
    grid = [(k, n, d) for k in ("K1", "K2") for n in SHARDS for d in OFFSETS]
    for i in _cases(fz, "main_thresholds", len(grid) if n_cases is None else min(n_cases, len(grid)), case):
        kernel, n, d = grid[i]
        rng = fz.rng("main_thresholds", seed, i)
        qlen = int(rng.integers(40, 129))  # 2-4 bands: the wavefront side runs G = 2 or 4
        q = rng.integers(0, 25, qlen).astype(np.int8)
        mat = get_matrix("blosum50_ref")
        if kernel == "K1":
            _threshold_k1(fz, ("main_thresholds", seed, i, dict(kernel=kernel, n=n, d=d, qlen=qlen)), rng, q, mat, n, d)
        else:
            _threshold_rows(fz, ("main_thresholds", seed, i, dict(kernel=kernel, n=n, d=d, qlen=qlen)), rng, q, mat, n, d)
    if case is None and n_cases is None:
        for kernel in ("K1", "K2"):
            for n in SHARDS:
                missed = [side for side in (False, True) if (kernel, n, side) not in fz.sides]
                if missed:
                    fz.failures.append(f"main_thresholds: {kernel} at n = {n} never ran "
                                       f"{' and '.join(('the wavefront', 'the band sweep')[s] for s in missed)}")
                    print("MISMATCH " + fz.failures[-1], flush=True)
    return _finish(fz, own, n_fail, t0)


def _shards(total: int, n: int) -> List[Tuple[int, int]]:
    step = total // n
    return [(k * step, (k + 1) * step) for k in range(n)]


def _threshold_k1(fz: Fuzz, where, rng, q, mat, n: int, d: int) -> None:
    affine = where[2] % 2 == 1
    T = wave_sw.BAND_THREADS_AFFINE if affine else wave_sw.BAND_THREADS
    pairs = T + d  # a shard's (lane, segment) pairs
    S = 1 if pairs % 2 else 2
    lanes = n * (pairs // S)
    ws = int(rng.integers(8, 41))
    gaps = dict(gap_open=10, gap_extend=2) if affine else dict(gap=2)
    subj, lens = random_subjects(rng, lanes * S, ws)
    prof = fz.tensor(make_profile(q, mat, pad_rows_to=W))
    stack = fz.tensor(chain_layout(subj, S, ws, lanes))
    n_bands = prof.shape[0] // W
    whole = wave_sw.sw_wave(prof, stack, n_segs=S, **gaps)
    shape = wave_sw.wave_shape(n_bands, lanes, S, affine, band_threads=T)
    fz.count("K1", "B1e" if affine else ("B1b" if S > 1 else "B1a"), shape)
    if n == 1:
        fz.sides.add(("K1", 1, shape[0] == 1))
    if fz.card:
        fz.versus_plain(where, "K1", "B1e" if affine else ("B1b" if S > 1 else "B1a"), whole,
                        wave_sw.sw_wave_plain(prof, stack, n_segs=S, **gaps))
    if n > 1:
        parts = []
        for lo, hi in _shards(lanes, n):
            part = stack[:, lo:hi].contiguous()
            parts.append(wave_sw.sw_wave(prof, part, n_segs=S, **gaps))
            sh = wave_sw.wave_shape(n_bands, hi - lo, S, affine, band_threads=T)
            fz.count("K1", "B1e" if affine else ("B1b" if S > 1 else "B1a"), sh)
            fz.sides.add(("K1", n, sh[0] == 1))
        if not torch.equal(torch.cat(parts), whole):
            fz.fail(*where, f"{n} lane shards != the whole bucket")
    fz.versus_oracle(where, whole.cpu().numpy(), [q], subj, lens, mat, gaps)


def _threshold_rows(fz: Fuzz, where, rng, q, mat, n: int, d: int) -> None:
    R = bucket_sw.BAND_ROWS
    rows = R + d  # a shard's rows x C
    C = 1 if rows % 2 else 2
    B = n * (rows // C)
    L = int(rng.integers(16, 65))
    gap = 2
    subj, lens = random_subjects(rng, C * B, L)
    prof = fz.tensor(make_profile(q, mat, pad_rows_to=W))
    stack = fz.tensor(subj.reshape(C, B, L))
    n_bands = prof.shape[0] // W
    whole = bucket_sw.sw_score_bucket_fused(prof, stack, gap=gap)
    shape = bucket_sw.rows_shape(n_bands, C * B, band_rows=R)
    fz.count("K2", "stack", shape)
    if n == 1:
        fz.sides.add(("K2", 1, shape[0] == 1))
    if fz.card:
        fz.versus_plain(where, "K2", "stack", whole, row_sw.sw_score_stack(prof, stack, gap=gap, strip=W))
    if n > 1:
        parts = []
        for lo, hi in _shards(B, n):
            part = stack[:, lo:hi].contiguous()
            parts.append(bucket_sw.sw_score_bucket_fused(prof, part, gap=gap))
            sh = bucket_sw.rows_shape(n_bands, C * (hi - lo), band_rows=R)
            fz.count("K2", "stack", sh)
            fz.sides.add(("K2", n, sh[0] == 1))
            if C == 1:  # K3 takes the same shard
                one = bucket_sw.sw_score_bucket(prof, part[0], gap=gap)
                fz.count("K3", "bucket", bucket_sw.rows_shape(n_bands, hi - lo, band_rows=R))
                if not torch.equal(one, parts[-1][0]):
                    fz.fail(*where, f"K3 on row shard [{lo}, {hi}) != K2")
        if not torch.equal(torch.cat(parts, dim=1), whole):
            fz.fail(*where, f"{n} row shards != the whole stack")
    fz.versus_oracle(where, whole.reshape(-1).cpu().numpy(), [q], subj, lens, mat, dict(gap=gap))


def run(functions: Sequence[str] = FUNCTIONS, *, n_cases: Optional[int] = None, seed: Optional[int] = None,
        device="cuda", case: Optional[int] = None, fuzz: Optional[Fuzz] = None) -> Tuple[int, dict]:
    """Run ``functions`` (names of this module's) on one Fuzz: (0 or 1, the
    summary).  ``n_cases`` and ``seed`` replace each function's defaults."""
    fz = fuzz or Fuzz(device)
    t0 = time.perf_counter()
    kw = dict(fuzz=fz, case=case)
    if n_cases is not None:
        kw["n_cases"] = n_cases
    if seed is not None:
        kw["seed"] = seed
    rc = 0
    for name in functions:
        rc |= globals()[name](**kw)
    summary = fz.summary(time.perf_counter() - t0)
    return (1 if rc or fz.failures else 0), summary


def cli(argv=None) -> int:
    p = argparse.ArgumentParser(prog="swtpu_torch.tools.card_fuzz", description=__doc__.splitlines()[0])
    p.add_argument("--cases", type=int, default=None, help="cases a function (default: each function's own)")
    p.add_argument("--seed", type=int, default=None, help="seed of every function (default: each function's own)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu checks the oracle only)")
    p.add_argument("--only", default=None, help="comma-separated function names (default: all)")
    p.add_argument("--case", type=int, default=None, help="run only case I of each function (a replay)")
    args = p.parse_args(argv)
    names = FUNCTIONS if args.only is None else tuple(args.only.split(","))
    unknown = [n for n in names if n not in FUNCTIONS]
    if unknown:
        p.error(f"unknown function(s) {unknown}; choose from {FUNCTIONS}")
    rc, summary = run(names, n_cases=args.cases, seed=args.seed, device=args.device, case=args.case)
    print("card_fuzz: " + json.dumps(summary), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(cli())
