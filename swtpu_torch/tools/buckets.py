"""P01008's wavefront buckets and row-path groups on the SwissProt-shaped database, for the lab tools.

The database is ``chip_smoke.py``'s (``synth.synth_database``: 559,228
sequences, seed 0) and the buckets are the engine's own plan, packed on the
card, as ``wave_ab.py`` takes them: 27 buckets for P01008.  A bucket is
"narrow" below 1,024 threads (lanes x segments), "full" from 20,000, and
"mid" between: at this scale that is PERF.md's 5 narrow, 11 mid and 11 full
buckets, the full ones 71% of the cells.  ``main`` is the wavefront lab
tools' run (``wave_lab``, ``probe_breakdown``): each names its variants.
K4 takes the profile padded to its band height; K1, K5 and K6 take K1's
own 32-row-band profile, K5 and K6 sweeping it in bands of
``wave_lab.SWEEP_HEIGHT``.  ``run`` times every variant in ``ROUNDS``
rounds; a bucket's time is the median of its rounds.

The row path's groups (``swissprot_rows``) are the ladder groups of the
engine's row-path pack (``use_wave=False``): 13 (chunks, rows, width) stacks
that K2 scores for P01008, beside the segment-packed groups of the short
sequences, which the PyTorch seg16 scorer takes.  ``run`` times them the same
way, K2 first (``pallas_lab``).
"""

from __future__ import annotations

import dataclasses
import statistics
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import synth
from ..config import SWConfig
from ..io.fasta import Database, Query, parse_query
from ..models.search import SearchEngine
from ..ops import wave_lab, wave_sw
from ..ops.profile import make_profile
from ..utils.bucketing import PackedDatabase, PackedGroup, WaveGroup
from .roofline import card, events_ms

QUERIES = Path(__file__).resolve().parents[2] / "tests" / "data" / "queries"
N_SEQS = 559_228
QUERY = "P01008"
NARROW_THREADS, FULL_THREADS = 1024, 20_000
GROUPS = ("narrow", "mid", "full")
ROUNDS = 3  # timed rounds of every variant on every bucket: a bucket's time is their median


@dataclasses.dataclass
class Buckets:
    db: Database
    engine: SearchEngine
    query: Query
    groups: List[WaveGroup]  # the engine's wave buckets, resident on its device

    @property
    def gap(self) -> int:
        return self.engine.config.gap_penalty

    def profile(self, height: int = wave_sw.W) -> torch.Tensor:
        """The query's profile on the device, its rows a multiple of ``height``."""
        prof = make_profile(self.query.residues, self.engine.matrix, pad_rows_to=height)
        return torch.from_numpy(prof).to(self.engine.device)

    def reduce(self, flats: Sequence[torch.Tensor]) -> np.ndarray:
        """One flat score array a bucket, scattered back to file order."""
        packed = self.engine._resident_packed(self.db)
        return self.engine._reduce_flat(torch.cat(list(flats)).cpu().numpy(), packed)


def swissprot_query() -> Query:
    """The lab's query, P01008 (464 residues)."""
    return parse_query(QUERIES / f"{QUERY}.fasta")


def swissprot_buckets(db: Optional[Database] = None, engine: Optional[SearchEngine] = None) -> Buckets:
    """P01008's buckets; ``db`` and ``engine`` default to the SwissProt-shaped
    database and a default engine on the card."""
    db = synth.synth_database(N_SEQS, seed=0) if db is None else db
    engine = SearchEngine(SWConfig(), device="cuda") if engine is None else engine
    groups = list(engine._resident_packed(db).wave_groups)
    return Buckets(db=db, engine=engine, query=swissprot_query(), groups=groups)


def group_of(g: WaveGroup) -> str:
    """"narrow", "mid" or "full", by the bucket's thread count."""
    return "narrow" if g.rows < NARROW_THREADS else "full" if g.rows >= FULL_THREADS else "mid"


Variants = Dict[str, Tuple[Callable[..., torch.Tensor], dict]]  # name: (ops/wave_lab.py wrapper, its keywords)


def height(kw: dict) -> int:
    """A variant's band height, as its plain version takes it: K4's
    ``height`` keyword, else K1's band sweep's (K5, K6)."""
    return kw.get("height", wave_lab.SWEEP_HEIGHT)


def pad(kw: dict) -> int:
    """The multiple a variant's profile rows are padded to: K4's height,
    else K1's 32-row bands (K1 and its forced schedules, K5, K6)."""
    return kw.get("height", wave_sw.W)


def skip(kw: dict) -> str:
    """A variant's dropped stage: its ``skip`` keyword, else "none"."""
    return kw.get("skip", "none")


def launches(b: Buckets, variants: Variants) -> Dict[str, Callable[[WaveGroup], torch.Tensor]]:
    """K1, then every variant, each a launch on one bucket (a variant's
    profile padded as ``pad`` says)."""
    prof = {h: b.profile(h) for h in wave_lab.HEIGHTS}
    out = {"K1": lambda g: wave_sw.sw_wave(prof[wave_sw.W], g.stack, gap=b.gap, n_segs=g.n_segs)}
    for name, (fn, kw) in variants.items():
        out[name] = lambda g, fn=fn, kw=kw: fn(prof[pad(kw)], g.stack, gap=b.gap, n_segs=g.n_segs, **kw)
    return out


def run(groups: Sequence, launches: Dict[str, Callable]) -> Dict:
    """Every named launch on every bucket in ``ROUNDS`` rounds.  In a round,
    bucket by bucket, an untimed launch of the first name (the production
    kernel, K1 or K2) brings the bucket into L2, then every named launch
    runs once in turns, timed with CUDA events, so the variants of a bucket
    are timed at nearly the same moment; a variant launches ``ROUNDS`` times
    a bucket.  Returns {"rounds": [{name: one score array a bucket}] a
    round, "times": {name: the median ms of a bucket's rounds, a bucket},
    "round_ms": {name: [ms of all buckets] a round}, "spread_ms": {name: the
    largest round sum minus the smallest}}: a host stall inside one event
    pair shows as spread, not as a time."""
    names = list(launches)
    warm = launches[names[0]]
    per_round: List[Dict[str, List[torch.Tensor]]] = []
    ms: Dict[str, List[List[float]]] = {name: [[] for _ in groups] for name in names}  # [bucket][round]
    for _ in range(ROUNDS):
        flats: Dict[str, List[torch.Tensor]] = {name: [] for name in names}
        for k, g in enumerate(groups):
            warm(g)
            for name, launch in launches.items():
                t, out = events_ms(lambda: launch(g))
                flats[name].append(out)
                ms[name][k].append(t)
        per_round.append(flats)
    round_ms = {name: [sum(b[r] for b in ms[name]) for r in range(ROUNDS)] for name in names}
    return {"rounds": per_round, "times": {name: [statistics.median(b) for b in ms[name]] for name in names},
            "round_ms": round_ms, "spread_ms": {name: max(v) - min(v) for name, v in round_ms.items()}}


def unequal_rounds(res: Dict, names: Sequence[str], base: str) -> List[str]:
    """The ``names`` whose scores differ from ``base``'s, bit for bit, in
    any round of ``run``'s result ``res``."""
    return [n for n in names
            if not all(torch.equal(a, b) for rnd in res["rounds"] for a, b in zip(rnd[n], rnd[base]))]


def main(tool: str, variants: Variants) -> int:
    """A lab tool's run: P01008's buckets through K1 and ``variants``, the
    per-bucket table, and whether every variant that keeps the DP gives K1's
    scores bit for bit (0 if so).  1 without a CUDA device."""
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device: the kernels run on the card only", file=sys.stderr)
        return 1
    b = swissprot_buckets()
    fns = launches(b, variants)
    small = min(b.groups, key=lambda g: g.stack.numel())
    for launch in fns.values():  # load every kernel before anything is timed
        launch(small)
    res = run(b.groups, fns)
    keep_dp = [name for name, (_, kw) in variants.items() if skip(kw) == "none"]
    unequal = unequal_rounds(res, keep_dp, "K1")
    print(f"device: {card()}; {b.query.name} ({b.query.length} aa), {len(b.groups)} buckets, "
          f"medians of {len(res['rounds'])} rounds")
    print("\n".join(table(b.groups, res["times"], "K1", res["spread_ms"])))
    print(f"bit-equal to K1 in every round ({', '.join(keep_dp)}): {not unequal}"
          + (f" (not: {unequal})" if unequal else ""))
    return 0 if not unequal else 1


def table(groups: Sequence[WaveGroup], times: Dict[str, List[float]], base: str,
          spread: Dict[str, float]) -> List[str]:
    """Lines of a per-bucket table of ``times`` (ms, and each variant over
    ``base``'s ms), then the narrow, mid and full sums and the whole search,
    and each variant's ``spread`` across rounds (ms)."""
    names = list(times)
    lines = ["bucket  width  segs  lanes  threads  group   " + "  ".join(f"{n:>12}" for n in names)]
    for k, g in enumerate(groups):
        lines.append(f"{k:6d} {g.width:6d} {g.n_segs:5d} {g.lanes:6d} {g.rows:8d}  {group_of(g):6s}  "
                     + "  ".join(f"{times[n][k]:12.4f}" for n in names))
    sums = group_sums(groups, times)
    for grp in (*GROUPS, "all"):
        n_buckets = sum(grp in ("all", group_of(g)) for g in groups)
        if n_buckets:
            lines.append(f"{grp:>6s} ({n_buckets:2d} buckets) ms      "
                         + "  ".join(f"{sums[n][grp]:12.4f}" for n in names))
            lines.append(f"{grp:>6s} / {base:<21s}  "
                         + "  ".join(f"{sums[n][grp] / sums[base][grp]:12.3f}" for n in names))
    lines.append(f"{'spread (ms, rounds)':<30s}  " + "  ".join(f"{spread[n]:12.4f}" for n in names))
    return lines


def group_sums(groups: Sequence[WaveGroup], times: Dict[str, List[float]]) -> Dict[str, Dict[str, float]]:
    """{variant: {"narrow", "mid", "full", "all": ms}}."""
    return {n: {grp: sum(t for g, t in zip(groups, ms) if grp in ("all", group_of(g))) for grp in (*GROUPS, "all")}
            for n, ms in times.items()}


@dataclasses.dataclass
class RowGroups:
    db: Database
    engine: SearchEngine  # a row-path engine (use_wave=False) on the card
    query: Query
    packed: PackedDatabase  # the engine's resident row-path pack
    _seg_flat: Optional[torch.Tensor] = None

    @property
    def groups(self) -> Tuple[PackedGroup, ...]:
        """The ladder groups: (C, rows, width) stacks, K2's launches."""
        return self.packed.groups

    @property
    def gap(self) -> int:
        return self.engine.config.gap_penalty

    def profile(self) -> torch.Tensor:
        """The query's (qpad, 32) profile as the engine gives it to K2."""
        return self.engine._profile(self.query)

    def reduce(self, flats: Sequence[torch.Tensor]) -> np.ndarray:
        """One (C, rows) score array a ladder group, with the segment groups'
        scores (the engine's seg16 pass, run once) scattered back to file
        order through the engine's own ``_reduce_flat``."""
        prof = self.profile()
        if self._seg_flat is None:
            self._seg_flat = self.engine._row_step(prof, dataclasses.replace(self.packed, groups=()))
        flat = torch.cat([f.reshape(-1) for f in flats] + [self._seg_flat])
        return self.engine._reduce_flat(flat.cpu().numpy(), self.packed, self.db, prof)


def swissprot_rows(db: Optional[Database] = None, engine: Optional[SearchEngine] = None) -> RowGroups:
    """P01008's row-path groups; ``db`` defaults to the SwissProt-shaped
    database and ``engine`` to a row-path engine on the card (K2 for its
    ladder groups)."""
    db = synth.synth_database(N_SEQS, seed=0) if db is None else db
    engine = SearchEngine(SWConfig(use_wave=False), device="cuda") if engine is None else engine
    if engine._wave_enabled:
        raise ValueError("the row-path groups need a row-path engine (use_wave=False)")
    return RowGroups(db=db, engine=engine, query=swissprot_query(),
                     packed=engine._resident_packed(db))


def row_table(groups: Sequence[PackedGroup], times: Dict[str, List[float]], base: str,
              spread: Dict[str, float]) -> List[str]:
    """Lines of a per-group table of ``times`` (ms), then the whole pass's
    ms and each variant's ratio to ``base``, group by group and in all, and
    each variant's ``spread`` across rounds (ms)."""
    names = list(times)
    lines = ["group  chunks   rows  width  " + "  ".join(f"{n:>12}" for n in names)
             + "  " + "  ".join(f"{n + '/' + base:>14}" for n in names if n != base)]
    for k, g in enumerate(groups):
        lines.append(f"{k:5d} {g.chunks:7d} {g.rows:6d} {g.width:6d}  "
                     + "  ".join(f"{times[n][k]:12.4f}" for n in names) + "  "
                     + "  ".join(f"{times[n][k] / times[base][k]:14.3f}" for n in names if n != base))
    sums = {n: sum(ms) for n, ms in times.items()}
    lines.append(f"  all ({len(groups):2d} groups)      " + "  ".join(f"{sums[n]:12.4f}" for n in names) + "  "
                 + "  ".join(f"{sums[n] / sums[base]:14.3f}" for n in names if n != base))
    lines.append(f"{'spread (ms, rounds)':<23s}" + "  ".join(f"{spread[n]:12.4f}" for n in names))
    return lines
