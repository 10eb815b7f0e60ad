"""P01008's wavefront buckets and row-path groups on the SwissProt-shaped database, for the lab tools.

The database is ``chip_smoke.py``'s (``synth.synth_database``: 559,228
sequences, seed 0) and the buckets are the engine's own plan, packed on the
card, as ``wave_ab.py`` takes them: 27 buckets for P01008.  A bucket is
"narrow" below 1,024 threads (lanes x segments), "full" from 20,000, and
"mid" between: at this scale that is PERF.md's 5 narrow, 11 mid and 11 full
buckets, the full ones 71% of the cells.  ``main`` is the wavefront lab
tools' run (``wave_lab``, ``probe_breakdown``): each names its variants.

The row path's groups (``swissprot_rows``) are the ladder groups of the
engine's row-path pack (``use_wave=False``): 13 (chunks, rows, width) stacks
that K2 scores for P01008, beside the segment-packed groups of the short
sequences, which the PyTorch seg16 scorer takes.  ``run`` times them the same
way, K2 first (``pallas_lab``).
"""

from __future__ import annotations

import dataclasses
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
    """A variant's band height: its ``height`` keyword, else K1's."""
    return kw.get("height", wave_lab.K1_HEIGHT)


def skip(kw: dict) -> str:
    """A variant's dropped stage: its ``skip`` keyword, else "none"."""
    return kw.get("skip", "none")


def launches(b: Buckets, variants: Variants) -> Dict[str, Callable[[WaveGroup], torch.Tensor]]:
    """K1, then every variant, each a launch on one bucket (a variant's
    profile padded to its height)."""
    prof = {h: b.profile(h) for h in wave_lab.HEIGHTS}
    out = {"K1": lambda g: wave_sw.sw_wave(prof[wave_sw.W], g.stack, gap=b.gap, n_segs=g.n_segs)}
    for name, (fn, kw) in variants.items():
        out[name] = lambda g, fn=fn, kw=kw: fn(prof[height(kw)], g.stack, gap=b.gap, n_segs=g.n_segs, **kw)
    return out


def run(groups: Sequence, launches: Dict[str, Callable]) -> Dict[str, Dict]:
    """{"flats": {name: one score array a bucket}, "times": {name: ms a
    bucket}}: bucket by bucket, an untimed launch of the first name (the
    production kernel, K1 or K2) brings the bucket into L2, then every named
    launch runs once in turns, timed with CUDA events, so the variants of a
    bucket are timed at nearly the same moment.  The scores kept are the
    timed launches': a variant launches once a bucket."""
    flats: Dict[str, List[torch.Tensor]] = {name: [] for name in launches}
    times: Dict[str, List[float]] = {name: [] for name in launches}
    warm = next(iter(launches.values()))
    for g in groups:
        warm(g)
        for name, launch in launches.items():
            ms, out = events_ms(lambda: launch(g))
            flats[name].append(out)
            times[name].append(ms)
    return {"flats": flats, "times": times}


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
    k1 = torch.cat(res["flats"]["K1"])
    keep_dp = [name for name, (_, kw) in variants.items() if skip(kw) == "none"]
    unequal = [name for name in keep_dp if not torch.equal(torch.cat(res["flats"][name]), k1)]
    print(f"device: {card()}; {b.query.name} ({b.query.length} aa), {len(b.groups)} buckets")
    print("\n".join(table(b.groups, res["times"], "K1")))
    print(f"bit-equal to K1 ({', '.join(keep_dp)}): {not unequal}" + (f" (not: {unequal})" if unequal else ""))
    return 0 if not unequal else 1


def table(groups: Sequence[WaveGroup], times: Dict[str, List[float]], base: str) -> List[str]:
    """Lines of a per-bucket table of ``times`` (ms, and each variant over
    ``base``'s ms), then the narrow, mid and full sums and the whole search."""
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


def row_table(groups: Sequence[PackedGroup], times: Dict[str, List[float]], base: str) -> List[str]:
    """Lines of a per-group table of ``times`` (ms), then the whole pass's
    ms and each variant's ratio to ``base``, group by group and in all."""
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
    return lines
