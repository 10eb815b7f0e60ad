"""K10 on the card: the row-parallel lab kernels beside K2.

The counterpart of ``tools/pallas_lab.py``'s ``main``, on the port's kernels
(``swtpu_torch.ops.rows_lab``: every instantiation of v2, v3, v4 and v41,
one design in ``csrc/sw_rows_lab.cu``: a copy of K2's warp wavefront with
v2's one-warp blocks, v3's 16 rows a stage, v4's ``ilp`` rows a thread
group and v41's rotate hand-off at 16- or 32-row bands).  Both runs print,
for each instantiation, its launch on each bucket (``schedules``: G,
passes, rows a block, blocks, stage bytes, blocks and warps an SM, the
kernel's own, checked against ``rows_lab.wave_schedule``, and the SMs the
bucket's blocks fill) and its carry bytes.  Two runs, each timed with CUDA
events and printed beside the card's name and power limit:

* synthetic (the default): ``tools/pallas_lab.py``'s bucket, made the same
  way (``default_rng(0)``; B subjects of L columns, each L/4 to L-1 residues,
  pads PAD_SUBJECT; a Q-residue query; the port's ``blosum50_ref``; gap 2)
  through the plain int32 scorer (``row_sw.sw_score_bucket``, the JAX tool's
  ``xla_exact``), ``row_sw.sw_score_bucket_fast16`` (``xla_fast16``), K2
  (``bucket_sw.sw_score_bucket_fused``, ``pallas_fused_r1``) and every K10
  instantiation, v4 included (the JAX tool never calls it): ms, padded
  GCUPS, and every mismatch against the plain scores;
* ``--swissprot``: P01008's 13 row-path ladder groups of the SwissProt-shaped
  database (``buckets.swissprot_rows``), in ``buckets.ROUNDS`` rounds group
  by group an untimed K2 launch then one timed launch of K2 and of each
  instantiation (``buckets.run``): a table of the median ms a group with
  each variant's ratio to K2 and its spread across rounds, and whether
  every variant gives K2's scores bit for bit in every round.

Exits 1 without a CUDA device, or on a mismatch.

Run: ``python -m swtpu_torch.tools.pallas_lab [B] [L] [Q]`` (4096 512 512)
or ``python -m swtpu_torch.tools.pallas_lab --swissprot``
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ..matrices import blosum50_ref
from ..ops import bucket_sw, row_sw, rows_lab
from ..ops.profile import PAD_SUBJECT, make_profile
from ..utils.bucketing import PackedGroup
from . import buckets
from .roofline import card, events_ms

GAP = 2
# name: (ops/rows_lab.py wrapper, its keywords), one entry an instantiation
VARIANTS: Dict[str, tuple] = {
    f"{v}/S{s}/ILP{ilp}" if v == "v4" else f"{v}/S{s}":
        (rows_lab.WRAPPERS[v], dict(strip=s, ilp=ilp) if v == "v4" else dict(strip=s))
    for v, s, ilp in rows_lab.INSTANCES
}


def launches(rg: buckets.RowGroups) -> Dict[str, Callable[[PackedGroup], torch.Tensor]]:
    """K2, then every K10 instantiation, each a launch on one ladder group."""
    prof = rg.profile()
    out = {"K2": lambda g: bucket_sw.sw_score_bucket_fused(prof, g.stack, gap=rg.gap)}
    for name, (fn, kw) in VARIANTS.items():
        out[name] = lambda g, fn=fn, kw=kw: fn(prof, g.stack, gap=rg.gap, **kw)
    return out


def schedules(profile_rows: int, shapes: Sequence[tuple], sms: Optional[int] = None) -> Dict[str, Dict]:
    """For each instantiation, on each (chunks, rows, width) bucket shape:
    the kernel's launch (``rows_lab.card_schedule``: G, passes, rows a
    block, blocks a bucket, stage bytes, blocks an SM), its warps an SM, the
    SMs its chunks x blocks fill of the card's ``sms`` (the current card's
    when None), and the carry bytes of all the shapes.  Raises if the
    kernel's launch is not ``rows_lab.wave_schedule``'s."""
    if sms is None:
        sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    out = {}
    for name, (fn, kw) in VARIANTS.items():
        v = next(v for v, f in rows_lab.WRAPPERS.items() if f is fn)
        strip, ilp = kw["strip"], kw.get("ilp", 1)
        launches = []
        for chunks, rows, _ in shapes:
            card = rows_lab.card_schedule(v, profile_rows, strip, ilp, rows, "cuda")
            want = rows_lab.wave_schedule(v, profile_rows, strip, ilp, rows)
            if card[:5] != (want.g, want.passes, want.rows_per_block, want.blocks, want.stage_bytes):
                raise AssertionError(f"{name}: the kernel's launch {card[:5]} is not wave_schedule's {want}")
            launches.append(dict(zip(("g", "passes", "rows_per_block", "blocks", "stage_bytes", "blocks_per_sm"),
                                     card), warps_per_sm=card[5] * rows_lab.BLOCK_THREADS[v, strip] // 32,
                                 sms=min(sms, chunks * card[3])))
        out[name] = {"launches": launches, "carry_bytes": sum(
            rows_lab.carry_bytes(v, profile_rows, strip, c, r, w, ilp=ilp) for c, r, w in shapes)}
    return out


def schedule_lines(sched: Dict[str, Dict], shapes: Sequence[tuple]) -> list:
    """Lines of ``schedules``' result: an instantiation a line, its launch on
    each distinct (chunks, rows) of the shapes, in their order."""
    lines = []
    for name, s in sched.items():
        seen = {}
        for (chunks, rows, _), x in zip(shapes, s["launches"]):
            seen.setdefault((chunks, rows), x)
        lines.append(f"{name:16s} carry {s['carry_bytes']} B; " + "; ".join(
            f"{chunks}x{rows} rows: G{x['g']} x{x['passes']} {x['rows_per_block']} rows/block {x['blocks']} blocks "
            f"{x['stage_bytes']} B stage {x['blocks_per_sm']} blocks ({x['warps_per_sm']} warps)/SM, {x['sms']} SMs"
            for (chunks, rows), x in seen.items()))
    return lines


def swissprot(rg: buckets.RowGroups) -> Dict[str, Dict]:
    """The ``--swissprot`` run on ``rg``'s groups: ``buckets.run``'s result,
    K2 the base, and "unequal": the variants whose scores are not K2's bit
    for bit in some round."""
    res = buckets.run(rg.groups, launches(rg))
    res["unequal"] = buckets.unequal_rounds(res, list(VARIANTS), "K2")
    return res


def synthetic_bucket(B: int, L: int, Q: int) -> tuple:
    """``tools/pallas_lab.py``'s inputs: (query residues, (B, L) int8 bucket)."""
    rng = np.random.default_rng(0)
    q = rng.integers(0, 25, Q).astype(np.int8)
    subj = np.full((B, L), PAD_SUBJECT, np.int8)
    for i in range(B):
        n = int(rng.integers(L // 4, L))
        subj[i, :n] = rng.integers(0, 25, n)
    return q, subj


def bench(name: str, fn: Callable[[], torch.Tensor], cells: int, ref: torch.Tensor, reps: int = 10) -> bool:
    """Run ``fn`` once against ``ref`` (printing the first mismatches), then
    time ``reps`` calls after a warm one; True if it matched."""
    out = fn()
    if not torch.equal(out, ref):
        bad = torch.nonzero(out != ref).flatten()[:5]
        print(f"{name:24s} MISMATCH at {bad.tolist()}: got {out[bad].tolist()}, want {ref[bad].tolist()}")
        return False
    fn()
    ms, _ = events_ms(fn, reps)
    print(f"{name:24s} {ms:8.3f} ms  {cells / ms / 1e6:8.1f} GCUPS(padded)")
    return True


def synthetic(B: int, L: int, Q: int) -> bool:
    q, subj = synthetic_bucket(B, L, Q)
    sd = torch.from_numpy(subj).cuda()
    prof = torch.from_numpy(make_profile(q, blosum50_ref(), pad_rows_to=32)).cuda()
    cells = B * L * prof.shape[0]
    sat = row_sw.fast16_sat(GAP, L)
    ref = row_sw.sw_score_bucket(prof, sd, gap=GAP, strip=32)
    ok = bench("plain_int32", lambda: row_sw.sw_score_bucket(prof, sd, gap=GAP, strip=32), cells, ref)
    ok &= bench("fast16", lambda: row_sw.sw_score_bucket_fast16(prof, sd, gap=GAP, strip=32, sat=sat, stage_int8=True),
                cells, torch.clamp_max(ref, sat))
    ok &= bench("K2", lambda: bucket_sw.sw_score_bucket_fused(prof, sd, gap=GAP), cells, ref)
    for name, (fn, kw) in VARIANTS.items():
        ok &= bench(name, lambda fn=fn, kw=kw: fn(prof, sd, gap=GAP, **kw), cells, ref)
    print("\n".join(schedule_lines(schedules(prof.shape[0], [(1, B, L)]), [(1, B, L)])))
    return ok


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("pallas_lab: no CUDA device: the kernels run on the card only", file=sys.stderr)
        return 1
    print(f"device: {card()}")
    if "--swissprot" in args:
        rg = buckets.swissprot_rows()
        small = min(rg.groups, key=lambda g: g.stack.numel())
        for launch in launches(rg).values():  # load every kernel before anything is timed
            launch(small)
        res = swissprot(rg)
        print(f"{rg.query.name} ({rg.query.length} aa), {len(rg.groups)} row-path ladder groups, "
              f"medians of {len(res['rounds'])} rounds")
        print("\n".join(buckets.row_table(rg.groups, res["times"], "K2", res["spread_ms"])))
        shapes = [(g.chunks, g.rows, g.width) for g in rg.groups]
        print("\n".join(schedule_lines(schedules(rg.profile().shape[0], shapes), shapes)))
        print(f"bit-equal to K2 in every round ({len(VARIANTS)} instantiations): {not res['unequal']}"
              + (f" (not: {res['unequal']})" if res["unequal"] else ""))
        return 0 if not res["unequal"] else 1
    B, L, Q = (int(a) for a in (args + ["4096", "512", "512"][len(args):])[:3])
    print(f"synthetic bucket: B={B} L={L} Q={Q} gap={GAP}")
    return 0 if synthetic(B, L, Q) else 1


if __name__ == "__main__":
    sys.exit(main())
