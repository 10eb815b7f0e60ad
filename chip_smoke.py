"""On-card check of swtpu_torch: build, compare, search and serve at SwissProt scale.

Run from the repository root on a machine with one NVIDIA GPU and nvcc:

    python3 chip_smoke.py

Phases (one line each; any failure exits non-zero with no result line):
  1. card     name, power limit, torch and CUDA versions
  2. build    nvcc of every kernel source and g++ of the native host
              runtime (csrc/sw_native.cpp) at once; seconds, and registers,
              spills and SASS opcode counts of each kernel instantiation,
              and the loop-body opcodes of K1's linear band sweep at H = 64
              and of every K5/K6 instantiation beside it (K5 D1 none is a
              copy of that sweep: registers, spills and loop body compared);
              build.rows_lab: K10's eight instantiations (K2's warp
              wavefront): registers, spills, their launch on
              P01008's profile (G, passes, rows a block, stage bytes, blocks
              and warps an SM by the runtime's occupancy) and their column
              loop's instructions a cell beside K2's
  3. kernel   each kernel against its plain PyTorch version on seeded random
              buckets (chain factors 1/2/3/8, odd lane counts, one and many
              bands, widths 32 to 4100; K1's shapes: the suite's longest
              query, 143 bands, across eight pass boundaries of the warp
              wavefront, segments of 6 columns under 16 bands a pass, and a
              bucket of 20,800 (lane, segment) pairs on the band sweep at
              H = 64 with a 32-row tail): exact equality; then the
              multi-query mode (Q = 2, 5, 16) the same way; then the affine
              mode on both case lists for gaps (10, 2), (10, 1) and (5, 5),
              and (5, 5) bit-equal to the linear kernel at gap 5; then the
              row kernels K2 (a whole (C, B, L) stack a launch) and K3 (one
              bucket) and K2's fast16 clamp against their plain versions
              (query lengths 1 to 4,548, widths 8 to 6,000, C = 1, 2, 3, 17,
              gaps 1, 2, 11, a self-alignment above 32,767), each at the
              wrapper's shape and K2 at every compiled (G, H): exact equality;
              then the band-carry hand-off mode on the first case list,
              linear and affine, as a chain of query_shard's band slices at
              n = 4 from a zero and from a seeded carry: the carry after
              every slice and every slice's scores equal the plain
              version's, and a chain's running max equals one launch over
              all the bands;
              then K7's coarse_counts on seeded 0/1 signatures with a few
              +-5 entries (n = 1 to 100,003, Q = 1 to 17, dim 64, 1024,
              2048) and its mma_probe, and K8's chain, against their plain
              versions (K8's chain is K9's int32 addmax chain kernel):
              exact equality; then the wavefront lab kernels on
              the first case list (K4, the warp wavefront, at every band
              height and block: one pass and several at every height, a
              last pass of fewer bands, chained segments, a bucket of
              20,800 (lane, segment) pairs; K5 at every prefetch depth and
              K6 at every stage switch, both K1's band sweep at H = 64 on
              K1's unpadded profile, odd band counts ending in a 32-row
              tail) against their plain versions, and those that keep the
              DP against K1's kernel; then K9's int16 and int32 tiles (tools/probe_i16.py's
              inputs and random ones whose sums wrap) and short chains of
              every op: exact equality; then K10, every instantiation of
              the row-parallel lab kernel (v2, v3, v4, v41) on the row
              kernel cases, widths 1 and 31, and the edge cases (pass
              boundaries at 16- and 32-row bands, query tails, B off the
              rows a block at ILP 2 and 4 and off v3's 16, v2's one-row
              blocks at B = 1), at gap 2 and gap 120, against its plain
              version: exact equality; every launch is the kernel's own
              schedule (wave_schedule)
 3b. roofline K7's int8 MAC rate and K8's int32 chain rate at full
              occupancy (swtpu_torch.tools.roofline; counts zeroed just
              before, read just after) beside the data-sheet and derived
              figures and their plain versions, the SASS instructions
              of a chain link (the chain's loop body) and the SM clock
              under the chain's load; every later int32 bound divides by
              the larger of the derived peak and K8's rate; then K9 as
              swtpu_torch.tools.probe_i16 runs it (counts zeroed just
              before each part, read just after): the eight elementwise
              tiles and the two dp_row tiles against their plain versions
              and the library calls, the host microseconds of each piece
              of K9's launch route and of the library call (no trace runs
              before the main path: their device time is 5a's), and every
              chain's rate, packed int16
              against int32, with its loop body's SASS a link and its tile
              against the plain version on the same inputs
  4. goldens  the committed subset, 10k-scale and saturation goldens through
              SearchEngine(device="cuda"): exact equality; the subset under
              affine gaps (10, 1) against the NumPy oracle
              (swtpu_torch.ops.oracle.sw_affine_score_diag), subject by subject
 4b. fuzz     swtpu_torch.tools.card_fuzz, every function at its own seeds:
              K1 linear, multi-query, query-band pipeline, chained and
              affine on random buckets (tools/tpu_fuzz.py's five); every
              (G, H) forced in every K1 mode across pass boundaries and 143
              bands, the hand-off as chains of query_shard's band slices
              from a zero and a seeded carry; K2, K3 and the fast16 clamp
              at every (G, H), widths 1 to 6,000, a self-alignment above 32,767; the wrappers' own
              choice at BAND_THREADS and BAND_ROWS +- 1 and 32 on one device
              and as 2, 3 and 4 lane or row shards; every launch against its
              plain version (exact) and a strided oracle sample; cases and
              launches by kernel, mode and (G, H); seconds
 4c. battery  swtpu_torch.tools.gpu_validate: tools/tpu_validate.py's checks
              on the card (not its TPU-only check 8), each OK
  5. scale    a SwissProt-shaped database of 559,228 sequences (bench.py's
              recipe, seed 0) packed on the card and searched with P01008
              through the user entry points; kernel launch counts are zeroed
              just before the first search and read just after; three timed
              searches; every score against the plain version on the card
 5a. profile  the CLI with --profile on the subset (a subprocess): its Chrome
              trace's events, device events and kernel names; one resident
              P01008 search under torch.profiler: kernel time by name and
              the device's busy share over the search's window; then the
              device time a call of K9's elementwise tiles and of the
              library calls under torch.profiler; the three added phases'
              seconds together
 5b. native   native.parse: that database written as a FASTA file (60
              columns) into a temporary directory and parsed by the native
              parse and its plain version, each bit-equal to the database in
              memory; seconds and MB/s of both.  cli.search: python -m
              swtpu_torch on that file and P01008, a subprocess on the card,
              its id:score dump equal line for line to the in-memory scores;
              its wall and METRICS block; the file is deleted
  6. serving  the reference Performance suite's 17 queries against the same
              resident database: single searches, then search_many (counts
              zeroed just before, read just after) and search_queued, each
              score array bit-equal to the query's single search and
              P02232's batched scores to the plain version; device top-K
              with E-values through search_many and search_queued for four
              queries against the full-array fit; streamed (not resident)
              search_many for three queries against the resident scores;
              a 16-query launch against 16 single launches, bucket by bucket
  7. affine   the same resident database under affine gaps (10, 2): P01008
              searches (counts zeroed just before the first, read just
              after; every score against the plain version on the card), per
              bucket times beside the linear ones, the 17 queries through
              single searches and search_many (bit-equal), device top-K with
              E-values for four queries against the full-array fit, and a
              streamed search against the resident scores
  8. align    align_top_k(k=10) for P01008 on the resident database, linear
              (gap 2) and affine (10, 2); every alignment re-scored from its
              strings by an independent scorer equals its device score
  9. rows     the row path on the same resident database with P01008, every
              score array bit-equal to the wavefront path's: K2 resident
              (use_wave=False, whose use_pallas resolves to the row kernels
              on the card; K2's counts zeroed just before the first search,
              read just after), the PyTorch scorers (use_pallas=False:
              fast16 plus seg16) and the int16 parity mode, through K2 and
              through the PyTorch scorers, with their exact rescore, K3
              streamed (its counts equal the plan's batches), search_many
              and search_queued for three suite queries, int16 top-K with
              E-values; K2 and K3 alone against their plain versions on the
              same work
 9b. native.pack each native packer against its plain version at that size,
              bit-equal, with both times: the streamed row plan's batches
              (pack_batch), the row engine's segment groups (pack_segments),
              the streamed wave plan's buckets on the host (pack_wave_group)
              and the prefilter's signatures
 10. prefilter the k-mer prefilter on the same resident database: the
              signatures built on the card and their bytes there; P01008
              at prefilter 0.05, top-K 10 (counts zeroed just before, read
              just after: one signature build, one coarse_counts launch and
              one sw_wave launch a width class), its hits equal to the exhaustive top-10 of the
              candidate set and that set to the plain coarse pass's; three
              timed searches; the signature kernel alone (one launch) on
              the resident residues and offsets, byte for byte the native
              host pass with its popcounts, against its byte bound and
              that pass's seconds; the coarse kernel alone at Q = 1 and 17
              against its bound, plain version and torch._int_mm, and on
              seeded random signatures of the same shape;
              search_many for the suite (one coarse launch, hits equal to
              single searches); the E-value null equal to the exhaustive
              scores' at the calibration sample; swtpu's planted-homolog
              recall check (tools/tpu_validate.py check 9)
 11. lab      the wavefront lab kernels as swtpu_torch.tools.wave_lab (K4,
              K5) and swtpu_torch.tools.probe_breakdown (K6) run them on
              P01008's buckets of the same resident database (counts zeroed
              just before, read just after; 3 rounds of one timed launch a
              variant a bucket, a bucket's time the median of its rounds):
              in every round every variant that keeps the DP bit-equal to
              K1's scores of all 559,228 sequences and every variant equal
              to its plain version (run once a variant), a per-bucket table
              of milliseconds beside K1's, K1 forced to its warp wavefront
              and to its band sweep on every bucket, with narrow, mid and
              full sums and each variant's spread across rounds; each K4
              variant's schedule for P01008 and its blocks an SM; each K5
              and K6 variant's shape and its ratio to K1's band sweep
 12. lab.rows K10 as swtpu_torch.tools.pallas_lab --swissprot runs it on
              P01008's 13 row-path ladder groups of the same resident
              database (counts zeroed just before, read just after; 3 rounds
              of one timed launch an instantiation a group beside K2's, a
              group's time the median of its rounds): in every round every
              instantiation bit-equal to K2 on every group and K2, with the
              segment groups' scores, to the wavefront path's scores of all
              559,228 sequences; one plain pass for all; a per-group table
              of milliseconds with each instantiation's ratio to K2 and its
              spread across rounds; every instantiation's launch on each
              group (G, passes, rows a block, blocks, stage, blocks and
              warps an SM, the SMs the group fills, K2's beside them) and
              carry bytes, from its schedule; on the largest group each
              instantiation at width 1 against its full width (the share of
              a launch that staging and the launch take)
 13. mesh     the port's single-host mesh (swtpu_torch.parallel) on meshes
              that name the one card n times (and on distinct cards where the
              machine has n or more): every shard's kernels, the lane split,
              the merge and the carry hand-off between pipeline stages run
              for real; copies between cards and scaling cannot show on one
              card.  mesh.kernel (after the kernel phases): tools/tpu_fuzz.py's
              main_shard cases (seed 555) and tools/tpu_validate.py's check 7
              through the query-band pipeline at n = 1, 2, 4, linear and at
              gaps 11/1, against one sw_wave and its plain version; and
              make_sharded_step's K3 route on 2 and 3 shards, against one K3
              launch over the batch and the plain scorer.
              mesh.search: the same resident database lane-sharded over 4 and
              3 shards (counts zeroed just before P01008's first search, read
              just after: n launches a bucket), P01008's scores, top-10 hits
              and E-values, gaps 10/2, the 17 queries
              through search_many and search_queued, 3 streamed queries, all
              bit-equal to one device; each shard's launches and ms.
              mesh.query_shard: the suite's 4,548-residue query against the
              database's first 20,000 sequences at n = 4, linear and at gaps
              10/2, bit-equal to one device (counts zeroed just before, read
              just after: a hand-off launch a device a lane tile); the CLI
              with --mesh 1 and --mesh 1 --query-shard against the subset
              golden, and --mesh 2 (exit 2 on one card).
              mesh.rows: the row path on 4 and 3 shards (every ladder and
              segment group split into row shards): P01008 through K2 on
              every shard with PyTorch seg16 (counts zeroed just before the
              first search, read just after: groups x n K2 launches), the
              int16 mode and the streamed K3 route on the primary, each
              bit-equal to the wavefront scores; each shard's K2 ms; at 4
              shards every shard's K2 launch against its plain version.
              mesh.prefilter: P01008 at 0.05/top-10 with E-values on 4
              shards, one coarse launch, hits and E-values equal to one
              device's.  mesh.query_shard.streamed: mesh.query_shard's
              database under a residency budget that forces streaming (the
              row ladder, K3 a batch, on the primary), bit-equal to one device
 14. dist.fleet two processes of the multi-process fleet (gloo on 127.0.0.1,
              both on the one card) on native.parse's FASTA file: python -m
              swtpu_torch.parallel.launch --json (both print the one-device
              top-10 of P01008), then DistributedSearchEngine.search_many
              over the suite with E-values in two workers (hits equal to one
              device, E-values within log-E 5% and bits 1% of the one-device
              pooled fit; K1 on each shard against its plain version); each
              process's wall, parse, pack, search and collective seconds and
              route; the file is deleted; every process has a timeout
 15. kernels  one JSON line per kernel and mode: launches on its path, error,
              time, plain time, the card's lower bound for the same work and
              the library call's time, where one computes the same function
The last line is {"ok": true, "device": {...}} and appears only if all passed.
"""

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Lower-bound rates of an H100 SXM at 700 W.  Memory: 3.35 TB/s (data sheet).
# int32 ALU: 132 SMs x 64 int32 lanes x 1.98 GHz boost issue 16.7e12
# instructions/s, and one instruction does at most two operations (VIADDMNMX:
# an add then a max; VIMNMX3: two maxes), so 33.5e12 operations/s.  K8's chain
# (phase_roofline: one VIADDMNMX a link) runs at about that rate.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 2 * 132 * 64 * 1.98e9
# The int32 rate every bound divides by: that peak, raised by phase_roofline
# to K8's measured rate where the card sustains more, so no bound exceeds the
# least time the card can take.
int32_ops_per_s = INT32_OPS_PER_S
OPS_PER_CELL = 6  # add, max, subtract, max, clamp at 0, running-best max
# E and F: two subtracts and a max each; H: add and three max (the clamp
# included); the running best.
OPS_PER_CELL_AFFINE = 11
INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core peak of an H100 SXM (data sheet): 989.5e12 MACs
K2_WAVE_LABEL = "K2/K3 sw_rows_kernel G16 H32 wavefront"  # K2's shape on P01008's row-path groups
SASS_OPCODES = ("VIADDMNMX", "VIMNMX3", "VIMNMX", "IMNMX", "IADD3", "IMMA", "S2UR", "LDG", "STG", "LDS", "LDL", "STL")
AFFINE = dict(gap_open=10, gap_extend=2)  # the affine cell's gaps
GAP_PAIRS = ((10, 2), (10, 1), (5, 5))  # the affine kernel phase's (open, extend)
# Kernel phase cases: (longest query, segment width, n_segs, lanes, Q or None for one query).
# The last three single-query cases: the suite's longest query (143 bands) crossing
# eight pass boundaries of the wavefront; segments of 6 columns under 16 bands a
# pass; a bucket of 20,800 (lane, segment) pairs, so the band sweep at H = 64,
# where P01008's 15 bands end in a 32-row tail, and so does the last of its
# hand-off slices (4, 4, 4, 3) (kernel.carry).
KERNEL_CASES = (
    (20, 32, 1, 64, None), (33, 48, 2, 77, None), (100, 96, 3, 130, None), (464, 40, 8, 1001, None),
    (464, 736, 1, 3000, None), (147, 2208, 6, 333, None), (464, 4100, 1, 129, None), (1000, 160, 4, 515, None),
    (4548, 96, 1, 300, None), (300, 6, 8, 129, None), (464, 40, 8, 2600, None),
)
MULTI_CASES = (
    (20, 32, 1, 65, 2), (100, 96, 3, 131, 5), (464, 40, 8, 257, 16), (31, 736, 1, 77, 16),
    (300, 2208, 3, 129, 5), (1000, 160, 8, 33, 2), (64, 4100, 1, 99, 16), (4548, 64, 1, 200, 3),
)
# Row kernel phase cases: (query length, chunks C, rows B, width L, gap); the
# 4,548-residue cases cross eight pass boundaries of the 16-band wavefront,
# the 1,000-residue one one, at odd widths; the last plants the query in a
# row: its self-alignment passes 32,767.
ROW_CASES = (
    (1, 1, 1, 8, 2), (20, 3, 77, 40, 1), (33, 17, 129, 128, 2), (100, 3, 333, 256, 11),
    (464, 17, 257, 640, 2), (1000, 3, 65, 2048, 1), (300, 1, 31, 4100, 2), (1000, 2, 45, 77, 2),
    (4548, 2, 19, 13, 2), (4548, 3, 9, 6000, 2),
)
# kernel.rows_lab's cases: ROW_CASES (their gap replaced by 2 and by ROWS_LAB_WIDE_GAP) and widths 1 and 31
ROWS_LAB_CASES = ROW_CASES + ((40, 2, 19, 1, 2), (70, 3, 100, 31, 2))
# and (query length, C, B, L, profile rows padded to): pass boundaries at both band heights (34 16-row and
# 17 32-row bands; 38 and 19 from 600 unpadded rows), query tails that are no whole band, B off the rows a
# block at ILP 2 (16) and 4 (32) and off v3's 16, and P01008's length at B = 23 (v3: two 16-row blocks,
# 9 rows idle) and B = 1 (v2: one one-row block)
ROWS_LAB_EDGE_CASES = ((520, 2, 37, 96, 32), (600, 1, 50, 200, 1), (37, 3, 33, 64, 1), (530, 2, 17, 130, 8),
                       (100, 1, 1, 40, 1), (464, 2, 23, 64, 32), (464, 1, 1, 300, 32))
ROWS_LAB_WIDE_GAP = 120  # past 112: JAX's int8 gap fold (15 + gap <= 127) wraps there, the kernel's int32 fold not
ROW_QUERIES = ("P02232", "P05013", "P14942")  # the row phase's search_many and search_queued
# kernel.mma's coarse-count cases: every (subjects n, queries Q, signature width) combination.
MMA_NS, MMA_QS, MMA_DIMS = (1, 15, 17, 4097, 100_003), (1, 2, 8, 17), (64, 1024, 2048)
PREFILTER = dict(prefilter=0.05, top_k=10)  # the prefilter cell's knobs
N_SEQS = 559_228
MAIN_QUERY = "P01008"
# sw_wave_lab.cu's SKIP codes and i16_probe.cu's op codes, as its kernels are named
LAB_SKIPS = ("none", "subject", "carry", "dp")
# K1's linear band sweep at H = 64 and its copy, K5 at D = 1 with no stage skipped
SWEEP_LABELS = ("linear band sweep H64", "K5/K6 sw_band_lab_kernel H64 D1 none")
I16_OPS = {0: "max", 1: "add", 2: "sub", 3: "select", 4: "dp_row", 5: "addmax", 6: "max3"}
K8_KERNEL = "K9 i16_chain_kernel I32 addmax"  # K8's chain is K9's int32 addmax chain (ops/vpu_chain.py)
I16_CHAIN_ITERS = 2048  # roofline.i16's chains: ~2 ms a launch, and each one's plain version well under 1 s
# The reference Performance suite's queries (bench.py --full), in its order.
SUITE = ("P02232", "P05013", "P14942", "P07327", "P01008", "P42357", "P03435", "P21177", "Q38941",
         "P27895", "P07756", "P19096", "P28167", "P0C6B8", "P20930", "Q7TMA5", "P08519")


def say(phase, **kw):
    print(f"{phase}: " + json.dumps(kw, sort_keys=False), flush=True)


def events_ms(fn, reps=1):
    """(mean device milliseconds of fn() over reps, the last result): the
    port's CUDA-event timer, swtpu_torch.tools.roofline.events_ms."""
    from swtpu_torch.tools.roofline import events_ms as timed

    return timed(fn, reps)


def phase_card():
    import torch

    from swtpu_torch.tools.roofline import card

    smi = card(check=True)
    print(smi, flush=True)
    say("card", name=torch.cuda.get_device_name(0), nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)
    return smi


def k10_label(v, strip, ilp):
    """phase_build's name of K10 instantiation (variant, strip, ilp)."""
    return f"K10 sw_rows_wave_lab_kernel {v} S{strip}" + (f" ILP{ilp}" if ilp != 1 else "")


def phase_build():
    import re

    from swtpu_torch.ops import _build, rows_lab

    names = sorted(p.stem for p in _build.CSRC.glob("*.cu"))
    host = sorted(p.stem for p in _build.CSRC.glob("*.cpp"))  # the native host runtime, built by g++
    for name in names + host:  # build from the sources every run, never from a stale library
        _build.library_path(name).unlink(missing_ok=True)
    t0 = time.perf_counter()
    built = _build.build(*names, *host)
    for name in host:
        say("build", source=f"swtpu_torch/csrc/{name}.cpp", compiler="g++", flags=list(_build.GXX_FLAGS),
            seconds=round(built[name]["seconds"], 3))
    cuobjdump = Path(_build.nvcc()).with_name("cuobjdump")
    out = {}

    def label(mangled):  # K1's shapes; sw_rows.cu's K2/K3 shapes; K7; the labs; K9 (and K8)
        k4 = re.search(r"sw_wave_band_kernelILi(\d+)ELi(\d+)E", mangled)
        if k4:
            return f"K4 sw_wave_band_kernel H{k4.group(1)} B{k4.group(2)} wavefront"
        lab = re.search(r"sw_band_lab_kernelILi(\d+)ELi(\d+)ELi(\d)E", mangled)
        if lab:
            h, d, skip = lab.groups()
            return f"K5/K6 sw_band_lab_kernel H{h} D{d} {LAB_SKIPS[int(skip)]}"
        k10 = re.search(r"sw_rows_wave_lab_kernelILi(\d+)ELi(\d)ELb([01])ELi(\d+)E", mangled)
        if k10:  # K10: sw_rows_wave_lab_kernel<H, ILP, ROLL, BLOCK>, named by rows_lab's table
            h, ilp, roll, block = (int(x) for x in k10.groups())
            for v, strip, i in rows_lab.INSTANCES:
                if (strip, i, v == "v41", rows_lab.BLOCK_THREADS[v, strip]) == (h, ilp, roll == 1, block):
                    return k10_label(v, strip, i)
            return mangled
        i16 = re.search(r"i16_(chain|tile)_kernelINS_\d+(I32|I16x2)E(?:Li(\d)E)?", mangled)
        if i16:
            kind, typ, op = i16.groups()
            return f"K9 i16_{kind}_kernel {typ}" + (f" {I16_OPS[int(op)]}" if op else "")
        rows = re.search(r"sw_rows_kernelILi(\d+)ELi(\d+)E", mangled)  # K2 and K3: sw_rows_kernel<G, H>
        if rows:
            g, h = rows.groups()
            return f"K2/K3 sw_rows_kernel G{g} H{h} " + ("band sweep" if g == "1" else "wavefront")
        for kernel, tag in (("coarse_counts_kernel", "K7"), ("mma_probe_kernel", "K7"), ("kmer_signatures_kernel", "K7")):
            if kernel in mangled:
                return f"{tag} {kernel}"
        long_route = re.search(r"sw_long_kernelILb([01])E", mangled)  # the prefilter's long route: sw_long_kernel<AFFINE>
        if long_route:
            return "sw_long_kernel " + ("affine" if long_route.group(1) == "1" else "linear")
        # K1: sw_wave_kernel<AFFINE, HAND_OFF, G> (the warp wavefront), sw_band_kernel<AFFINE, HAND_OFF, H>
        wave = re.search(r"sw_(wave|band)_kernelILb([01])ELb([01])ELi(\d+)E", mangled)
        if wave is None:
            return mangled
        kind, aff, hand, n = wave.groups()
        return (("affine" if aff == "1" else "linear") + (" hand-off" if hand == "1" else "")
                + (f" wavefront G{n} H32" if kind == "wave" else f" band sweep H{n}"))

    for name in names:
        log = built[name]["log"]
        if not log:
            raise RuntimeError(f"{name}: no nvcc log: the library was not built by this run")
        kernels = {}
        for block in log.split("Compiling entry function '")[1:]:  # ptxas -v, one block per kernel
            regs = re.search(r"Used (\d+) registers", block)
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
            kernels[label(block.split("'", 1)[0])] = {
                "registers": int(regs.group(1)) if regs else None,
                "spill_bytes": int(spills.group(1)) + int(spills.group(2)) if spills else None,
            }
        if cuobjdump.exists():  # what the compiler made of the cell loop: DPX min/max, special-register reads
            sass = subprocess.run([str(cuobjdump), "-sass", str(built[name]["path"])], capture_output=True,
                                  text=True, timeout=120).stdout
            parts = re.split(r"Function : (\S+)", sass)
            for mangled, body in zip(parts[1::2], parts[2::2]):
                ops = {op: len(re.findall(rf"\b{op}\b", body)) for op in SASS_OPCODES}
                kernels.setdefault(label(mangled), {})["sass_opcodes"] = ops
                if "chain_kernel" in mangled or "sw_band_lab_kernel" in mangled or label(mangled) == SWEEP_LABELS[0]:
                    # K9's chains (K8's among them), K1's linear sweep and K5/K6: the rolled loops' bodies
                    kernels[label(mangled)]["loop_body_opcodes"] = loop_body_opcodes(body)
                if "sw_rows_wave_lab_kernel" in mangled or label(mangled) == K2_WAVE_LABEL:
                    # K10 and the K2 it copies: the column loop's body (4 columns of H x ILP cells)
                    kernels[label(mangled)]["column_loop_opcodes"] = innermost_loop_opcodes(body, "VIADDMNMX")
        say("build", source=f"swtpu_torch/csrc/{name}.cu", seconds=round(time.perf_counter() - t0, 3),
            kernels=kernels, cuobjdump=cuobjdump.exists())
        out[name] = kernels
    k1, k5 = out["sw_wave"].get(SWEEP_LABELS[0], {}), out["sw_wave_lab"].get(SWEEP_LABELS[1], {})
    a, b = k1.get("loop_body_opcodes", {}), k5.get("loop_body_opcodes", {})
    say("build.sweep", k1=SWEEP_LABELS[0], k5=SWEEP_LABELS[1],
        registers=[k1.get("registers"), k5.get("registers")], spill_bytes=[k1.get("spill_bytes"), k5.get("spill_bytes")],
        loop_body_instructions=[sum(a.values()), sum(b.values())],
        loop_body_differences={op: b.get(op, 0) - a.get(op, 0) for op in sorted(set(a) | set(b))
                               if a.get(op, 0) != b.get(op, 0)},
        spills_k5_k6={k: v.get("spill_bytes") for k, v in out["sw_wave_lab"].items() if k.startswith("K5/K6")})
    phase_build_rows_lab(out)
    return out


def phase_build_rows_lab(out):
    """K10 (copies of K2's warp wavefront): each instantiation's threads a
    block, registers and spills (ptxas; raises if ptxas named none of it),
    its launch on P01008's profile over a 64-row and a 1,408-row group (G,
    passes, rows a block, blocks, stage bytes, blocks and warps an SM by the
    runtime's occupancy), and its column loop's instructions a cell
    (cuobjdump -sass) beside K2's G16 wavefront: VIADDMNMX, IADD3 and VIMNMX
    a cell show where the gap terms go, which is what the TPU kernels' gap
    fold moved."""
    from swtpu_torch.ops import rows_lab
    from swtpu_torch.tools.buckets import swissprot_query

    qpad = -(-swissprot_query().length // 32) * 32

    def per_cell(label, cells):
        ops = out["sw_rows"].get(label, {}) if label == K2_WAVE_LABEL else out["sw_rows_lab"].get(label, {})
        loop = ops.get("column_loop_opcodes") or {}
        return {"instructions": sum(loop.values()) / cells if loop else None,
                **{op: loop.get(op, 0) / cells for op in ("VIADDMNMX", "IADD3", "VIMNMX", "VIMNMX3", "SHFL")}}

    inst = {}
    for v, strip, ilp in rows_lab.INSTANCES:
        label = k10_label(v, strip, ilp)
        ptxas = out["sw_rows_lab"].get(label, {})
        if ptxas.get("registers") is None:
            raise AssertionError(f"{label}: ptxas named no such kernel (BLOCK_THREADS against the source?)")
        block = rows_lab.BLOCK_THREADS[v, strip]
        launches = {}
        for rows in (64, 1408):
            g, passes, per_block, blocks, stage, per_sm = rows_lab.card_schedule(v, qpad, strip, ilp, rows, "cuda")
            launches[rows] = dict(g=g, passes=passes, rows_per_block=per_block, blocks=blocks, stage_bytes=stage,
                                  blocks_per_sm=per_sm, warps_per_sm=per_sm * block // 32)
        inst[label] = dict(block_threads=block, registers=ptxas["registers"], spill_bytes=ptxas.get("spill_bytes"),
                           p01008_launch=launches, column_loop_per_cell=per_cell(label, 4 * strip * ilp))
    say("build.rows_lab", profile_rows=qpad, instances=inst, k2=K2_WAVE_LABEL,
        k2_column_loop_per_cell=per_cell(K2_WAVE_LABEL, 4 * 32))


def sass_loops(sass):
    """The rolled loops of a kernel's SASS (cuobjdump): for each backward
    branch, the opcodes of the instructions between its target and it."""
    import re

    ins = []
    for ln in sass.splitlines():
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)\S*\s*(.*)", ln)
        if m:
            ins.append((int(m.group(1), 16), m.group(2), m.group(3)))
    loops = []
    for addr, op, rest in ins:
        target = re.match(r"(0x[0-9a-f]+)", rest) if op == "BRA" else None
        if target and int(target.group(1), 16) < addr:
            loops.append([o for a, o, _ in ins if int(target.group(1), 16) <= a < addr])
    return loops


def loop_body_opcodes(sass):
    """Opcode counts of the instructions of a kernel's SASS that lie in its
    rolled loops' bodies, a nested loop's once for each loop around it."""
    counts = {}
    for body in sass_loops(sass):
        for o in body:
            counts[o] = counts.get(o, 0) + 1
    return counts


def innermost_loop_opcodes(sass, opcode):
    """Opcode counts of the shortest rolled loop of a kernel's SASS that
    holds at least 90% of the most ``opcode`` any loop holds: its inner
    column loop, not the pass loop around it."""
    loops = sass_loops(sass)
    most = max((body.count(opcode) for body in loops), default=0)
    inner = min((body for body in loops if most and body.count(opcode) >= 0.9 * most), key=len, default=[])
    return {o: inner.count(o) for o in set(inner)}


def random_bucket(rng, qlen, ws, n_segs, lanes, n_queries=None):
    """Seeded random profile (a stack of n_queries profiles of lengths
    qlen - k, if given) and chained bucket; all but the last flat slot hold
    a subject."""
    import numpy as np
    import torch

    from swtpu_torch.matrices import blosum50_ref
    from swtpu_torch.ops.profile import PAD_SUBJECT, make_profile

    qpad = -(-qlen // 32) * 32
    lens = [qlen] if n_queries is None else [max(1, qlen - k) for k in range(n_queries)]
    profs = [make_profile(rng.integers(0, 25, n).astype(np.int8), blosum50_ref(), pad_rows_to=qpad) for n in lens]
    prof = profs[0] if n_queries is None else np.stack(profs)
    stack = np.full((n_segs * ws + 32, lanes), PAD_SUBJECT, dtype=np.int8)
    lens = rng.integers(1, ws + 1, lanes * n_segs - 1)
    for k, n in enumerate(lens):
        stack[(k % n_segs) * ws : (k % n_segs) * ws + n, k // n_segs] = rng.integers(0, 25, n)
    return torch.from_numpy(prof).cuda(), torch.from_numpy(stack).cuda()


def phase_kernel():
    import numpy as np
    import torch

    from swtpu_torch.ops import wave_sw

    rng = np.random.default_rng(0)
    cases = [c[:4] for c in KERNEL_CASES]  # (query length, segment width, n_segs, lanes)
    worst = 0
    for qlen, ws, n_segs, lanes in cases:
        prof, stack = random_bucket(rng, qlen, ws, n_segs, lanes)
        got = wave_sw.sw_wave(prof, stack, gap=2, n_segs=n_segs)
        want = wave_sw.sw_wave_plain(prof, stack, gap=2, n_segs=n_segs)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        if err or not torch.equal(got, want):
            raise AssertionError(f"kernel != plain at qlen={qlen} ws={ws} n_segs={n_segs} lanes={lanes}: max err {err}")
    sat = phase_kernel_saturating()
    say("kernel", cases=len(cases), max_abs_err=worst, tolerance="exact", saturating=sat)
    return worst


def phase_kernel_saturating():
    """K1's int16x2 kernel on lanes that pass its int16 ceiling: W-run copies
    scoring 32,640 to 33,000 (synth.saturating_bucket) on a 2,400-row query,
    one query and a 3-query stack on chained segments, linear and affine, at
    every compiled (G, H): bit-equal to the plain version after the rescore,
    exactly the entries over 32,640 at -1 without it, each rescore counted on
    the device; the int32 kernel equal; a hand-off and a gap past
    I16_GAP_MAX on the int32 kernel, without a rescore."""
    import torch

    from swtpu_torch import synth
    from swtpu_torch.ops import wave_sw

    dev = torch.device("cuda")
    flagged = launches = 0
    for n_q, n_segs in ((1, 1), (3, 2)):
        profile, bucket = synth.saturating_bucket(7, n_segs=n_segs, lanes=8 // n_segs + 2, n_queries=n_q)
        prof, stack = torch.from_numpy(profile).cuda(), torch.from_numpy(bucket).cuda()
        for kw in (dict(gap=2), dict(gap_open=10, gap_extend=2)):
            want = wave_sw.sw_wave_plain(prof, stack, n_segs=n_segs, **kw)
            over = want > wave_sw.SAT16
            for shape in wave_sw.SHAPES:
                total, before = int(wave_sw.rescore_counter(dev)[0]), wave_sw.sw_wave.int16_launches
                got = wave_sw.sw_wave(prof, stack, n_segs=n_segs, shape=shape, **kw)
                raw = wave_sw._sw_wave_route(prof, stack, n_segs=n_segs, shape=shape, rescore=False, **kw)
                int32 = wave_sw._sw_wave_route(prof, stack, n_segs=n_segs, shape=shape, int32=True, **kw)
                where = f"Q={n_q} n_segs={n_segs} {kw} shape={shape}"
                if not (torch.equal(got, want) and torch.equal(int32, want)):
                    raise AssertionError(f"K1 on saturating lanes != plain at {where}")
                if not (torch.equal(raw == -1, over) and torch.equal(raw[~over], want[~over])):
                    raise AssertionError(f"the int16x2 kernel's flags are not the entries over 32,640 at {where}")
                if (int(wave_sw.rescore_counter(dev)[0]) - total, wave_sw.sw_wave.int16_launches - before) != (
                        int(over.sum()), 2):
                    raise AssertionError(f"rescore count or int16x2 launches off at {where}")
                flagged += int(over.sum())
                launches += 1
    before = (wave_sw.sw_wave.int16_launches, wave_sw.sw_wave.rescore_launches)
    scores, carry = wave_sw.sw_wave(prof[0], stack, gap=2, n_segs=2, return_carry=True)
    wide = wave_sw.sw_wave(prof, stack, gap=wave_sw.I16_GAP_MAX + 1, n_segs=2)
    if (wave_sw.sw_wave.int16_launches, wave_sw.sw_wave.rescore_launches) != before or not (
            torch.equal(scores, wave_sw.sw_wave_plain(prof[0], stack, gap=2, n_segs=2))
            and torch.equal(wide, wave_sw.sw_wave_plain(prof, stack, gap=wave_sw.I16_GAP_MAX + 1, n_segs=2))):
        raise AssertionError("a hand-off or a wide gap did not run the int32 kernel exactly")
    return dict(launches=launches, shapes=[list(s) for s in wave_sw.SHAPES], flagged_entries=flagged,
                hand_off_and_wide_gap_on_int32=True)


def phase_kernel_multi():
    """The multi-query mode: a (Q, qpad, 32) stack in one launch against the
    plain version, which scores the queries one after another."""
    import numpy as np
    import torch

    from swtpu_torch.ops import wave_sw

    rng = np.random.default_rng(1)
    cases = MULTI_CASES  # (longest query, segment width, n_segs, lanes, Q)
    worst = 0
    for qlen, ws, n_segs, lanes, n_q in cases:
        prof, stack = random_bucket(rng, qlen, ws, n_segs, lanes, n_queries=n_q)
        before = wave_sw.sw_wave.multi_launches
        got = wave_sw.sw_wave(prof, stack, gap=2, n_segs=n_segs)
        want = wave_sw.sw_wave_plain(prof, stack, gap=2, n_segs=n_segs)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        if wave_sw.sw_wave.multi_launches != before + 1 or err or not torch.equal(got, want):
            raise AssertionError(f"multi-query kernel != plain at qlen={qlen} ws={ws} n_segs={n_segs} "
                                 f"lanes={lanes} Q={n_q}: max err {err}")
    say("kernel.multi", cases=len(cases), queries=sorted({c[-1] for c in cases}), max_abs_err=worst, tolerance="exact")
    return worst


def phase_kernel_affine():
    """The affine mode on the single- and multi-query case lists against its
    plain version, for each gap pair; open == extend also against the linear
    kernel at that gap, bit for bit."""
    import numpy as np
    import torch

    from swtpu_torch.ops import wave_sw

    t0 = time.perf_counter()
    rng = np.random.default_rng(2)
    worst = 0
    for qlen, ws, n_segs, lanes, n_q in KERNEL_CASES + MULTI_CASES:
        prof, stack = random_bucket(rng, qlen, ws, n_segs, lanes, n_queries=n_q)
        for o, e in GAP_PAIRS:
            before = wave_sw.sw_wave.affine_launches
            got = wave_sw.sw_wave(prof, stack, n_segs=n_segs, gap_open=o, gap_extend=e)
            want = wave_sw.sw_wave_plain(prof, stack, n_segs=n_segs, gap_open=o, gap_extend=e)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            worst = max(worst, err)
            where = f"qlen={qlen} ws={ws} n_segs={n_segs} lanes={lanes} Q={n_q} gaps=({o}, {e})"
            if wave_sw.sw_wave.affine_launches != before + 1 or err or not torch.equal(got, want):
                raise AssertionError(f"affine kernel != plain at {where}: max err {err}")
            if o == e and not torch.equal(got, wave_sw.sw_wave(prof, stack, gap=o, n_segs=n_segs)):
                raise AssertionError(f"affine kernel at open == extend != linear kernel at {where}")
    say("kernel.affine", cases=len(KERNEL_CASES + MULTI_CASES), gap_pairs=GAP_PAIRS, max_abs_err=worst,
        tolerance="exact", equal_to_linear_at_gap=[o for o, e in GAP_PAIRS if o == e],
        seconds=round(time.perf_counter() - t0, 3))
    return worst


def phase_kernel_rows():
    """K2 and K3 against their plain versions (row_sw) on seeded random
    stacks: K2 on the whole (C, B, L) stack in one launch, K3 on every
    chunk, and K2's fast16 clamp on the first chunk, each at the shape the
    wrapper picks; then K2 on the stack at every compiled (G, H) shape."""
    import numpy as np
    import torch

    from swtpu_torch.matrices import blosum50_ref
    from swtpu_torch.ops import bucket_sw, row_sw
    from swtpu_torch.ops.profile import PAD_SUBJECT, make_profile

    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    worst = 0
    sat_max = 0
    for qlen, C, B, L, gap in ROW_CASES:
        q = rng.integers(0, 25, qlen).astype(np.int8)
        if qlen > 4000:  # C, H, P, W score 10-15 against themselves: the self-alignment passes 32,767
            q = rng.choice(np.array([4, 8, 14, 17], dtype=np.int8), qlen)
        stack = np.full((C, B, L), PAD_SUBJECT, dtype=np.int8)
        for c in range(C):
            for b in range(B):
                n = int(rng.integers(1, L + 1))
                stack[c, b, :n] = rng.integers(0, 25, n)
        if qlen > 4000 and L >= qlen:
            stack[C // 2, 0, :qlen] = q
        prof = torch.from_numpy(make_profile(q, blosum50_ref(), pad_rows_to=32)).cuda()
        stack = torch.from_numpy(stack).cuda()
        where = f"qlen={qlen} C={C} B={B} L={L} gap={gap}"
        before = (bucket_sw.sw_score_bucket_fused.launches, bucket_sw.sw_score_bucket.launches)
        got = bucket_sw.sw_score_bucket_fused(prof, stack, gap=gap)
        want = row_sw.sw_score_stack(prof, stack, gap=gap, strip=32)
        per_chunk = [bucket_sw.sw_score_bucket(prof, stack[c], gap=gap) for c in range(C)]
        sat = row_sw.fast16_sat(gap, L)
        clamp = bucket_sw.sw_score_bucket_fast16(prof, stack[0], gap=gap, sat=sat)
        clamp_want = row_sw.sw_score_bucket_fast16(prof, stack[0], gap=gap, strip=32, sat=sat, stage_int8=True)
        shaped = [bucket_sw.sw_score_bucket_fused(prof, stack, gap=gap, shape=shape) for shape in bucket_sw.SHAPES]
        torch.cuda.synchronize()
        after = (bucket_sw.sw_score_bucket_fused.launches, bucket_sw.sw_score_bucket.launches)
        if after != (before[0] + 2 + len(bucket_sw.SHAPES), before[1] + C):
            raise AssertionError(f"row kernels launched {after} from {before} at {where}")
        err = int((got.long() - want.long()).abs().max())
        err = max(err, max(int((k.long() - want[c].long()).abs().max()) for c, k in enumerate(per_chunk)))
        err = max(err, max(int((k.long() - want.long()).abs().max()) for k in shaped))
        err = max(err, int((clamp.long() - clamp_want.long()).abs().max()))
        worst = max(worst, err)
        sat_max = max(sat_max, int(want.max()))
        if err or not torch.equal(got, want) or not torch.equal(clamp, clamp_want):
            raise AssertionError(f"row kernels != plain at {where}: max err {err}")
    if sat_max <= 32767:
        raise AssertionError(f"the planted self-alignment scored {sat_max}, within int16")
    say("kernel.rows", cases=len(ROW_CASES), kernels=["K2 sw_score_bucket_fused", "K3 sw_score_bucket",
        "K2 fast16 clamp"], shapes=[f"G{g}H{h}" for g, h in bucket_sw.SHAPES], max_score=sat_max, max_abs_err=worst,
        tolerance="exact",
        seconds=round(time.perf_counter() - t0, 3))
    return worst


def phase_kernel_carry():
    """The band-carry hand-off mode against its plain version on the first
    case list, linear and affine, in query_shard's band slices at n = 4
    (``card_fuzz.band_split``): every slice's scores and carry, from a zero
    carry and from a seeded one; a zero-carry chain's running max against
    one launch over all the bands."""
    import numpy as np
    import torch

    from swtpu_torch.ops import wave_sw
    from swtpu_torch.tools.card_fuzz import hand_off_chain, seeded_carry

    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    worst, groups, launches = 0, 0, 0
    for qlen, ws, n_segs, lanes, _ in KERNEL_CASES:
        prof, stack = random_bucket(rng, qlen, ws, n_segs, lanes)
        for gaps in (dict(gap=2), AFFINE):
            affine = "gap_open" in gaps
            virgin = wave_sw.virgin_carry(stack, affine)
            seeded = seeded_carry(rng, virgin, gaps)
            where = f"qlen={qlen} ws={ws} n_segs={n_segs} lanes={lanes} gaps={gaps}"
            for start in (virgin, seeded):
                before = wave_sw.sw_wave.carry_launches
                best, got = hand_off_chain(wave_sw.sw_wave, prof, stack, start.clone(), n_segs, gaps)
                _, want = hand_off_chain(wave_sw.sw_wave_plain, prof, stack, start.clone(), n_segs, gaps)
                torch.cuda.synchronize()
                if wave_sw.sw_wave.carry_launches != before + len(got):
                    raise AssertionError(f"hand-off chain launched {wave_sw.sw_wave.carry_launches - before} "
                                         f"hand-off kernels for {len(got)} slices at {where}")
                launches += len(got)
                groups += len(got)
                for k, ((s, c), (ps, pc)) in enumerate(zip(got, want)):
                    err = max(int((s.long() - ps.long()).abs().max()), int((c.long() - pc.long()).abs().max()))
                    worst = max(worst, err)
                    if err or not (torch.equal(s, ps) and torch.equal(c, pc)):
                        raise AssertionError(f"hand-off slice {k} != plain at {where}: max err {err}")
                if start is virgin and not torch.equal(best, wave_sw.sw_wave(prof, stack, n_segs=n_segs, **gaps)):
                    raise AssertionError(f"a chain of band slices differs from one launch at {where}")
    say("kernel.carry", cases=len(KERNEL_CASES), gaps=["linear 2", AFFINE], starts=["zero", "seeded"],
        groups_checked=groups, hand_off_launches=launches, max_abs_err=worst, tolerance="exact",
        seconds=round(time.perf_counter() - t0, 3))
    return worst


def phase_goldens():
    import numpy as np

    from swtpu_torch import synth
    from swtpu_torch.config import SWConfig
    from swtpu_torch.io.fasta import Query, parse_database, parse_query
    from swtpu_torch.models.search import SearchEngine

    data = ROOT / "tests" / "data"
    checked = []

    def check(name, scores, golden_file):
        golden = np.loadtxt(data / golden_file, dtype=np.int64)
        if not np.array_equal(scores, golden):
            bad = int((scores != golden).sum())
            raise AssertionError(f"golden {name}: {bad} of {golden.size} scores differ")
        checked.append(name)

    subset = parse_database(data / "uniprot_subset.fasta")
    eng = SearchEngine(SWConfig(), device="cuda")
    for q in ("P02232", "P01008", "P05013"):
        check(q, eng.search(parse_query(data / "queries" / f"{q}.fasta"), subset).scores, f"golden_{q}_subset.txt")
    q = parse_query(data / "queries" / "P02232.fasta")
    res = SearchEngine(device="cuda").search(q, synth.database_from_arrays(synth.synth_scale_db(q.residues)))
    check("scale10k", res.scores, "golden_P02232_scale10k.txt")
    query, seqs = synth.synth_sat_case()
    res = SearchEngine(device="cuda").search(Query("sat", query, ""), synth.database_from_arrays(seqs))
    check("saturation", res.scores, "golden_sat_case.txt")
    say("goldens", checked=checked, tolerance="exact")


def phase_fuzz():
    """fuzz: swtpu_torch.tools.card_fuzz, every function at its own cases and
    seeds: every case bit-exact against the plain version and equal to the
    oracle sample; every (G, H) of both SHAPES tuples ran in every K1 mode,
    K2 and K3; both sides of BAND_THREADS and BAND_ROWS at n = 1 to 4 (the
    tool fails otherwise).  Returns the largest kernel-plain error by
    kernel and mode."""
    from swtpu_torch.ops import bucket_sw, wave_sw
    from swtpu_torch.tools import card_fuzz

    rc, summary = card_fuzz.run()
    say("fuzz", **summary)
    if rc:
        raise AssertionError(f"card fuzz: {summary['failures']} mismatches (MISMATCH lines above)")
    want = [f"K1 {m} {card_fuzz.shape_key(s)}" for m in card_fuzz.K1_MODES for s in wave_sw.SHAPES]
    want += [f"{k} {card_fuzz.shape_key(s)}" for k in ("K2 stack", "K3 bucket") for s in bucket_sw.SHAPES]
    missing = [k for k in want if not summary["launches"].get(k)]
    if missing:
        raise AssertionError(f"card fuzz never launched {missing}")
    return summary["max_abs_err"]


def phase_battery():
    """battery: swtpu_torch.tools.gpu_validate, every check on the card."""
    from swtpu_torch.tools import gpu_validate

    t0 = time.perf_counter()
    results = gpu_validate.run(device="cuda")
    failed = [k for k, ok in results.items() if not ok]
    say("battery", checks=list(results), failed=failed, seconds=round(time.perf_counter() - t0, 3))
    if failed:
        raise AssertionError(f"battery checks failed: {failed}")


def phase_profile(db, engine, first_scores, tmp):
    """profile: the CLI with --profile on the subset writes a Chrome trace
    (its device events and the kernels among them); then one resident
    P01008 search on the SwissProt-shaped database under torch.profiler:
    kernel time by name and the device's busy share over the search's
    window (the device events' sum over the span from the first to the
    last); then profile.i16: the device time a call of K9's elementwise
    tiles and of the library calls of the same op and type (one trace an
    (op, dtype) of each, swtpu_torch.tools.probe_i16.device_split)."""
    import numpy as np

    from swtpu_torch.io.fasta import parse_query
    from swtpu_torch.tools import probe_i16
    from swtpu_torch.utils.profiling import TRACE_NAME, trace, trace_summary

    t0 = time.perf_counter()
    data = ROOT / "tests" / "data"
    out_dir = Path(tmp) / "profile_cli"
    cmd = [sys.executable, "-m", "swtpu_torch", "--query", str(data / "queries" / "P02232.fasta"),
           "--db", str(data / "uniprot_subset.fasta"), "--no-scores", "--profile", str(out_dir)]
    run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
    if run.returncode:
        raise AssertionError(f"--profile exited {run.returncode}: {run.stderr[-2000:]}")
    cli = trace_summary(out_dir / TRACE_NAME)
    say("profile.cli", trace=TRACE_NAME, events=cli["events"], device_events=cli["device_events"],
        kernels=sorted(cli["kernel_ms"]), device_ms=cli["device_ms"], stderr=run.stderr.strip().splitlines()[-2:])
    if not cli["events"]:
        raise AssertionError("the --profile trace holds no events")

    query = parse_query(data / "queries" / f"{MAIN_QUERY}.fasta")
    with trace(Path(tmp) / "profile_search", "cuda") as path:
        t1 = time.perf_counter()
        res = engine.search(query, db)
        wall = time.perf_counter() - t1
    if not np.array_equal(res.scores, first_scores):
        raise AssertionError("the profiled search differs from the unprofiled one")
    s = trace_summary(path)
    say("profile.search", query=MAIN_QUERY, resident=True, wall_seconds=wall,
        device_seconds=res.metrics.device_seconds, events=s["events"], device_events=s["device_events"],
        kernel_ms=s["kernel_ms"], device_ms=s["device_ms"], window_ms=s["window_ms"], busy_share=s["busy_share"],
        device_share_of_wall=s["device_ms"] / 1e3 / wall,
        note=None if s["device_events"] else "the trace holds no device events",
        seconds=round(time.perf_counter() - t0, 3))
    t1 = time.perf_counter()
    say("profile.i16", device_us_a_call=probe_i16.device_split(), of="K9's elementwise tiles (16, 512) and the "
        "library calls, 100 calls a trace", seconds=round(time.perf_counter() - t1, 3))


def phase_scale():
    import numpy as np
    import torch

    from swtpu_torch import synth
    from swtpu_torch.config import SWConfig
    from swtpu_torch.io.fasta import parse_query
    from swtpu_torch.models.search import SearchEngine
    from swtpu_torch.ops import wave_sw
    from swtpu_torch.ops.profile import make_profile

    t0 = time.perf_counter()
    db = synth.synth_database(N_SEQS, seed=0)
    query = parse_query(ROOT / "tests" / "data" / "queries" / f"{MAIN_QUERY}.fasta")
    say("scale.data", sequences=db.n, residues=db.length_sum, longest=int(db.lengths.max()),
        query=MAIN_QUERY, query_length=query.length, seconds=round(time.perf_counter() - t0, 3))

    torch.cuda.reset_peak_memory_stats()
    engine = SearchEngine(SWConfig(), device="cuda")
    # --- the main path: user entry points, counts zeroed just before, read just after
    wave_sw.sw_wave.launches = 0
    t0 = time.perf_counter()
    first = engine.search(query, db)  # packs the database on the card, then scores
    first_wall = time.perf_counter() - t0
    launches = {"sw_wave": wave_sw.sw_wave.launches}
    packed = engine._resident_packed(db)
    groups = packed.wave_groups
    if launches["sw_wave"] != len(groups) or launches["sw_wave"] == 0:
        raise AssertionError(f"main path launched sw_wave {launches['sw_wave']} times for {len(groups)} buckets")

    runs = []
    for _ in range(3):
        res = engine.search(query, db)
        if res.metrics.kernel_launches != 2 * len(groups) or not np.array_equal(res.scores, first.scores):
            raise AssertionError("timed search differs from the first one")
        runs.append(res.metrics)
    dev_s = [m.device_seconds for m in runs]
    resident = sum(g.stack.numel() for g in groups)
    say("scale.search", first_search_wall_s=first_wall, device_seconds=dev_s,
        gcups_device=[m.gcups_device for m in runs], gcups_device_padded=[m.gcups_device_padded for m in runs],
        wall_seconds=[m.wall_seconds for m in runs], transfer_seconds=[m.transfer_seconds for m in runs],
        host_phases_seconds=[m.phases for m in runs], buckets=len(groups), launches_per_search=runs[-1].kernel_launches, resident_bytes=resident,
        max_memory_allocated=torch.cuda.max_memory_allocated())

    # --- the kernel alone, per search and per bucket, and its plain version
    gap = engine.config.gap_penalty
    profile = torch.from_numpy(make_profile(query.residues, engine.matrix, pad_rows_to=wave_sw.W)).cuda()
    kernel_all = lambda: [wave_sw.sw_wave(profile, g.stack, gap=gap, n_segs=g.n_segs) for g in groups]  # noqa: E731
    int32_all = lambda: [wave_sw._sw_wave_route(profile, g.stack, gap=gap, n_segs=g.n_segs, int32=True)  # noqa: E731
                         for g in groups]
    events_ms(kernel_all)  # warm
    events_ms(int32_all)
    kernel_ms, _ = events_ms(kernel_all, reps=3)
    int32_ms, _ = events_ms(int32_all, reps=3)
    per_bucket = []
    for g in groups:
        ms, _ = events_ms(lambda g=g: wave_sw.sw_wave(profile, g.stack, gap=gap, n_segs=g.n_segs))
        ms32, _ = events_ms(lambda g=g: wave_sw._sw_wave_route(profile, g.stack, gap=gap, n_segs=g.n_segs, int32=True))
        per_bucket.append((g.width, g.n_segs, g.lanes, g.lanes * g.n_segs, g.cells * profile.shape[0], round(ms, 4),
                           round(ms32, 4)))
    plain_ms, plain = events_ms(lambda: [wave_sw.sw_wave_plain(profile, g.stack, gap=gap, n_segs=g.n_segs) for g in groups])
    plain_scores = engine._reduce_flat(torch.cat(plain).cpu().numpy(), packed)
    err = int(np.abs(plain_scores.astype(np.int64) - first.scores.astype(np.int64)).max())
    if err or not np.array_equal(plain_scores, first.scores):
        raise AssertionError(f"full-scale scores differ from the plain version: max err {err}")

    qpad = profile.shape[0]
    cells = sum(qpad * g.n_segs * g.seg_cols * g.lanes for g in groups)
    nbytes = sum(g.stack.numel() + qpad * 32 + 4 * g.rows for g in groups)
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * OPS_PER_CELL * cells / int32_ops_per_s
    bound_ms = max(bytes_ms, ops_ms)
    say("scale.kernel", kernel_ms_per_search=kernel_ms, kernel_ms_per_launch=kernel_ms / len(groups),
        int32_kernel_ms_per_search=int32_ms, plain_ms_per_search=plain_ms, bound_ms=bound_ms,
        bound_share=bound_ms / kernel_ms, int32_bound_share=bound_ms / int32_ms,
        cells_per_search=cells, true_cells=query.length * db.length_sum, max_abs_err_vs_plain=err)
    say("scale.buckets", columns=["width", "n_segs", "lanes", "threads", "cells", "ms", "int32_ms"], rows=per_bucket)
    entry = {
        "name": "sw_wave", "route": "cuda", "source": "swtpu_torch/csrc/sw_wave.cu",
        "replaces": "swtpu/ops/wave_sw.py:815", "launches": launches["sw_wave"], "max_abs_err": err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None,
    }
    return entry, db, engine, [row[-2] for row in per_bucket], first.scores


def phase_native_parse_and_cli(db, engine, tmp):
    """native.parse: the SwissProt-shaped database written as a FASTA file
    (60 columns, headers seq<i>) into the temporary directory ``tmp``,
    parsed by the native parse and by its plain version, each bit-equal to
    the other and to the database in memory.  cli.search: ``python -m
    swtpu_torch`` on that file and P01008 as a subprocess on the card, its
    id:score dump equal line for line to the engine's scores of the database
    in memory.  Returns the file's path: dist.fleet reads it, then deletes
    it."""
    import numpy as np

    from swtpu_torch.alphabet import decode
    from swtpu_torch.io.fasta import parse_database, parse_database_plain, parse_query, write_fasta

    qpath = ROOT / "tests" / "data" / "queries" / f"{MAIN_QUERY}.fasta"
    want = engine.search(parse_query(qpath), db).scores  # phase_scale's resident engine: in-memory scores
    path = Path(tmp) / "swissprot_shaped.fasta"
    t0 = time.perf_counter()
    text, off = decode(db.residues), db.offsets.tolist()
    write_fasta(path, [text[off[i] : off[i + 1]] for i in range(db.n)], width=60)
    del text
    write_s = time.perf_counter() - t0
    nbytes = path.stat().st_size
    t0 = time.perf_counter()
    parsed = parse_database(path)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plain = parse_database_plain(path)
    plain_s = time.perf_counter() - t0
    for name, got in (("native", parsed), ("plain", plain)):
        if not (np.array_equal(got.offsets, db.offsets) and np.array_equal(got.residues, db.residues)):
            raise AssertionError(f"the {name} parse of the written file differs from the database in memory")
    del plain
    say("native.parse", bytes=nbytes, sequences=parsed.n, residues=parsed.length_sum, write_seconds=write_s,
        native_seconds=native_s, plain_seconds=plain_s, native_mb_per_s=1e-6 * nbytes / native_s,
        plain_mb_per_s=1e-6 * nbytes / plain_s, bit_equal=True)
    del parsed

    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "swtpu_torch", "--query", str(qpath), "--db", str(path)],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"the CLI exited {out.returncode}:\n{out.stderr[-4000:]}")
    lines = out.stdout.splitlines()
    dump = [ln for ln in lines if ":" in ln and ln.split(":")[0].isdigit()]
    if dump != [f"{i}:{v}" for i, v in enumerate(want.tolist())]:
        raise AssertionError(f"the CLI's id:score dump ({len(dump)} lines) differs from the in-memory scores")
    metrics = {}
    for ln in lines[lines.index("METRICS:") + 1 :]:
        key, _, rest = ln.partition(":")
        metrics[key] = float(rest.split()[0])
    say("cli.search", query=MAIN_QUERY, command="python -m swtpu_torch --query Q --db D", wall_seconds=wall,
        lines=len(dump), metrics=metrics, equal_to_in_memory_scores=True)
    return path


def bound(groups, pieces, ops_per_cell=OPS_PER_CELL):
    """(bound ms, bound_by, cells) of scoring every (Q, qpad) piece against
    every bucket: the larger of the bytes moved (bucket, profiles and scores
    once each) over the memory rate and ``ops_per_cell`` int32 operations a
    padded cell (OPS_PER_CELL linear, OPS_PER_CELL_AFFINE affine) over the
    int32 rate."""
    cells = sum(n_q * qpad * g.n_segs * g.seg_cols * g.lanes for n_q, qpad in pieces for g in groups)
    nbytes = sum(g.stack.numel() + n_q * (qpad * 32 + 4 * g.rows) for n_q, qpad in pieces for g in groups)
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops_per_cell * cells / int32_ops_per_s
    return max(bytes_ms, ops_ms), "operations" if ops_ms >= bytes_ms else "bytes", cells


def phase_serving(db, engine, q1_bucket_ms):
    import numpy as np
    import torch

    from swtpu_torch.config import SWConfig
    from swtpu_torch.io.fasta import Query, parse_query
    from swtpu_torch.models.search import SearchEngine, SearchResult
    from swtpu_torch.ops import wave_sw

    queries = [parse_query(ROOT / "tests" / "data" / "queries" / f"{name}.fasta") for name in SUITE]
    packed = engine._resident_packed(db)
    groups = packed.wave_groups
    true_cells = sum(q.length for q in queries) * db.length_sum
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    singles = [engine.search(q, db) for q in queries]
    single_wall = time.perf_counter() - t0
    single_dev = sum(r.metrics.device_seconds for r in singles)
    say("serving.single", queries=len(queries), query_rows=sum(q.length for q in queries),
        device_seconds=single_dev, wall_seconds=single_wall, gcups_device=1e-9 * true_cells / single_dev,
        gcups_wall=1e-9 * true_cells / single_wall, launches=sum(r.metrics.kernel_launches for r in singles))

    def check(name, results, subset=None):
        for i, res in zip(subset or range(len(queries)), results):
            if not np.array_equal(res.scores, singles[i].scores):
                raise AssertionError(f"{name}: {SUITE[i]} differs from its single search")

    # --- search_many: the batched path, counts zeroed just before and read just after
    pieces = engine._query_pieces(queries)
    wave_sw.sw_wave.launches = wave_sw.sw_wave.multi_launches = 0
    t0 = time.perf_counter()
    many = engine.search_many(queries, db)
    many_wall = time.perf_counter() - t0
    launches = {"sw_wave": wave_sw.sw_wave.launches, "sw_wave_multi": wave_sw.sw_wave.multi_launches}
    if launches["sw_wave_multi"] != len(pieces) * len(groups) or launches["sw_wave"] != launches["sw_wave_multi"]:
        raise AssertionError(f"search_many launched {launches} for {len(pieces)} pieces x {len(groups)} buckets")
    check("search_many", many)
    many_dev = sum(r.metrics.device_seconds for r in many)
    say("serving.many", queries=len(queries), pieces=[[qpad, [SUITE[i] for i in p]] for qpad, p in pieces],
        launches_per_batch=launches["sw_wave_multi"], buckets=len(groups), device_seconds=many_dev,
        wall_seconds=many_wall, gcups_device=1e-9 * true_cells / many_dev, gcups_wall=1e-9 * true_cells / many_wall,
        single_device_seconds=single_dev, bit_equal_to_single=True)

    # --- the multi-query launches alone, batch and per bucket, and the plain version on P02232's piece
    stacks = [(engine._piece_profiles(queries, qpad, p), p) for qpad, p in pieces]
    gap = engine.config.gap_penalty
    batch = lambda: [wave_sw.sw_wave(pr, g.stack, gap=gap, n_segs=g.n_segs) for pr, _ in stacks for g in groups]  # noqa: E731
    batch_ms, _ = events_ms(batch)  # warm: search_many just ran the same launches
    batch32 = lambda: [wave_sw._sw_wave_route(pr, g.stack, gap=gap, n_segs=g.n_segs, int32=True)  # noqa: E731
                       for pr, _ in stacks for g in groups]
    events_ms(batch32)  # warm
    batch32_ms, _ = events_ms(batch32)
    bound_ms, bound_by, cells = bound(groups, [(pr.shape[0], pr.shape[1]) for pr, _ in stacks])
    i_p = SUITE.index("P02232")
    prof_p = next(pr for pr, p in stacks if p == [i_p])
    sample_ms, _ = events_ms(lambda: [wave_sw.sw_wave(prof_p, g.stack, gap=gap, n_segs=g.n_segs) for g in groups])
    plain_ms, plain = events_ms(lambda: [wave_sw.sw_wave_plain(prof_p, g.stack, gap=gap, n_segs=g.n_segs) for g in groups])
    plain_scores = engine._reduce_flat(torch.cat(plain, dim=-1)[0].cpu().numpy(), packed)
    err = int(np.abs(plain_scores.astype(np.int64) - many[i_p].scores.astype(np.int64)).max())
    if err or not np.array_equal(plain_scores, many[i_p].scores):
        raise AssertionError(f"P02232's batched scores differ from the plain version: max err {err}")
    say("serving.kernel", kernel_ms_per_batch=batch_ms, int32_kernel_ms_per_batch=batch32_ms, bound_ms=bound_ms,
        bound_by=bound_by, bound_share=bound_ms / batch_ms, int32_bound_share=bound_ms / batch32_ms,
        padded_cells=cells, true_cells=true_cells,
        sample="P02232 piece (Q=1, qpad %d), all buckets" % prof_p.shape[1], sample_kernel_ms=sample_ms,
        sample_plain_ms=plain_ms, max_abs_err_vs_plain=err)

    # --- search_queued
    t0 = time.perf_counter()
    queued = engine.search_queued(queries, db)
    queued_wall = time.perf_counter() - t0
    check("search_queued", queued)
    queued_dev = sum(r.metrics.device_seconds for r in queued)
    say("serving.queued", queries=len(queries), launches_per_batch=queued[0].metrics.kernel_launches,
        device_seconds=queued_dev, wall_seconds=queued_wall, gcups_device=1e-9 * true_cells / queued_dev,
        gcups_wall=1e-9 * true_cells / queued_wall, bit_equal_to_single=True)

    # --- device top-K and E-values, against the full array and the port's own full-array fit
    four = [SUITE.index(n) for n in ("P02232", "P05013", "P14942", "P01008")]
    topk_engine = SearchEngine(SWConfig(top_k=10, evalue=True), device="cuda")
    fit = SearchEngine(SWConfig(evalue=True), device="cuda")
    worst_rel, fallbacks = 0.0, 0
    for name, run in (("search_many", topk_engine.search_many), ("search_queued", topk_engine.search_queued)):
        for i, res in zip(four, run([queries[j] for j in four], db)):
            full = SearchResult(scores=singles[i].scores, metrics=singles[i].metrics)
            if res.top_k(10) != full.top_k(10):
                raise AssertionError(f"{name} top-K of {SUITE[i]} differs from the full array's")
            fallbacks += res.scores is not None
            want = fit._attach_null(full, queries[i], db).top_k_stats(10)
            for g, w in zip(res.top_k_stats(10), want):
                rel = max(abs(g.evalue - w.evalue) / max(abs(w.evalue), 1e-300), abs(g.bits - w.bits) / max(abs(w.bits), 1e-300))
                worst_rel = max(worst_rel, rel)
                if (g.id, g.score) != (w.id, w.score) or rel > 1e-9:
                    raise AssertionError(f"{name} E-values of {SUITE[i]} are off the full-array fit: rel {rel}")
    say("serving.topk", queries=[SUITE[i] for i in four], k=10, hits_equal_full_array=True,
        max_rel_err_evalue_bits=worst_rel, tolerance=1e-9, tie_fallbacks=fallbacks)

    # --- streaming: not resident, against the resident scores
    three = [SUITE.index(n) for n in ("P02232", "P05013", "P14942")]
    t0 = time.perf_counter()
    streamed = SearchEngine(SWConfig(device_resident=False), device="cuda").search_many([queries[i] for i in three], db)
    stream_wall = time.perf_counter() - t0
    check("streamed search_many", streamed, three)
    say("serving.streamed", queries=[SUITE[i] for i in three], wall_seconds=stream_wall,
        device_seconds=sum(r.metrics.device_seconds for r in streamed),
        pack_seconds=sum(r.metrics.phases["pack_and_put"] for r in streamed),
        launches=streamed[0].metrics.kernel_launches, bit_equal_to_resident=True,
        max_memory_allocated=torch.cuda.max_memory_allocated())

    # --- 16 queries in one launch against 16 single launches, bucket by bucket
    rng = np.random.default_rng(13)
    base = queries[SUITE.index(MAIN_QUERY)]
    variants = []
    for r in range(16):  # bench.py --repeat's content variants: same length, 4 residues changed
        res = base.residues.copy()
        idx = rng.choice(res.shape[0], 4, replace=False)
        res[idx] = rng.integers(0, 25, 4).astype(np.int8)
        variants.append(Query(f"{MAIN_QUERY}#{r}", res, ""))
    prof16 = engine._piece_profiles(variants, engine._query_pad(base.length, wave_sw.W), list(range(16)))
    q16_ms = []
    for g in groups:
        ms, out16 = events_ms(lambda g=g: wave_sw.sw_wave(prof16, g.stack, gap=gap, n_segs=g.n_segs))
        q16_ms.append(ms)
        if not torch.equal(out16[3], wave_sw.sw_wave(prof16[3], g.stack, gap=gap, n_segs=g.n_segs)):
            raise AssertionError("a 16-query launch differs from the single launch of its query")
    narrow = [k for k, g in enumerate(groups) if g.rows < 1024]
    share = lambda ms: sum(ms[k] for k in narrow) / sum(ms)  # noqa: E731
    say("serving.q16", query=MAIN_QUERY, variants=16, narrow_buckets=len(narrow),
        q1_ms_x16=16 * sum(q1_bucket_ms), q16_ms=sum(q16_ms), narrow_share_q1=share(q1_bucket_ms),
        narrow_share_q16=share(q16_ms), columns=["width", "threads_per_query", "q1_ms", "q16_ms", "q16_over_16_q1"],
        rows=[(g.width, g.rows, round(a, 4), round(b, 4), round(b / (16 * a), 4))
              for g, a, b in zip(groups, q1_bucket_ms, q16_ms)],
        max_memory_allocated=torch.cuda.max_memory_allocated())
    return {
        "name": "sw_wave (multi-query mode)", "route": "cuda", "source": "swtpu_torch/csrc/sw_wave.cu",
        "replaces": "swtpu/ops/wave_sw.py:815", "launches": launches["sw_wave_multi"], "max_abs_err": err,
        "ms": batch_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "plain_sample": "P02232 piece, all buckets (kernel %.3f ms on the same sample)" % sample_ms,
    }, [r.scores for r in singles]


def phase_goldens_affine():
    """The committed subset under affine gaps (10, 1) on the card, against
    the port's NumPy oracle, one subject at a time."""
    import numpy as np

    from swtpu_torch.config import SWConfig
    from swtpu_torch.io.fasta import parse_database, parse_query
    from swtpu_torch.models.search import SearchEngine
    from swtpu_torch.ops import wave_sw
    from swtpu_torch.ops.oracle import sw_affine_score_diag

    t0 = time.perf_counter()
    data = ROOT / "tests" / "data"
    subset = parse_database(data / "uniprot_subset.fasta")
    eng = SearchEngine(SWConfig(gap_open=10, gap_extend=1), device="cuda")
    for name in ("P02232", "P01008", "P05013"):
        q = parse_query(data / "queries" / f"{name}.fasta")
        before = wave_sw.sw_wave.affine_launches
        res = eng.search(q, subset)
        buckets = len(eng._resident_packed(subset).wave_groups)
        if wave_sw.sw_wave.affine_launches - before != buckets or res.metrics.kernel_launches != 2 * buckets:
            raise AssertionError(f"affine subset search of {name} did not launch the affine kernel once per bucket")
        want = np.array([sw_affine_score_diag(q.residues, subset.sequence(i), eng.matrix, 10, 1) for i in range(subset.n)])
        if not np.array_equal(res.scores, want):
            raise AssertionError(f"affine subset {name}: {int((res.scores != want).sum())} of {subset.n} scores differ from the oracle")
    say("goldens.affine", checked=["P02232", "P01008", "P05013"], gaps=(10, 1), oracle="sw_affine_score_diag",
        tolerance="exact", seconds=round(time.perf_counter() - t0, 3))


def phase_affine(db, linear_bucket_ms):
    """Phase 7: the resident SwissProt-shaped database under affine gaps."""
    import numpy as np
    import torch

    from swtpu_torch.config import SWConfig
    from swtpu_torch.io.fasta import parse_query
    from swtpu_torch.models.search import SearchEngine, SearchResult
    from swtpu_torch.ops import wave_sw
    from swtpu_torch.ops.profile import make_profile

    t_phase = time.perf_counter()
    queries = [parse_query(ROOT / "tests" / "data" / "queries" / f"{name}.fasta") for name in SUITE]
    query = queries[SUITE.index(MAIN_QUERY)]
    cfg = SWConfig(**AFFINE)
    torch.cuda.reset_peak_memory_stats()
    engine = SearchEngine(cfg, device="cuda")
    # --- this phase's path: user entry points, counts zeroed just before, read just after
    wave_sw.sw_wave.launches = wave_sw.sw_wave.affine_launches = 0
    t0 = time.perf_counter()
    first = engine.search(query, db)  # packs the database on the card, then scores
    first_wall = time.perf_counter() - t0
    launches = wave_sw.sw_wave.affine_launches
    packed = engine._resident_packed(db)
    groups = packed.wave_groups
    if launches != len(groups) or wave_sw.sw_wave.launches != launches:
        raise AssertionError(f"affine search launched the affine kernel {launches} times "
                             f"({wave_sw.sw_wave.launches} in all) for {len(groups)} buckets")
    runs = []
    for _ in range(3):
        res = engine.search(query, db)
        if res.metrics.kernel_launches != 2 * len(groups) or not np.array_equal(res.scores, first.scores):
            raise AssertionError("timed affine search differs from the first one")
        runs.append(res.metrics)
    say("affine.search", gaps=AFFINE, query=MAIN_QUERY, first_search_wall_s=first_wall,
        device_seconds=[m.device_seconds for m in runs], gcups_device=[m.gcups_device for m in runs],
        wall_seconds=[m.wall_seconds for m in runs], launches_per_search=runs[-1].kernel_launches,
        buckets=len(groups))

    # --- the kernel alone, per search and per bucket, and its plain version on the card
    profile = torch.from_numpy(make_profile(query.residues, engine.matrix, pad_rows_to=wave_sw.W)).cuda()
    kernel_all = lambda: [wave_sw.sw_wave(profile, g.stack, n_segs=g.n_segs, **AFFINE) for g in groups]  # noqa: E731
    int32_all = lambda: [wave_sw._sw_wave_route(profile, g.stack, n_segs=g.n_segs, int32=True, **AFFINE)  # noqa: E731
                         for g in groups]
    events_ms(kernel_all)  # warm
    events_ms(int32_all)
    kernel_ms, _ = events_ms(kernel_all, reps=3)
    int32_ms, _ = events_ms(int32_all, reps=3)
    bucket_ms = [events_ms(lambda g=g: wave_sw.sw_wave(profile, g.stack, n_segs=g.n_segs, **AFFINE))[0] for g in groups]
    plain_ms, plain = events_ms(lambda: [wave_sw.sw_wave_plain(profile, g.stack, n_segs=g.n_segs, **AFFINE) for g in groups])
    plain_scores = engine._reduce_flat(torch.cat(plain).cpu().numpy(), packed)
    err = int(np.abs(plain_scores.astype(np.int64) - first.scores.astype(np.int64)).max())
    if err or not np.array_equal(plain_scores, first.scores):
        raise AssertionError(f"affine full-scale scores differ from the plain version: max err {err}")
    bound_ms, bound_by, cells = bound(groups, [(1, profile.shape[0])], OPS_PER_CELL_AFFINE)
    narrow = [k for k, g in enumerate(groups) if g.rows < 1024]
    share = lambda ms: sum(ms[k] for k in narrow) / sum(ms)  # noqa: E731
    say("affine.kernel", kernel_ms_per_search=kernel_ms, kernel_ms_per_launch=kernel_ms / len(groups),
        int32_kernel_ms_per_search=int32_ms, int32_bound_share=bound_ms / int32_ms,
        plain_ms_per_search=plain_ms, bound_ms=bound_ms, bound_by=bound_by, bound_share=bound_ms / kernel_ms,
        cells_per_search=cells, true_cells=query.length * db.length_sum, max_abs_err_vs_plain=err,
        narrow_buckets=len(narrow), narrow_share_linear=share(linear_bucket_ms), narrow_share_affine=share(bucket_ms))
    say("affine.buckets", columns=["width", "n_segs", "lanes", "threads", "linear_ms", "affine_ms", "affine_over_linear"],
        rows=[(g.width, g.n_segs, g.lanes, g.lanes * g.n_segs, round(a, 4), round(b, 4), round(b / a, 4))
              for g, a, b in zip(groups, linear_bucket_ms, bucket_ms)])

    # --- the 17 queries: single searches, then search_many, bit-equal
    true_cells = sum(q.length for q in queries) * db.length_sum
    t0 = time.perf_counter()
    singles = [engine.search(q, db) for q in queries]
    single_wall = time.perf_counter() - t0
    single_dev = sum(r.metrics.device_seconds for r in singles)
    pieces = engine._query_pieces(queries)
    wave_sw.sw_wave.launches = wave_sw.sw_wave.affine_launches = 0
    t0 = time.perf_counter()
    many = engine.search_many(queries, db)
    many_wall = time.perf_counter() - t0
    if not wave_sw.sw_wave.affine_launches == wave_sw.sw_wave.launches == len(pieces) * len(groups):
        raise AssertionError(f"affine search_many launched {wave_sw.sw_wave.affine_launches} affine of "
                             f"{wave_sw.sw_wave.launches} for {len(pieces)} pieces x {len(groups)} buckets")
    for name, res, single in zip(SUITE, many, singles):
        if not np.array_equal(res.scores, single.scores):
            raise AssertionError(f"affine search_many: {name} differs from its single search")
    many_dev = sum(r.metrics.device_seconds for r in many)
    say("affine.serving", queries=len(queries), single_device_seconds=single_dev, single_wall_seconds=single_wall,
        single_gcups_device=1e-9 * true_cells / single_dev, single_gcups_wall=1e-9 * true_cells / single_wall,
        many_launches=len(pieces) * len(groups), many_device_seconds=many_dev, many_wall_seconds=many_wall,
        many_gcups_device=1e-9 * true_cells / many_dev, many_gcups_wall=1e-9 * true_cells / many_wall,
        bit_equal_to_single=True)

    # --- device top-K and E-values through search_many, against the full array and its fit
    four = [SUITE.index(n) for n in ("P02232", "P05013", "P14942", "P01008")]
    topk_engine = SearchEngine(cfg.replace(top_k=10, evalue=True), device="cuda")
    fit = SearchEngine(cfg.replace(evalue=True), device="cuda")
    worst_rel, fallbacks = 0.0, 0
    for i, res in zip(four, topk_engine.search_many([queries[j] for j in four], db)):
        full = SearchResult(scores=singles[i].scores, metrics=singles[i].metrics)
        if res.top_k(10) != full.top_k(10):
            raise AssertionError(f"affine top-K of {SUITE[i]} differs from the full array's")
        fallbacks += res.scores is not None
        want = fit._attach_null(full, queries[i], db).top_k_stats(10)
        for g, w in zip(res.top_k_stats(10), want):
            rel = max(abs(g.evalue - w.evalue) / max(abs(w.evalue), 1e-300), abs(g.bits - w.bits) / max(abs(w.bits), 1e-300))
            worst_rel = max(worst_rel, rel)
            if (g.id, g.score) != (w.id, w.score) or rel > 1e-9:
                raise AssertionError(f"affine E-values of {SUITE[i]} are off the full-array fit: rel {rel}")
    say("affine.topk", queries=[SUITE[i] for i in four], k=10, hits_equal_full_array=True,
        max_rel_err_evalue_bits=worst_rel, tolerance=1e-9, tie_fallbacks=fallbacks)

    # --- streamed (not resident), against the resident scores
    t0 = time.perf_counter()
    streamed = SearchEngine(cfg.replace(device_resident=False), device="cuda").search(query, db)
    stream_wall = time.perf_counter() - t0
    if not np.array_equal(streamed.scores, first.scores):
        raise AssertionError("streamed affine search differs from the resident one")
    say("affine.streamed", query=MAIN_QUERY, wall_seconds=stream_wall, device_seconds=streamed.metrics.device_seconds,
        launches=streamed.metrics.kernel_launches, bit_equal_to_resident=True,
        max_memory_allocated=torch.cuda.max_memory_allocated(), seconds=round(time.perf_counter() - t_phase, 3))
    entry = {
        "name": "sw_wave (affine mode)", "route": "cuda", "source": "swtpu_torch/csrc/sw_wave.cu",
        "replaces": "swtpu/ops/wave_sw.py:815", "launches": launches, "max_abs_err": err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }
    return entry, engine


def rescore(aln, query, subject, matrix, gap_open, gap_extend):
    """An alignment's score from its printed strings alone: the matrix on
    aligned pairs, gap_open for a gap's first residue and gap_extend for
    each further one (linear gaps: both equal), written apart from the
    traceback.  Also checks that the strings are the sequences' residues at
    the reported positions."""
    from swtpu_torch.alphabet import decode, encode_str

    aq, asub = aln.aligned_query, aln.aligned_subject
    if len(aq) != len(asub) or any(a == b == "-" for a, b in zip(aq, asub)):
        raise AssertionError(f"subject {aln.subject_id}: malformed alignment strings")
    if aq.replace("-", "") != decode(query)[aln.query_start - 1 : aln.query_end] or \
            asub.replace("-", "") != decode(subject)[aln.subject_start - 1 : aln.subject_end]:
        raise AssertionError(f"subject {aln.subject_id}: alignment strings are not the sequences at their positions")
    score, in_q, in_s = 0, False, False
    for a, b in zip(aq, asub):
        if a == "-":  # gap in the query
            score -= gap_extend if in_q else gap_open
            in_q, in_s = True, False
        elif b == "-":  # gap in the subject
            score -= gap_extend if in_s else gap_open
            in_q, in_s = False, True
        else:
            score += int(matrix[encode_str(a)[0], encode_str(b)[0]])
            in_q = in_s = False
    return score


def phase_align(db, linear_engine, affine_engine):
    """Phase 8: align_top_k for P01008 on the resident database, linear and
    affine; every alignment re-scored from its strings equals its device score."""
    from swtpu_torch.io.fasta import parse_query
    from swtpu_torch.models.align import align_hits, align_top_k

    t_phase = time.perf_counter()
    query = parse_query(ROOT / "tests" / "data" / "queries" / f"{MAIN_QUERY}.fasta")
    out = {}
    for name, eng in (("linear", linear_engine), ("affine", affine_engine)):
        cfg = eng.config
        gaps = (cfg.gap_open, cfg.gap_extend) if cfg.gap_open is not None else (cfg.gap_penalty, cfg.gap_penalty)
        t0 = time.perf_counter()
        alns = align_top_k(query, db, k=10, config=cfg, engine=eng)
        total = time.perf_counter() - t0
        device = eng.search(query, db)
        hits = device.top_k(10)
        t0 = time.perf_counter()
        align_hits(query, db, hits, cfg)
        traceback_s = time.perf_counter() - t0
        if [(a.subject_id, a.score) for a in alns] != hits:
            raise AssertionError(f"{name}: alignments are not the device's top 10 hits")
        for aln in alns:
            got = rescore(aln, query.residues, db.sequence(aln.subject_id), eng.matrix, *gaps)
            if got != device.scores[aln.subject_id]:
                raise AssertionError(f"{name}: subject {aln.subject_id} re-scores to {got}, device says "
                                     f"{device.scores[aln.subject_id]}")
        out[name] = dict(gaps=gaps, alignments=len(alns), scores=[a.score for a in alns],
                         columns=[len(a.aligned_query) for a in alns], align_top_k_wall_s=total,
                         traceback_host_s=traceback_s, search_wall_s=device.metrics.wall_seconds)
    say("align", query=MAIN_QUERY, k=10, rescored_equal_device=True, **out, seconds=round(time.perf_counter() - t_phase, 3))


def phase_kernel_rows_lab():
    """K10: every instantiation of the row-parallel lab kernel (v2, v3, v4,
    v41 at their strips and ILPs) against its plain version (rows_lab_plain)
    on seeded random stacks, at gap 2 and at a gap past JAX's int8 fold;
    every launch's schedule is the kernel's own (rows_lab.card_schedule
    against rows_lab.wave_schedule)."""
    import numpy as np
    import torch

    from swtpu_torch.matrices import blosum50_ref
    from swtpu_torch.ops import rows_lab
    from swtpu_torch.ops.profile import PAD_SUBJECT, make_profile

    t0 = time.perf_counter()
    rng = np.random.default_rng(5)
    worst, launches, best, passes = 0, 0, 0, {}
    for qlen, C, B, L, pad in [(*case[:4], 32) for case in ROWS_LAB_CASES] + list(ROWS_LAB_EDGE_CASES):
        q = rng.integers(0, 25, qlen).astype(np.int8)
        if qlen > 4000:  # as kernel.rows: the planted self-alignment passes 32,767 at gap 2
            q = rng.choice(np.array([4, 8, 14, 17], dtype=np.int8), qlen)
        stack = np.full((C, B, L), PAD_SUBJECT, dtype=np.int8)
        for c in range(C):
            for b in range(B - (c == C - 1)):  # the last row of the last chunk stays empty
                n = int(rng.integers(1, L + 1))
                stack[c, b, :n] = rng.integers(0, 25, n)
        if qlen > 4000 and L >= qlen:
            stack[C // 2, 0, :qlen] = q
        prof = torch.from_numpy(make_profile(q, blosum50_ref(), pad_rows_to=pad)).cuda()
        stack = torch.from_numpy(stack).cuda()
        for v, strip, ilp in rows_lab.INSTANCES:
            want = rows_lab.wave_schedule(v, prof.shape[0], strip, ilp, B)
            card = rows_lab.card_schedule(v, prof.shape[0], strip, ilp, B, "cuda")
            if card[:5] != (want.g, want.passes, want.rows_per_block, want.blocks, want.stage_bytes):
                raise AssertionError(f"K10 {v} strip {strip} ilp {ilp}: the kernel's launch {card[:5]} is "
                                     f"not wave_schedule's {want} at qlen={qlen} B={B}")
            passes.setdefault(f"{v} strip {strip} ilp {ilp}", set()).add(want.passes)
        for gap in (2, ROWS_LAB_WIDE_GAP):
            want = rows_lab.rows_lab_plain(prof, stack, gap=gap)
            best = max(best, int(want.max()))
            for v, strip, ilp in rows_lab.INSTANCES:
                fn = rows_lab.WRAPPERS[v]
                before = fn.launches
                got = fn(prof, stack, gap=gap, strip=strip, **({"ilp": ilp} if v == "v4" else {}))
                torch.cuda.synchronize()
                if fn.launches != before + 1:
                    raise AssertionError(f"{v} launched {fn.launches - before} times, not once")
                err = int((got.long() - want.long()).abs().max())
                worst, launches = max(worst, err), launches + 1
                if err or not torch.equal(got, want):
                    raise AssertionError(f"K10 {v} strip {strip} ilp {ilp} != plain at qlen={qlen} C={C} B={B} "
                                         f"L={L} gap={gap}: max err {err}")
    if best <= 32767:
        raise AssertionError(f"the planted self-alignment scored {best}, within int16")
    if any(max(p) < 2 for p in passes.values()):
        raise AssertionError(f"some K10 instantiation crossed no pass boundary: {passes}")
    say("kernel.rows_lab", cases=len(ROWS_LAB_CASES) + len(ROWS_LAB_EDGE_CASES), gaps=[2, ROWS_LAB_WIDE_GAP],
        instances=[f"{v} strip {s} ilp {i}" for v, s, i in rows_lab.INSTANCES], launches=launches, max_score=best,
        wave_passes={k: sorted(v) for k, v in passes.items()}, wave_schedules_equal_card=True,
        max_abs_err=worst, tolerance="exact", seconds=round(time.perf_counter() - t0, 3))
    return worst


def row_bound(cells, nbytes):
    """(bound ms, bound_by) of row-kernel work: OPS_PER_CELL int32
    operations a padded cell over the int32 rate, against the bytes moved
    (subjects, profiles and scores once each) over the memory rate."""
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * OPS_PER_CELL * cells / int32_ops_per_s
    return max(bytes_ms, ops_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def phase_rows(db, wave_engine):
    """Phase 9: the row path against the wavefront scores of the same
    resident database, K2 and K3 alone against their plain versions."""
    import numpy as np
    import torch

    from swtpu_torch.config import SWConfig
    from swtpu_torch.io.fasta import parse_query
    from swtpu_torch.models.search import SearchEngine, SearchResult
    from swtpu_torch.ops import bucket_sw, row_sw
    from swtpu_torch.utils.bucketing import iter_packed

    t_phase = time.perf_counter()
    qdir = ROOT / "tests" / "data" / "queries"
    query = parse_query(qdir / f"{MAIN_QUERY}.fasta")
    want = wave_engine.search(query, db).scores
    true_cells = query.length * db.length_sum
    gap = wave_engine.config.gap_penalty

    def check(name, scores, ref=want):
        if not np.array_equal(scores, ref):
            raise AssertionError(f"rows {name}: {int((scores != ref).sum())} scores differ from the wavefront path's")

    def timed(engine, fn):
        """One search: its times, CUDA launches, PyTorch query-row steps
        (each ~9 operations over a whole stack) and rescored rows."""
        engine.rescored_rows = 0
        row_sw.reset_row_steps()
        t0 = time.perf_counter()
        res = fn()
        wall = time.perf_counter() - t0
        m = res.metrics
        return res, dict(device_seconds=m.device_seconds, wall_seconds=wall, gcups_device=1e-9 * true_cells / m.device_seconds,
                         gcups_wall=1e-9 * true_cells / wall, launches=m.kernel_launches, row_steps=row_sw.row_steps(),
                         rescored_rows=engine.rescored_rows, max_memory_allocated=torch.cuda.max_memory_allocated())

    # --- K2 resident: this phase's main path, counts zeroed just before, read just after
    torch.cuda.reset_peak_memory_stats()
    k2_engine = SearchEngine(SWConfig(use_wave=False), device="cuda")  # use_pallas auto: K2 on the card
    bucket_sw.sw_score_bucket_fused.launches = bucket_sw.sw_score_bucket.launches = 0
    t0 = time.perf_counter()
    first = k2_engine.search(query, db)  # packs the database on the card, then scores
    first_wall = time.perf_counter() - t0
    k2_launches, k3_stray = bucket_sw.sw_score_bucket_fused.launches, bucket_sw.sw_score_bucket.launches
    packed = k2_engine._resident_packed(db)
    profile = k2_engine._profile(query)
    expect = sum(-(-g.chunks // k2_engine._fused_step(profile, g.stack)) for g in packed.groups)
    if k2_launches != expect or k2_launches == 0 or k3_stray:
        raise AssertionError(f"K2 resident search launched K2 {k2_launches} times (K3 {k3_stray}) for "
                             f"{len(packed.groups)} ladder groups in {expect} launches")
    check("K2 resident", first.scores)
    runs = []
    for _ in range(2):
        res, row = timed(k2_engine, lambda: k2_engine.search(query, db))
        check("K2 resident (timed)", res.scores)
        runs.append(row)
    resident = sum(g.stack.numel() for g in packed.groups) + sum(
        g.stack.numel() + g.rebases.numel() * 2 + g.ends.numel() * 4 for g in packed.seg_groups)
    qpad = profile.shape[0]
    ladder_cells = sum(g.chunks * g.rows * g.width for g in packed.groups)
    seg_cells = sum(g.cells for g in packed.seg_groups)
    # K2 alone: the search's launches (the engine's chunk steps, worked out
    # once) back to back, so the events time the card and not the engine's
    # step budget, which reads the free device memory before every launch
    steps = [k2_engine._fused_step(profile, g.stack) for g in packed.groups]
    parts = [[g.stack[i : i + step] for i in range(0, g.chunks, step)] for g, step in zip(packed.groups, steps)]
    strip = k2_engine.config.query_strip
    k2_group = lambda ps: torch.cat([bucket_sw.sw_score_bucket_fused(profile, p, gap=gap, strip=strip)  # noqa: E731
                                     for p in ps])
    k2_all = lambda: [k2_group(ps) for ps in parts]  # noqa: E731
    events_ms(k2_all)  # warm
    k2_ms, k2_out = events_ms(k2_all, reps=3)
    k2_group_ms = [round(events_ms(lambda ps=ps: k2_group(ps), reps=5)[0], 4) for ps in parts]
    n_bands = -(-profile.shape[0] // bucket_sw.W)
    k2_shapes = [bucket_sw.rows_shape(n_bands, min(g.chunks, step) * g.rows) for g, step in zip(packed.groups, steps)]
    k2_plain_ms, k2_plain = events_ms(lambda: [row_sw.sw_score_stack(profile, g.stack, gap=gap, strip=32) for g in packed.groups])
    k2_err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(k2_out, k2_plain))
    if k2_err or not all(torch.equal(a, b) for a, b in zip(k2_out, k2_plain)):
        raise AssertionError(f"K2 at full scale differs from its plain version: max err {k2_err}")
    k2_bound, k2_by = row_bound(qpad * ladder_cells, sum(g.stack.numel() + qpad * 32 + 4 * g.chunks * g.rows for g in packed.groups))
    say("rows.k2", query=MAIN_QUERY, first_search_wall_s=first_wall, searches=runs, launches_first_search=k2_launches,
        ladder_groups=len(packed.groups), ladder_chunks=sum(g.chunks for g in packed.groups),
        seg_groups=len(packed.seg_groups), seg_chunks=sum(g.chunks for g in packed.seg_groups),
        ladder_cells=ladder_cells, seg_cells=seg_cells, padded_cells_k2=qpad * ladder_cells,
        padded_cells_seg16=qpad * seg_cells, resident_bytes=resident, k2_ms_per_search=k2_ms,
        k2_plain_ms_per_search=k2_plain_ms, bound_ms=k2_bound, bound_by=k2_by, bound_share=k2_bound / k2_ms,
        max_abs_err_vs_plain=k2_err, groups=dict(columns=["chunks", "rows", "width", "G", "H", "ms"],
        rows=[(g.chunks, g.rows, g.width, *gh, ms) for g, gh, ms in zip(packed.groups, k2_shapes, k2_group_ms)]))

    # --- the PyTorch scorers on the same pack (fast16 + seg16), and the int16
    # parity mode on its own pack, through K2 (auto) and the PyTorch scorers
    modes = {}
    fast = SearchEngine(SWConfig(use_wave=False, use_pallas=False), device="cuda")
    res, modes["fast16_seg16"] = timed(fast, lambda: fast.search_packed(query, db, packed))
    check("fast16 + seg16", res.scores)
    i16 = SearchEngine(SWConfig(score_dtype="int16"), device="cuda")
    t0 = time.perf_counter()
    i16_packed = i16._resident_packed(db)
    i16_pack_s = time.perf_counter() - t0
    res, modes["int16"] = timed(i16, lambda: i16.search(query, db))
    check("int16", res.scores)
    if modes["int16"]["launches"] == 0:
        raise AssertionError("int16 resident search launched no row kernel on the card")
    modes["int16"].update(pack_seconds=i16_pack_s, ladder_groups=len(i16_packed.groups),
                          resident_bytes=sum(g.stack.numel() for g in i16_packed.groups))
    i16_torch = SearchEngine(SWConfig(score_dtype="int16", use_pallas=False), device="cuda")
    res, modes["int16_pytorch"] = timed(i16_torch, lambda: i16_torch.search_packed(query, db, i16_packed))
    check("int16 (PyTorch scorers)", res.scores)

    # --- K3 streamed: counts zeroed just before, read just after
    streamed = SearchEngine(SWConfig(use_wave=False, device_resident=False), device="cuda")
    plan = streamed.plan(db)
    bucket_sw.sw_score_bucket_fused.launches = bucket_sw.sw_score_bucket.launches = 0
    res, modes["k3_streamed"] = timed(streamed, lambda: streamed.search(query, db))
    k3_launches = bucket_sw.sw_score_bucket.launches
    if k3_launches != len(plan.batches) or bucket_sw.sw_score_bucket_fused.launches:
        raise AssertionError(f"streamed search launched K3 {k3_launches} times for {len(plan.batches)} batches "
                             f"(K2 {bucket_sw.sw_score_bucket_fused.launches})")
    check("K3 streamed", res.scores)
    modes["k3_streamed"].update(batches=len(plan.batches), pack_seconds=res.metrics.phases["pack_and_put"])
    say("rows.modes", query=MAIN_QUERY, true_cells=true_cells, modes=modes, bit_equal_to_wavefront=True)

    # --- K3 alone against its plain version on the same batches, uploaded
    # first and launched back to back, so the events time the card and not
    # the wrapper's host time between launches
    batches = [(batch, torch.from_numpy(arr).cuda()) for batch, arr in iter_packed(db, plan)]
    k3_all = lambda: [bucket_sw.sw_score_bucket(profile, subj, gap=gap) for _, subj in batches]  # noqa: E731
    events_ms(k3_all)  # warm
    k3_ms, k3_out = events_ms(k3_all, reps=3)
    k3_plain_ms, k3_plain = events_ms(lambda: [row_sw.sw_score_bucket(profile, subj, gap=gap, strip=32)
                                               for _, subj in batches])
    k3_err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(k3_out, k3_plain))
    nbytes = sum(subj.numel() + profile.numel() + 4 * batch.rows for batch, subj in batches)
    del batches, k3_out, k3_plain
    if k3_err:
        raise AssertionError(f"K3 at full scale differs from its plain version: max err {k3_err}")
    k3_bound, k3_by = row_bound(profile.shape[0] * plan.total_cells, nbytes)
    k3_shapes = {}
    for batch in plan.batches:
        key = "G{}H{}".format(*bucket_sw.rows_shape(n_bands, batch.rows))
        k3_shapes[key] = k3_shapes.get(key, 0) + 1
    say("rows.k3", batches=len(plan.batches), shapes=len(plan.shapes), kernel_shapes=k3_shapes, cells=plan.total_cells,
        padded_cells=profile.shape[0] * plan.total_cells, k3_ms_per_search=k3_ms, k3_plain_ms_per_search=k3_plain_ms,
        bound_ms=k3_bound, bound_by=k3_by, bound_share=k3_bound / k3_ms, max_abs_err_vs_plain=k3_err)

    # --- serving on the K2 engine (search_many is search_queued on the row
    # path), against the wavefront scores of each query
    qs = [parse_query(qdir / f"{name}.fasta") for name in ROW_QUERIES]
    wave = [wave_engine.search(q, db).scores for q in qs]
    serving = {}
    for name, run in (("search_many", k2_engine.search_many), ("search_queued", k2_engine.search_queued)):
        t0 = time.perf_counter()
        results = run(qs, db)
        wall = time.perf_counter() - t0
        for qname, r, w in zip(ROW_QUERIES, results, wave):
            check(f"{name} {qname}", r.scores, w)
        dev = sum(r.metrics.device_seconds for r in results)
        cells = sum(q.length for q in qs) * db.length_sum
        serving[name] = dict(device_seconds=dev, wall_seconds=wall, gcups_device=1e-9 * cells / dev,
                             gcups_wall=1e-9 * cells / wall, launches=results[0].metrics.kernel_launches)
    say("rows.serving", queries=ROW_QUERIES, **serving, bit_equal_to_wavefront=True)

    # --- int16 top-K with E-values, against the full array's top-K
    topk = SearchEngine(SWConfig(score_dtype="int16", top_k=10, evalue=True), device="cuda")
    res = topk.search_packed(query, db, i16_packed)
    full = SearchResult(scores=want, metrics=res.metrics)
    if res.top_k(10) != full.top_k(10):
        raise AssertionError("int16 top-K hits differ from the full array's")
    stats = res.top_k_stats(10)
    say("rows.topk", query=MAIN_QUERY, k=10, hits_equal_full_array=True, evalues=[h.evalue for h in stats[:3]],
        bits=[h.bits for h in stats[:3]], max_memory_allocated=torch.cuda.max_memory_allocated(),
        seconds=round(time.perf_counter() - t_phase, 3))
    k2 = {
        "name": "sw_rows_fused (K2)", "route": "cuda", "source": "swtpu_torch/csrc/sw_rows.cu",
        "replaces": "swtpu/ops/pallas_sw.py:200", "launches": k2_launches, "max_abs_err": k2_err, "ms": k2_ms,
        "plain_ms": k2_plain_ms, "bound_ms": k2_bound, "bound_by": k2_by, "library_ms": None,
    }
    k3 = {
        "name": "sw_rows (K3)", "route": "cuda", "source": "swtpu_torch/csrc/sw_rows.cu",
        "replaces": "swtpu/ops/pallas_sw.py:281", "launches": k3_launches, "max_abs_err": k3_err, "ms": k3_ms,
        "plain_ms": k3_plain_ms, "bound_ms": k3_bound, "bound_by": k3_by, "library_ms": None,
    }
    return k2, k3, k2_engine


def phase_native_pack(db, wave_engine, row_engine):
    """native.pack: each native packer and the signatures against its plain
    version at SwissProt size, bit-equal, with the seconds of both: the
    streamed row plan's batches for P01008 (pack_batch), the row engine's
    resident segment groups (pack_segments), the streamed wave plan's
    buckets packed on the host (pack_wave_group) and the prefilter's
    signatures; the host's peak NumPy bytes of the row plan's pack."""
    import tracemalloc

    import numpy as np
    import torch

    from swtpu_torch.config import SWConfig
    from swtpu_torch.models.search import SearchEngine
    from swtpu_torch.ops import prefilter as pf
    from swtpu_torch.utils import bucketing, segpack

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return time.perf_counter() - t0, out

    def traced_peak(pack, batches):
        """Peak bytes NumPy allocates while ``pack`` packs the batches one
        after another, each dropped before the next (tracemalloc)."""
        tracemalloc.start()
        try:
            for b in batches:
                pack(db, b)
            return tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()

    def pair(name, native_fn, plain_fn, equal=np.array_equal):
        native_s, got = timed(native_fn)
        plain_s, want = timed(plain_fn)
        if not all(equal(a, b) for a, b in zip(got, want)) or len(got) != len(want):
            raise AssertionError(f"native.pack {name}: the native output differs from its plain version")
        return dict(native_seconds=native_s, plain_seconds=plain_s, speedup=plain_s / native_s, bit_equal=True)

    out = {}
    plan = SearchEngine(SWConfig(use_wave=False, device_resident=False), device="cuda").plan(db)
    out["pack_batch"] = pair("pack_batch", lambda: [bucketing.pack_batch(db, b) for b in plan.batches],
                             lambda: [bucketing.pack_batch_plain(db, b) for b in plan.batches])
    out["pack_batch"].update(batches=len(plan.batches), cells=plan.total_cells,
                             host_peak_bytes_native=traced_peak(bucketing.pack_batch, plan.batches),
                             host_peak_bytes_plain=traced_peak(bucketing.pack_batch_plain, plan.batches))
    seg = [b for g in row_engine._resident_packed(db).seg_groups for b in g.batches]
    out["pack_segments"] = pair("pack_segments", lambda: [segpack.pack_segments(db, b) for b in seg],
                                lambda: [segpack.pack_segments_plain(db, b) for b in seg])
    out["pack_segments"].update(batches=len(seg), cells=sum(b.rows * b.width for b in seg))
    wave_plan = bucketing.plan_wave_buckets(db, chain=wave_engine._wave_chain)
    cpu_residues = bucketing.upload_residues(db, "cpu")
    out["pack_wave_group"] = pair(
        "pack_wave_group",
        lambda: [bucketing.pack_wave_group(db, w, ids, bt, bpad, s).stack for w, ids, bt, bpad, s in wave_plan],
        lambda: [bucketing.gather_wave_stack(db, w, ids, bpad, s, cpu_residues) for w, ids, _, bpad, s in wave_plan],
        equal=torch.equal)
    out["pack_wave_group"].update(buckets=len(wave_plan), cells=sum((w + 32) * bpad for w, _, _, bpad, _ in wave_plan))
    out["signatures"] = pair("signatures", lambda: [pf.database_signatures(db)], lambda: [pf.database_signatures_plain(db)])
    out["signatures"].update(sequences=db.n, dim=pf.DIM, k=pf.K)
    say("native.pack", residues=db.length_sum, **out)


def phase_kernel_mma():
    """K7's two entry points against their plain versions: coarse_counts on
    seeded 0/1 signatures with a few +-5 entries, every (n, Q, dim) of
    MMA_NS x MMA_QS x MMA_DIMS, then mma_probe at small iteration counts."""
    import numpy as np
    import torch

    from swtpu_torch.ops import int8_mma

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    worst, cases = 0, 0
    for dim in MMA_DIMS:
        db = torch.randint(0, 2, (max(MMA_NS), dim), dtype=torch.int8, device="cuda", generator=gen)
        qs = torch.randint(0, 2, (max(MMA_QS), dim), dtype=torch.int8, device="cuda", generator=gen)
        db[5, :7], db[16, 3:9], qs[0, :4], qs[-1, 1:5] = 5, -5, -5, 5  # the sign, in rows of every case
        for n in MMA_NS:
            for n_q in MMA_QS:
                before = int8_mma.coarse_counts.launches
                got = int8_mma.coarse_counts(qs[:n_q], db[:n])
                want = int8_mma.coarse_counts_plain(qs[:n_q], db[:n])
                torch.cuda.synchronize()
                err = int((got.long() - want.long()).abs().max())
                worst, cases = max(worst, err), cases + 1
                if int8_mma.coarse_counts.launches != before + 1 or err or not torch.equal(got, want):
                    raise AssertionError(f"coarse_counts != plain at n={n} Q={n_q} dim={dim}: max err {err}")
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(-5, 5, (128, 384), dtype=np.int8)).cuda()
    b = torch.from_numpy(rng.integers(0, 2, (384, 512), dtype=np.int8)).cuda()
    probe_worst = 0
    for iters, unroll in ((1, 1), (2, 4), (3, 100)):
        got = int8_mma.mma_probe(a, b, iters, unroll)
        want = int8_mma.mma_probe_plain(a, b, iters, unroll)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        probe_worst = max(probe_worst, err)
        if err or not torch.equal(got, want):
            raise AssertionError(f"mma_probe != plain at iters={iters} unroll={unroll}: max err {err}")
    say("kernel.mma", coarse_counts_cases=cases, n=MMA_NS, queries=MMA_QS, dims=MMA_DIMS, signs="0/1 and +-5",
        probe_cases=[(1, 1), (2, 4), (3, 100)], max_abs_err=max(worst, probe_worst), tolerance="exact",
        seconds=round(time.perf_counter() - t0, 3))
    return worst, probe_worst


def phase_kernel_chain():
    """K8's chain against its plain version at small iteration counts, with
    y in [0, 3) (the rate probe's: acc + y always wins the max) and in
    [-3, 3) (where x wins it on some links)."""
    import numpy as np
    import torch

    from swtpu_torch.ops import vpu_chain

    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.integers(0, 1000, (32, 512), dtype=np.int32)).cuda()
    worst = 0
    for y_lo in (0, -3):
        y = torch.from_numpy(rng.integers(y_lo, 3, (32, 512), dtype=np.int32)).cuda()
        for iters in (0, 1, 5):
            got = vpu_chain.vpu_chain(x, y, iters)
            want = vpu_chain.vpu_chain_plain(x, y, iters)
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            worst = max(worst, err)
            if err or not torch.equal(got, want):
                raise AssertionError(f"vpu_chain != plain at iters={iters}, y >= {y_lo}: max err {err}")
    say("kernel.chain", iters=[0, 1, 5], y_ranges=[[0, 3], [-3, 3]], links_per_iter=vpu_chain.UNROLL,
        max_abs_err=worst, tolerance="exact")
    return worst


def phase_roofline(built):
    """K7's MAC rate and K8's chain rate at full occupancy (the port of
    tools/roofline.py; counts zeroed just before, read just after), each
    against its data-sheet or derived figure and its plain version on the
    same inputs; the SASS instructions of a chain link."""
    import numpy as np
    import torch

    from swtpu_torch.ops import int8_mma, vpu_chain
    from swtpu_torch.tools import roofline

    t0 = time.perf_counter()
    int8_mma.mma_probe.launches = vpu_chain.vpu_chain.launches = 0
    iters = 16384  # K8's chain a quarter as long as tools/roofline.py's: ~17 ms a launch, and its plain version ~1 s
    mxu, mxu_ms, macs = roofline.measure_mxu_staging()
    chain, chain_ms, ops = roofline.measure_vpu_chain(iters=iters)
    launched = {"mma_probe": int8_mma.mma_probe.launches, "vpu_chain": vpu_chain.vpu_chain.launches}
    if min(launched.values()) == 0:
        raise AssertionError(f"the rate probes launched {launched}")
    global int32_ops_per_s
    int32_ops_per_s = max(INT32_OPS_PER_S, chain)
    # The same inputs again: the kernels' results against their plain versions.
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.integers(-5, 5, (128, 384), dtype=np.int8)).cuda()
    b = torch.from_numpy(rng.integers(0, 2, (384, 512), dtype=np.int8)).cuda()
    probe = int8_mma.mma_probe(a, b, 512, 64)
    probe_plain_ms, probe_plain = events_ms(lambda: int8_mma.mma_probe_plain(a, b, 512, 64))
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.integers(0, 1000, (32, 512), dtype=np.int32)).cuda()
    y = torch.from_numpy(rng.integers(0, 3, (32, 512), dtype=np.int32)).cuda()
    tile = vpu_chain.vpu_chain(x, y, iters)
    for _ in range(60):  # ~1 s of queued chain launches: the SM clock under the chain's load
        vpu_chain.vpu_chain(x, y, iters)
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    chain_plain_ms, tile_plain = events_ms(lambda: vpu_chain.vpu_chain_plain(x, y, iters))
    probe_err = int((probe.long() - probe_plain.long()).abs().max())
    chain_err = int((tile.long() - tile_plain.long()).abs().max())
    if probe_err or chain_err:
        raise AssertionError(f"full-occupancy runs differ from their plain versions: probe {probe_err}, chain {chain_err}")
    links = vpu_chain.UNROLL * vpu_chain.ROWS  # links of the chain's loop body
    k8 = built["i16_probe"][K8_KERNEL]
    body = k8.get("loop_body_opcodes", {})
    per_link = {op: count / links for op, count in body.items()}
    chain_ops = ("VIADDMNMX", "IADD3", "VIMNMX", "IMNMX", "VIMNMX3")  # an add, a max, or both fused
    say("roofline", mma_probe=dict(shape=[[128, 384], [384, 512]], iters=512, unroll=64, ms=mxu_ms, macs=macs,
                                   mac_per_s=mxu, peak_mac_per_s=INT8_OPS_PER_S / 2, share_of_peak=2 * mxu / INT8_OPS_PER_S,
                                   plain_ms=probe_plain_ms, max_abs_err_vs_plain=probe_err),
        vpu_chain=dict(tile=[32, 512], iters=iters, links_per_iter=vpu_chain.UNROLL, ms=chain_ms, ops=ops, ops_per_s=chain,
                       peak_ops_per_s=INT32_OPS_PER_S, share_of_peak=chain / INT32_OPS_PER_S,
                       bound_ops_per_s=int32_ops_per_s, sm_clock_under_load_and_max=clocks,
                       plain_ms=chain_plain_ms, max_abs_err_vs_plain=chain_err),
        chain_link_sass=dict(links_in_loop_body=links, loop_body_opcodes=body, per_link=per_link,
                             add_max_instructions_per_link=sum(per_link.get(op, 0) for op in chain_ops),
                             fused=per_link.get("VIADDMNMX", 0) == 1 and body.get("VIMNMX", 0) == 0),
        launches=launched, seconds=round(time.perf_counter() - t0, 3))
    probe_entry = {
        "name": "mma_probe (K7 int8 mma)", "route": "cuda", "source": "swtpu_torch/csrc/int8_mma.cu",
        "replaces": "tools/roofline.py:65", "launches": launched["mma_probe"], "max_abs_err": probe_err,
        "ms": mxu_ms, "plain_ms": probe_plain_ms, "bound_ms": 1e3 * 2 * macs / INT8_OPS_PER_S,
        "bound_by": "operations", "library_ms": None,
    }
    chain_entry = {
        "name": "vpu_chain (K8)", "route": "cuda", "source": "swtpu_torch/csrc/i16_probe.cu",
        "replaces": "tools/roofline.py:101", "launches": launched["vpu_chain"], "max_abs_err": chain_err,
        "ms": chain_ms, "plain_ms": chain_plain_ms, "bound_ms": 1e3 * ops / int32_ops_per_s,
        "bound_by": "operations", "library_ms": None,
    }
    return probe_entry, chain_entry


def phase_kernel_lab():
    """The lab kernels (K4 at every height and block, K5 at every depth, K6
    at every skip) against their plain versions on KERNEL_CASES, and the
    variants that keep the DP against K1's kernel."""
    import numpy as np
    import torch

    from swtpu_torch.ops import wave_lab, wave_sw

    rng = np.random.default_rng(0)
    worst, launches, schedules = 0, 0, []
    for qlen, ws, n_segs, lanes, _ in KERNEL_CASES:
        prof, stack = random_bucket(rng, qlen, ws, n_segs, lanes)
        schedules.append({"qlen": qlen, "pairs": lanes * n_segs, "n_segs": n_segs, **{
            f"H{h}": wave_lab.band_schedule(-(-qlen // h), h, 128, lanes)._asdict() for h in wave_lab.HEIGHTS}})
        k1 = wave_sw.sw_wave(prof, stack, gap=2, n_segs=n_segs)
        runs = [(h, "none", wave_lab.pad_profile(prof, h),
                 lambda p, h=h, blk=blk: wave_lab.sw_wave_band(p, stack, gap=2, n_segs=n_segs, height=h, block=blk))
                for h in wave_lab.HEIGHTS for blk in wave_lab.BLOCKS]
        sweep = wave_lab.SWEEP_HEIGHT  # K5 and K6: K1's band sweep on K1's own profile, unpadded
        runs += [(sweep, "none", prof,
                  lambda p, d=d: wave_lab.sw_wave_prefetch(p, stack, gap=2, n_segs=n_segs, depth=d))
                 for d in wave_lab.DEPTHS]
        runs += [(sweep, skip, prof,
                  lambda p, skip=skip: wave_lab.sw_wave_skip(p, stack, gap=2, n_segs=n_segs, skip=skip))
                 for skip in wave_lab.SKIPS]
        plain = {}
        for h, skip, p, launch in runs:
            got = launch(p)
            key = (h, skip, p.shape[0])  # K4 at H64 takes the profile padded to 64, K5 and K6 K1's
            if key not in plain:
                plain[key] = wave_lab.sw_wave_lab_plain(p, stack, gap=2, n_segs=n_segs, height=h, skip=skip)
            want = plain[key]
            torch.cuda.synchronize()
            err = int((got.long() - want.long()).abs().max())
            worst, launches = max(worst, err), launches + 1
            if err or not torch.equal(got, want) or (skip == "none" and not torch.equal(got, k1)):
                raise AssertionError(f"lab kernel H{h} {skip} != plain or K1 at qlen={qlen} ws={ws} n_segs={n_segs} "
                                     f"lanes={lanes}: max err {err}")
    say("kernel.lab", cases=len(KERNEL_CASES), heights=wave_lab.HEIGHTS, blocks=wave_lab.BLOCKS,
        depths=wave_lab.DEPTHS, skips=wave_lab.SKIPS, sweep_height=wave_lab.SWEEP_HEIGHT,
        sweep_bands=[-(-c[0] // wave_lab.SWEEP_HEIGHT) for c in KERNEL_CASES], launches=launches, max_abs_err=worst,
        k4_schedules_at_block_128=schedules,
        tolerance="exact; every variant that keeps the DP also equals K1's kernel")
    return worst


def phase_kernel_i16():
    """K9's ten tiles (tools/probe_i16.py's inputs, then random ones whose
    sums wrap) and short chains of every op against their plain versions."""
    import numpy as np
    import torch

    from swtpu_torch.ops import i16_probe
    from swtpu_torch.tools import probe_i16

    rng = np.random.default_rng(9)
    worst, tiles, chains = 0, 0, 0

    def check(got, want, what):
        nonlocal worst
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        if err or not torch.equal(got, want):
            raise AssertionError(f"{what} != plain: max err {err}")

    for dtype in i16_probe.DTYPES:
        lo, hi = (-32768, 32768) if dtype == torch.int16 else (-(2**31), 2**31)
        wrap = tuple(torch.from_numpy(rng.integers(lo, hi, probe_i16.TILE)).to(dtype).cuda() for _ in range(2))
        for a, b in (probe_i16.tile_inputs(dtype, "cuda"), wrap):
            for op in i16_probe.OPS:
                check(i16_probe.i16_op(a, b, op), i16_probe.i16_op_plain(a, b, op), f"i16_op {op} {dtype}")
                tiles += 1
        x, _ = probe_i16.chain_inputs(dtype, "cuda")
        for y_lo, y_hi in ((-2, 1), (-3, 3000)):  # the rate's inputs, then sums that wrap in int16
            y = torch.from_numpy(rng.integers(y_lo, y_hi, tuple(x.shape))).to(dtype).cuda()
            for op in i16_probe.CHAIN_OPS:
                for iters in (0, 1, 5):
                    check(i16_probe.i16_chain(x, y, op, iters), i16_probe.i16_chain_plain(x, y, op, iters),
                          f"i16_chain {op} {dtype} iters={iters}")
                    chains += 1
    say("kernel.i16", tiles=tiles, ops=i16_probe.OPS, chains=chains, chain_ops=i16_probe.CHAIN_OPS, iters=[0, 1, 5],
        links_per_iter=i16_probe.UNROLL, dtypes=["int16 (packed pairs)", "int32"], max_abs_err=worst,
        tolerance="exact, int16 and int32 sums wrapping")
    return worst


def phase_i16_rates(built):
    """K9 as its tool runs it (swtpu_torch.tools.probe_i16; counts zeroed
    just before each part, read just after): the eight elementwise tiles,
    then the two dp_row tiles, against their plain versions and the library
    calls; then every chain's sustained rate at full occupancy beside the
    int32 peak, with its loop body's SASS a link, and its tile against the
    plain version on the same inputs.  Three kernels entries: the
    elementwise tiles, the dp_row tiles, the chains.  Then, after the
    counts are read, the host side of the elementwise tiles' time: the
    microseconds of each piece of K9's launch route and of the library call
    (their device time a call is phase_profile's profile.i16: a trace
    leaves the host slower after it, so no trace runs before the timed
    main-path phases)."""
    import torch

    from swtpu_torch.ops import i16_probe
    from swtpu_torch.tools import probe_i16

    t0 = time.perf_counter()
    parts, launched = {}, {}
    for part, ops in (("elementwise", tuple(op for op in i16_probe.OPS if op != "dp_row")), ("dp_row", ("dp_row",))):
        i16_probe.i16_op.launches = 0
        parts[part] = probe_i16.run_tiles(ops=ops)
        launched[part] = i16_probe.i16_op.launches
    i16_probe.i16_chain.launches = 0
    rates = probe_i16.measure_chains(iters=I16_CHAIN_ITERS)
    launched["chains"] = i16_probe.i16_chain.launches
    if min(launched.values()) == 0:
        raise AssertionError(f"the K9 tool launched {launched}")

    def peak(dtype):  # element operations a second: a packed int16 instruction does two lanes' work
        return int32_ops_per_s * (2 if dtype == "int16" else 1)

    library = probe_i16.LIBRARY
    rows, entries = [], []
    for part, tiles in parts.items():
        worst, nbytes, ops_ms, lib_ms = 0, 0, 0.0, []
        for t in tiles:
            err = int((t["out"].long() - t["plain"].long()).abs().max())
            worst = max(worst, err)
            if err or not torch.equal(t["out"], t["plain"]):
                raise AssertionError(f"K9 tile {t['op']} {t['dtype']} != plain: max err {err}")
            a, b = probe_i16.tile_inputs(getattr(torch, t["dtype"]), "cuda")
            ms = None
            if t["op"] in library:  # the one PyTorch call of the same function, timed as the kernel is
                lib = library[t["op"]]
                if not torch.equal(lib(a, b), t["out"]):
                    raise AssertionError(f"the library's {t['op']} {t['dtype']} differs from K9's tile")
                ms = events_ms(lambda: lib(a, b), 100)[0]
                lib_ms.append(ms)
            nbytes += 3 * a.numel() * a.element_size()
            ops_ms += 1e3 * i16_probe.OPS_PER_ELEMENT[t["op"]] * a.numel() / peak(t["dtype"])
            rows.append([t["op"], t["dtype"], t["ms"], t["plain_ms"], ms])
        bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
        entries.append({
            "name": {"elementwise": "i16_op (K9 max/add/sub/select tiles, int16 and int32)",
                     "dp_row": "i16_op (K9 dp_row tiles, int16 and int32)"}[part],
            "route": "cuda", "source": "swtpu_torch/csrc/i16_probe.cu", "replaces": "tools/probe_i16.py:32",
            "launches": launched[part], "max_abs_err": worst, "ms": sum(t["ms"] for t in tiles),
            "plain_ms": sum(t["plain_ms"] for t in tiles), "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": sum(lib_ms) if len(lib_ms) == len(tiles) else None,
        })
    links = i16_probe.UNROLL * i16_probe.ROWS  # links of a chain's loop body
    worst, chain_bound_ms = 0, 0.0
    for r in rates:
        x, y, out = r.pop("x"), r.pop("y"), r.pop("out")
        r["plain_ms"], plain = events_ms(lambda: i16_probe.i16_chain_plain(x, y, r["op"], r["iters"]))
        err = int((out.long() - plain.long()).abs().max())
        worst = max(worst, err)
        if err or not torch.equal(out, plain):
            raise AssertionError(f"K9 chain {r['op']} {r['dtype']} != plain at iters={r['iters']}: max err {err}")
        chain_bound_ms += 1e3 * r["ops"] / peak(r["dtype"])
        typ = "I16x2" if r["dtype"] == "int16" else "I32"
        body = built["i16_probe"].get(f"K9 i16_chain_kernel {typ} {r['op']}", {}).get("loop_body_opcodes", {})
        r["loop_body_per_link"] = {op: n / links for op, n in body.items() if op not in ("UIADD3", "ISETP")}
    host_us = probe_i16.route_split()
    say("roofline.i16", tile_columns=["op", "dtype", "ms", "plain_ms", "library_ms"], tiles=rows,
        host_us_a_call_by_piece=host_us,
        host_split_of="i16_op max int16 (16, 512): every piece 2,000 calls a turn, three turns",
        chains=rates, chain_max_abs_err_vs_plain=worst, int32_peak_ops_per_s=INT32_OPS_PER_S,
        bound_ops_per_s={"int32": peak("int32"), "int16 (packed pairs)": peak("int16")}, launches=launched,
        launches_cover={"tiles": "100 timed calls a tile; ms is their mean a call",
                        "chains": "a warm launch and 3 timed ones a chain; ms is a timed launch's mean"},
        seconds=round(time.perf_counter() - t0, 3))
    entries.append({
        "name": "i16_chain (K9 rate chains, int16x2 and int32)", "route": "cuda",
        "source": "swtpu_torch/csrc/i16_probe.cu", "replaces": "tools/probe_i16.py:32", "launches": launched["chains"],
        "max_abs_err": worst, "ms": sum(r["ms"] for r in rates), "plain_ms": sum(r["plain_ms"] for r in rates),
        "bound_ms": chain_bound_ms, "bound_by": "operations", "library_ms": None,
    })
    return entries


def phase_lab(db, engine):
    """The lab kernels as their tools run them (swtpu_torch.tools.wave_lab's
    K4 and K5 variants and swtpu_torch.tools.probe_breakdown's K6 variants,
    in one swtpu_torch.tools.buckets.run; counts zeroed just before, read
    just after) on P01008's buckets of the resident database: ROUNDS rounds
    of one timed launch a variant a bucket, a bucket's time the median of
    its rounds; in every round the variants that keep the DP bit-equal to
    K1's full-array scores and every variant equal to its plain version (run
    once a variant on the same buckets); a per-bucket table of milliseconds
    beside K1's (its own schedule a bucket) and K1 forced to its warp
    wavefront and to its band sweep on every bucket, with narrow, mid and
    full sums and each variant's spread across rounds; each K4 variant's
    schedule for P01008 and its blocks an SM; each K5 and K6 variant's shape
    and its ratio to K1's band sweep (whose sweep K5 D1 and K6 none copy)."""
    import numpy as np
    import torch

    from swtpu_torch.ops import wave_lab
    from swtpu_torch.tools import buckets as lb
    from swtpu_torch.tools import probe_breakdown
    from swtpu_torch.tools import wave_lab as wave_lab_tool

    t0 = time.perf_counter()
    b = lb.swissprot_buckets(db=db, engine=engine)
    scale_scores = engine.search(b.query, db).scores  # K1 through the engine: the scores every variant is held to
    variants = {**wave_lab_tool.VARIANTS, **probe_breakdown.VARIANTS}
    families = {  # wrapper: (kernels entry name, the TPU kernel it replaces)
        wave_lab.sw_wave_band: ("sw_wave_band (K4 band height x block)", "tools/pallas_wave.py:208"),
        wave_lab.sw_wave_prefetch: ("sw_wave_prefetch (K5 prefetch depth)", "tools/pallas_wave2.py:201"),
        wave_lab.sw_wave_skip: ("sw_wave_skip (K6 stage switches)", "tools/probe_breakdown.py:199"),
    }
    for fn in families:
        fn.launches = 0
    k1_forced = wave_lab_tool.k1_schedules(b.query.length)
    res = lb.run(b.groups, lb.launches(b, {**k1_forced, **variants}))
    launched = {fn.__name__: fn.launches for fn in families}
    rounds = len(res["rounds"])
    want = {fn.__name__: rounds * len(b.groups) * sum(f is fn for f, _ in variants.values()) for fn in families}
    if launched != want:
        raise AssertionError(f"the lab tools launched {launched}, not one launch a variant a bucket a round: {want}")
    for r, flats in enumerate(res["rounds"]):
        for name in ("K1", *k1_forced):
            if not np.array_equal(b.reduce(flats[name]), scale_scores):
                raise AssertionError(f"the lab run's {name} pass differs from the engine's search in round {r}")
    plain_ms, err = {}, {}
    for name, (fn, kw) in variants.items():
        h, skip = lb.height(kw), lb.skip(kw)
        err[name] = 0
        if skip == "none":  # every round against K1's flats of the same round, which equal the engine's scores
            for r, flats in enumerate(res["rounds"]):
                got, k1 = torch.cat(flats[name]), torch.cat(flats["K1"])
                e = int((got.long() - k1.long()).abs().max())
                err[name] = max(err[name], e)
                if e or not got.equal(k1):
                    raise AssertionError(f"lab {name} differs from K1 on P01008 in round {r}: max err {e}")
        prof = b.profile(lb.pad(kw))
        plain_ms[name], plain = events_ms(lambda: [wave_lab.sw_wave_lab_plain(
            prof, g.stack, gap=b.gap, n_segs=g.n_segs, height=h, skip=skip) for g in b.groups])
        e = max(int((x.long() - p.long()).abs().max()) for flats in res["rounds"] for x, p in zip(flats[name], plain))
        if e:
            raise AssertionError(f"lab {name} differs from its plain version on P01008: max err {e}")
    print("\n".join(lb.table(b.groups, res["times"], "K1", res["spread_ms"])), flush=True)
    sums = lb.group_sums(b.groups, res["times"])

    def bound(kw):  # the larger of bytes (subjects, profile, scores once) and int32 operations
        h, skip = lb.height(kw), lb.skip(kw)
        qpad = b.profile(lb.pad(kw)).shape[0]  # the rows the variant takes: K1's 480 for K5 and K6
        cells = sum(qpad * g.n_segs * g.seg_cols * g.lanes for g in b.groups)
        nbytes = sum((0 if skip == "subject" else g.stack.numel()) + qpad * 32 + 4 * g.rows for g in b.groups)
        ops = cells * ((h + 2) / h if skip == "dp" else OPS_PER_CELL)  # dp: H max, an add and the best a column
        return 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / int32_ops_per_s

    sweep = [name for name, (fn, _) in variants.items() if fn in (wave_lab.sw_wave_prefetch, wave_lab.sw_wave_skip)]
    say("lab", query=MAIN_QUERY, buckets=len(b.groups), rounds=rounds, launches=launched,
        launches_cover=f"{rounds} rounds of one timed launch a variant a bucket (an untimed K1 launch warms each "
                       "bucket in each round); a bucket's ms is the median of its rounds",
        k4_schedules=wave_lab_tool.k4_schedules(b.query.length),
        sweep_shapes=wave_lab_tool.sweep_shapes(variants),
        group_rule={"narrow": f"threads < {lb.NARROW_THREADS}", "full": f"threads >= {lb.FULL_THREADS}"},
        groups={grp: sum(lb.group_of(g) == grp for g in b.groups) for grp in lb.GROUPS},
        keep_dp_bit_equal_k1_every_round=[n for n, (_, kw) in variants.items() if lb.skip(kw) == "none"],
        scores=int(scale_scores.shape[0]), all_equal_plain_every_round=True, ms_by_group=sums,
        ratio_to_k1_band_sweep={n: {grp: sums[n][grp] / sums["K1 band sweep"][grp] for grp in (*lb.GROUPS, "all")
                                    if sums["K1 band sweep"][grp]} for n in sweep},
        round_ms=res["round_ms"], spread_ms=res["spread_ms"], plain_ms=plain_ms,
        bound_ms={name: max(bound(kw)) for name, (_, kw) in variants.items()},
        seconds=round(time.perf_counter() - t0, 3))
    entries = []
    for fn, (title, src) in families.items():
        mine = [(name, kw) for name, (f, kw) in variants.items() if f is fn]
        bounds = [bound(kw) for _, kw in mine]
        bytes_ms, ops_ms = sum(x for x, _ in bounds), sum(y for _, y in bounds)
        entries.append({
            "name": title, "route": "cuda", "source": "swtpu_torch/csrc/sw_wave_lab.cu", "replaces": src,
            "launches": launched[fn.__name__], "max_abs_err": max(err[n] for n, _ in mine),
            "ms": sum(sums[n]["all"] for n, _ in mine), "plain_ms": sum(plain_ms[n] for n, _ in mine),
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
        })
    return entries


def phase_lab_rows(db, engine, row_engine):
    """K10 as swtpu_torch.tools.pallas_lab --swissprot runs it (counts zeroed
    just before, read just after) on P01008's row-path ladder groups of the
    resident database: ROUNDS rounds of one timed launch of every
    instantiation a group beside K2's (an untimed K2 launch warms each group
    in each round), a group's time the median of its rounds; in every round
    every instantiation bit-equal to K2 on every group and K2, with the
    segment groups' scores, through the engine's _reduce_flat to the
    wavefront path's scores of all 559,228 sequences; one pass of the plain
    version on the same groups; a per-group table of milliseconds with each
    instantiation's ratio to K2 and its spread across rounds; the SMs each
    group's blocks fill, K2's beside each instantiation's; on the largest
    group each instantiation at width 1 (the same blocks and stage, a
    column a row) against its full width: the share of the launch that its
    staging and the launch itself take."""
    import numpy as np
    import torch

    from swtpu_torch.ops import bucket_sw, rows_lab
    from swtpu_torch.tools import buckets as lb
    from swtpu_torch.tools import pallas_lab

    t0 = time.perf_counter()
    rg = lb.swissprot_rows(db=db, engine=row_engine)
    wave_scores = engine.search(rg.query, db).scores  # K1 through the engine
    for fn in rows_lab.WRAPPERS.values():
        fn.launches = 0
    res = pallas_lab.swissprot(rg)
    launched = {v: fn.launches for v, fn in rows_lab.WRAPPERS.items()}
    rounds = len(res["rounds"])
    want = {v: rounds * len(rg.groups) * sum(vv == v for vv, _, _ in rows_lab.INSTANCES) for v in rows_lab.WRAPPERS}
    if launched != want:
        raise AssertionError(f"pallas_lab --swissprot launched {launched}, not once an instantiation a group "
                             f"a round: {want}")
    if res["unequal"]:
        raise AssertionError(f"K10 {res['unequal']} differ from K2 on P01008's row-path groups in some round")
    for r, flats in enumerate(res["rounds"]):  # every instantiation equals K2 in the round: K2 carries the check
        full = rg.reduce(flats["K2"])
        if not np.array_equal(full, wave_scores):
            raise AssertionError(f"lab.rows K2, round {r}: {int((full != wave_scores).sum())} scores differ "
                                 "from the wavefront's")
    prof = rg.profile()
    plain_ms, plain = events_ms(lambda: [rows_lab.rows_lab_plain(prof, g.stack, gap=rg.gap) for g in rg.groups])
    err = {name: max(int((x.long() - p.long()).abs().max()) for flats in res["rounds"]
                     for x, p in zip(flats[name], plain))
           for name in pallas_lab.VARIANTS}
    if any(err.values()):
        raise AssertionError(f"K10 differs from its plain version on P01008: {err}")
    print("\n".join(lb.row_table(rg.groups, res["times"], "K2", res["spread_ms"])), flush=True)
    qpad = prof.shape[0]
    cells = qpad * sum(g.chunks * g.rows * g.width for g in rg.groups)
    bound_ms, bound_by = row_bound(cells, sum(g.stack.numel() + qpad * 32 + 4 * g.chunks * g.rows for g in rg.groups))
    sums = {name: sum(ms) for name, ms in res["times"].items()}
    carry = {name: sum(rows_lab.carry_bytes(next(v for v, f in rows_lab.WRAPPERS.items() if f is fn), qpad,
                                            kw["strip"], g.chunks, g.rows, g.width, ilp=kw.get("ilp", 1))
                       for g in rg.groups)
             for name, (fn, kw) in pallas_lab.VARIANTS.items()}
    shapes = [(g.chunks, g.rows, g.width) for g in rg.groups]
    sms = torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count
    sched = pallas_lab.schedules(qpad, shapes, sms)
    print("\n".join(pallas_lab.schedule_lines(sched, shapes)), flush=True)
    k2 = res["times"]["K2"]
    k2_sms = []
    for c, rows, _ in shapes:  # K2's grid: (blocks, C), 128 / G rows a wavefront block, 64 rows a sweep block
        g_k2, _ = bucket_sw.rows_shape(qpad // bucket_sw.W, c * rows)
        k2_sms.append(min(sms, c * -(-rows // (128 // g_k2 if g_k2 > 1 else 64))))
    group_sms = {"K2": k2_sms, **{n: [x["sms"] for x in sched[n]["launches"]] for n in sched}}
    print("SMs a group fills: " + "; ".join(f"{n} {v}" for n, v in group_sms.items()), flush=True)
    big_k = max(range(len(rg.groups)), key=lambda k: rg.groups[k].stack.numel())
    big = rg.groups[big_k]
    narrow = big.stack[..., :1].contiguous()
    want1 = rows_lab.rows_lab_plain(prof, narrow, gap=rg.gap)
    width1 = {}
    for name, (fn, kw) in pallas_lab.VARIANTS.items():
        if not torch.equal(fn(prof, narrow, gap=rg.gap, **kw), want1):  # the warm launch, checked
            raise AssertionError(f"K10 {name} differs from its plain version on the largest group at width 1")
        width1[name], _ = events_ms(lambda fn=fn, kw=kw: fn(prof, narrow, gap=rg.gap, **kw), 3)
    staging = {n: width1[n] / res["times"][n][big_k] for n in width1}
    print(f"largest group {big.chunks}x{big.rows}x{big.width}: width-1 ms / full-width ms "
          + "; ".join(f"{n} {width1[n]:.4f} / {res['times'][n][big_k]:.4f} = {staging[n]:.3f}" for n in width1),
          flush=True)
    say("lab.rows", query=MAIN_QUERY, groups=len(rg.groups), rounds=rounds, launches=launched,
        launches_cover=f"{rounds} rounds of one timed launch an instantiation a group (an untimed K2 launch warms "
                       "each group in each round); a group's ms is the median of its rounds",
        shapes=[(g.chunks, g.rows, g.width) for g in rg.groups], padded_cells=cells,
        k2_group_ms=res["times"]["K2"], group_ms={n: res["times"][n] for n in pallas_lab.VARIANTS},
        ms=sums, ratio_to_k2={n: sums[n] / sums["K2"] for n in pallas_lab.VARIANTS},
        round_ms=res["round_ms"], spread_ms=res["spread_ms"], bit_equal_k2_every_round=True,
        scores_equal_wavefront=int(wave_scores.shape[0]), plain_ms_one_pass=plain_ms,
        bound_ms_a_pass=bound_ms, bound_by=bound_by, carry_bytes=carry,
        wave_ratio_to_k2_by_group={n: [t / b for t, b in zip(res["times"][n], k2)] for n in sched},
        wave_launches={n: x["launches"] for n, x in sched.items()}, sms=sms, group_sms=group_sms,
        largest_group=[big.chunks, big.rows, big.width], width1_ms_largest_group=width1,
        staging_share_largest_group=staging, seconds=round(time.perf_counter() - t0, 3))
    entries = []
    for v, line in zip(rows_lab.VARIANTS, (102, 206, 304, 389)):
        mine = [name for name, (fn, _) in pallas_lab.VARIANTS.items() if fn is rows_lab.WRAPPERS[v]]
        entries.append({
            "name": f"{rows_lab.WRAPPERS[v].__name__} (K10 {v})", "route": "cuda",
            "source": "swtpu_torch/csrc/sw_rows_lab.cu", "replaces": f"tools/pallas_lab.py:{line}",
            "launches": launched[v], "max_abs_err": max(err[n] for n in mine), "ms": sum(sums[n] for n in mine),
            "plain_ms": plain_ms, "bound_ms": bound_ms * len(mine), "bound_by": bound_by, "library_ms": None,
        })
    return entries


def null_equal(a, b):
    """Two NullStats hold the same numbers, field by field."""
    import dataclasses

    import numpy as np

    return all(np.array_equal(np.asarray(getattr(a, f.name)), np.asarray(getattr(b, f.name)))
               for f in dataclasses.fields(a))


def phase_prefilter(db, engine):
    """The k-mer prefilter on the resident database: signatures, P01008's
    two-phase search (counts zeroed just before, read just after; its first
    search builds the index on the card), its exactness against the
    exhaustive scores, the signature kernel alone on the resident residues
    and offsets against the native host pass (byte for byte, popcounts
    too) and its byte bound, the coarse kernel alone against its bound,
    plain version and torch._int_mm, search_many for the suite, E-values,
    and the planted-homolog recall of swtpu's battery, and the long route's
    kernel alone, linear and affine, on P01008's candidates past 992
    residues and affine on Q9UKN1 against itself (two passes), against its
    plain version and its bound.  Returns the kernel table's entries of the
    coarse kernel, the signature kernel and the long route's two gap
    models."""
    import numpy as np
    import torch

    from swtpu_torch import stats as st
    from swtpu_torch import synth
    from swtpu_torch.config import SWConfig
    from swtpu_torch.io.fasta import parse_query
    from swtpu_torch.models.search import SearchEngine, SearchResult
    from swtpu_torch.ops import int8_mma, long_sw, wave_sw
    from swtpu_torch.ops import prefilter as pf
    from swtpu_torch.utils.metrics import PhaseTimer

    t_phase = time.perf_counter()
    qdir = ROOT / "tests" / "data" / "queries"
    queries = [parse_query(qdir / f"{name}.fasta") for name in SUITE]
    query = queries[SUITE.index(MAIN_QUERY)]
    exhaustive = engine.search(query, db).scores  # the resident exhaustive search of phase_scale's engine
    cfg = SWConfig(**PREFILTER)
    eng = SearchEngine(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    # --- this phase's path: counts zeroed just before, read just after
    int8_mma.coarse_counts.launches = wave_sw.sw_wave.launches = pf.database_signatures_cuda.launches = 0
    long_sw.sw_long.launches = 0
    t0 = time.perf_counter()
    first = eng.search(query, db)  # builds the signatures on the card, then searches
    first_wall = time.perf_counter() - t0
    launched = {"signatures": pf.database_signatures_cuda.launches, "coarse_counts": int8_mma.coarse_counts.launches,
                "sw_wave": wave_sw.sw_wave.launches, "sw_long": long_sw.sw_long.launches}
    sig, pop, flat, offsets = eng._prefilter_signatures(db)
    n_cand = eng._n_cand(db.n)
    qsig = torch.from_numpy(pf.signature(query.residues)).cuda()
    packed = pf.candidates_from_counts(int8_mma.coarse_counts(qsig[None], sig), pop, qsig[None], n_cand)[0].cpu().numpy()
    cand = pf.merge_candidates(packed[0], packed[1], n_cand)
    _, jobs, _, _ = eng._prefilter_exact_enqueue(query, db, cand, PhaseTimer())
    # one signature build, one coarse pass, the short candidates' K1 launch and
    # its rescore, and the long candidates' one launch
    routes = [route for _, _, route in jobs]
    want = {"signatures": 1, "coarse_counts": 1, "sw_wave": routes.count("wave"), "sw_long": routes.count("long")}
    if (launched != want or first.metrics.kernel_launches != 1 + 1 + 2 * want["sw_wave"] + want["sw_long"]
            or first.metrics.long_candidates != eng._long_candidates(jobs)):
        raise AssertionError(f"prefiltered search launched {launched} (kernel_launches {first.metrics.kernel_launches}, "
                             f"long_candidates {first.metrics.long_candidates}) for exact routes {routes}")
    say("prefilter.signatures", sequences=db.n, dim=pf.DIM, k=pf.K, signature_bytes_on_card=sig.numel(),
        signatures_and_upload_host_s=first.metrics.phases["prefilter_signatures"], first_search_wall_s=first_wall)

    # --- the signature kernel alone on the resident residues and offsets: byte
    # for byte the native host pass (held to its plain version in native.pack),
    # against its byte bound
    t_host = time.perf_counter()
    host_sig = pf.database_signatures(db)
    host_s = time.perf_counter() - t_host
    pf.database_signatures_cuda.launches = 0
    card_sig, card_pop = pf.database_signatures_cuda(flat, offsets)
    sig_launches = pf.database_signatures_cuda.launches
    sig_equal = torch.equal(card_sig, torch.from_numpy(host_sig).cuda()) and torch.equal(sig, card_sig)
    pop_equal = torch.equal(card_pop.cpu(), torch.from_numpy(host_sig.sum(axis=1, dtype=np.int32)))
    if sig_launches != 1 or not sig_equal or not pop_equal:
        raise AssertionError(f"signature kernel: {sig_launches} launches, signatures equal {sig_equal}, "
                             f"popcounts equal {pop_equal} to the native host pass")
    del card_sig, card_pop, host_sig
    sig_ms, _ = events_ms(lambda: pf.database_signatures_cuda(flat, offsets), reps=5)
    sig_bytes = flat.numel() + 8 * offsets.numel() + db.n * pf.DIM + 4 * db.n  # residues, offsets read; index written
    sig_bound_ms = 1e3 * sig_bytes / HBM_BYTES_PER_S
    say("prefilter.signature_kernel", sequences=db.n, residues=flat.numel(), launches=sig_launches,
        equal_native=True, ms=sig_ms, bound_ms=sig_bound_ms, bound_share=sig_bound_ms / sig_ms, bytes=sig_bytes,
        native_host_ms=1e3 * host_s)

    # --- exactness: hits are the exhaustive top-10 of the candidate set, the
    # candidate set is the plain coarse pass's
    counts_plain = int8_mma.coarse_counts_plain(qsig[None], sig)
    counts = int8_mma.coarse_counts(qsig[None], sig)
    counts_err = int((counts.long() - counts_plain.long()).abs().max())
    plain_packed = pf.candidates_from_counts(counts_plain, pop, qsig[None], n_cand)[0].cpu().numpy()
    if counts_err or not np.array_equal(pf.merge_candidates(plain_packed[0], plain_packed[1], n_cand), cand):
        raise AssertionError(f"the coarse pass differs from its plain version: counts max err {counts_err}")
    order = np.lexsort((cand, -exhaustive[cand]))[: cfg.top_k]
    want = [(int(cand[i]), int(exhaustive[cand[i]])) for i in order]
    if first.hits != want or any(s != exhaustive[i] for i, s in first.hits):
        raise AssertionError(f"prefiltered hits {first.hits} are not the candidates' exhaustive top-10 {want}")
    full_top = [i for i, _ in SearchResult(scores=exhaustive, metrics=None).top_k(cfg.top_k)]
    runs = []
    for _ in range(3):
        res = eng.search(query, db)
        if res.hits != first.hits:
            raise AssertionError("a timed prefiltered search differs from the first")
        runs.append(res.metrics)
    exact_ms, _ = events_ms(lambda: eng._prefilter_exact_enqueue(query, db, cand, PhaseTimer())[0], reps=3)

    # --- the long route alone (the candidates past 992 residues), under both
    # gap models: one launch, equal to its plain version, against its bound
    # (true cells at the int32 rate); the linear scores are also the
    # exhaustive search's, and Q9UKN1 scored against itself (5,478 rows, past
    # one 4,096-row pass, a score past 32,767) carries (H, F) between passes
    table_t = eng._long_table()

    def long_route(label, q_res, flat_, offsets_, ids, gaps, ops_per_cell, want=None):
        ids_t = torch.from_numpy(ids).cuda()
        q_t = torch.from_numpy(np.ascontiguousarray(q_res, dtype=np.int8)).cuda()
        lens = (offsets_[ids_t + 1] - offsets_[ids_t]).cpu().numpy()
        long_sw.sw_long.launches = 0
        got = long_sw.sw_long(q_t, flat_, offsets_, ids_t, table_t, **gaps)
        launches = long_sw.sw_long.launches
        t_plain = time.perf_counter()
        plain = long_sw.sw_long_plain(q_t, flat_, offsets_, ids_t, table_t, **gaps)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t_plain)
        err = int((got.long() - plain.long()).abs().max()) if ids.size else 0
        if launches != int(ids.size > 0) or err or (want is not None and not np.array_equal(got.cpu().numpy(), want)):
            raise AssertionError(f"{label}: {launches} launches, max err {err} against its plain version, "
                                 "or scores other than the exhaustive search's")
        ms, _ = events_ms(lambda: long_sw.sw_long(q_t, flat_, offsets_, ids_t, table_t, **gaps), reps=5)
        cells = int(lens.sum()) * len(q_res)
        bound_ms = 1e3 * ops_per_cell * cells / int32_ops_per_s
        say(label, gaps=gaps, candidates=int(ids.size), longest=int(lens.max(initial=0)), query_length=len(q_res),
            launches=launches, equal_plain=True, equal_exhaustive=want is not None,
            best=int(got.max()) if ids.size else 0, ms=ms, bound_ms=bound_ms,
            bound_share=bound_ms / ms if ms else None, bound_by="operations", true_cells=cells, plain_ms=plain_ms)
        return {"launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms}

    long_ids = np.concatenate([part for part, _, route in jobs if route == "long"] + [np.zeros(0, np.int64)])
    long_lin = long_route("prefilter.long_route", query.residues, flat, offsets, long_ids, eng._gaps, OPS_PER_CELL,
                          want=exhaustive[long_ids])
    long_aff = long_route("prefilter.long_route_affine", query.residues, flat, offsets, long_ids, AFFINE,
                          OPS_PER_CELL_AFFINE)
    q9 = parse_query(qdir / "Q9UKN1.fasta").residues
    q9_flat = torch.from_numpy(np.ascontiguousarray(q9, dtype=np.int8)).cuda()
    q9_offsets = torch.tensor([0, q9.shape[0]], dtype=torch.int64, device="cuda")
    long_q9 = long_route("prefilter.long_route_affine_two_passes", q9, q9_flat, q9_offsets, np.zeros(1, np.int64),
                         AFFINE, OPS_PER_CELL_AFFINE)

    # --- the coarse kernel alone (Q = 1 and the suite's Q = 17) against its
    # bound, its plain version and torch._int_mm on the same product
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    sig_random = (torch.rand(sig.shape, device="cuda", generator=gen) < 0.1).to(torch.int8)

    def coarse_times(qs):
        ms, _ = events_ms(lambda: int8_mma.coarse_counts(qs, sig), reps=10)
        # the same shape of seeded 0/1 signatures at 10% density (wave_ab.py's): what the data costs
        random_ms, _ = events_ms(lambda: int8_mma.coarse_counts(qs, sig_random), reps=10)
        plain_ms, _ = events_ms(lambda: int8_mma.coarse_counts_plain(qs, sig))
        n_q, (n, dim) = qs.shape[0], sig.shape
        nbytes = n * dim + n_q * dim + 4 * n_q * n
        bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * 2 * n_q * n * dim / INT8_OPS_PER_S
        padded = torch.zeros(-(-n_q // 8) * 8, dim, dtype=torch.int8, device="cuda")
        padded[:n_q] = qs
        try:  # the library's int8 GEMM (cuBLASLt), timed as a yardstick; the port never calls it
            lib = torch._int_mm(sig, padded.t())
            library_equal = torch.equal(lib[:, :n_q].t(), int8_mma.coarse_counts(qs, sig))
            library_ms, _ = events_ms(lambda: torch._int_mm(sig, padded.t()), reps=10)
            library_error = None
        except RuntimeError as e:
            library_ms, library_equal, library_error = None, None, str(e)[:200]
        bound_ms = max(bytes_ms, ops_ms)
        return dict(queries=n_q, ms=ms, random_signatures_ms=random_ms, signature_density=density,
                    plain_ms=plain_ms, bound_ms=bound_ms, bound_share=bound_ms / ms,
                    library_bound_share=bound_ms / library_ms if library_ms else None,
                    bound_by="bytes" if bytes_ms >= ops_ms else "operations", bytes=nbytes,
                    library_ms=library_ms, library_equal=library_equal, library_error=library_error)

    qsigs = torch.from_numpy(np.stack([pf.signature(q.residues) for q in queries])).cuda()
    density = float(sig.count_nonzero()) / sig.numel()
    coarse1, coarse17 = coarse_times(qsig[None].contiguous()), coarse_times(qsigs)
    say("prefilter.search", query=MAIN_QUERY, knobs=PREFILTER, candidates=n_cand, merged=int(cand.shape[0]),
        exact_jobs=[(int(part.shape[0]), n_out, route) for part, n_out, route in jobs],
        long_candidates=first.metrics.long_candidates,
        launches_first_search=launched, hits=first.hits, hits_exact=True, candidates_equal_plain=True,
        exhaustive_top10_in_candidates=sum(i in set(cand.tolist()) for i in full_top),
        wall_seconds=[m.wall_seconds for m in runs], device_seconds=[m.device_seconds for m in runs],
        packed_cells=runs[-1].packed_cells, host_phases_seconds=[m.phases for m in runs], exact_phase_ms=exact_ms,
        coarse_q1=coarse1, coarse_q17=coarse17, max_memory_allocated=torch.cuda.max_memory_allocated())

    # --- search_many for the suite: one coarse launch, hits equal to single searches
    singles = [eng.search(q, db) for q in queries]
    int8_mma.coarse_counts.launches = 0
    t0 = time.perf_counter()
    many = eng.search_many(queries, db)
    many_wall = time.perf_counter() - t0
    if int8_mma.coarse_counts.launches != 1:
        raise AssertionError(f"prefiltered search_many launched the coarse kernel {int8_mma.coarse_counts.launches} times")
    for name, a, b in zip(SUITE, many, singles):
        if a.hits != b.hits:
            raise AssertionError(f"prefiltered search_many: {name} differs from its single search")
    say("prefilter.many", queries=len(queries), coarse_launches=1, wall_seconds=many_wall,
        device_seconds=sum(r.metrics.device_seconds for r in many), launches=many[0].metrics.kernel_launches,
        single_wall_seconds=sum(r.metrics.wall_seconds for r in singles),
        single_device_seconds=sum(r.metrics.device_seconds for r in singles), hits_equal_single=True)

    # --- E-values: the sampled null is the exhaustive scores' at the sample
    eng_e = SearchEngine(cfg.replace(evalue=True), device="cuda")
    res = eng_e.search(query, db)
    sample = eng_e._evalue_sample(db)
    null = st.null_stats_from_scores(exhaustive[sample], n_subjects=db.n, query_length=query.length,
                                     mean_subject_length=db.length_sum / db.n, lengths=db.lengths[sample],
                                     population_lengths=db.lengths)
    if not null_equal(res.null_stats, null) or any(s != exhaustive[i] for i, s in res.hits):
        raise AssertionError("prefiltered E-value null differs from the exhaustive scores' at the sample")
    stats = res.top_k_stats(3)
    say("prefilter.evalue", query=MAIN_QUERY, sample=int(sample.shape[0]), null_equal_exhaustive=True,
        evalues=[h.evalue for h in stats], bits=[h.bits for h in stats], wall_seconds=res.metrics.wall_seconds)

    # --- recall: swtpu's battery check 9, five planted mutants of P02232 in the 10k golden database
    q = parse_query(qdir / "P02232.fasta")
    rng = np.random.default_rng(21)
    mutants = []
    for frac in (0.1, 0.2, 0.3, 0.4, 0.5):
        mres = q.residues.copy()
        idx = rng.choice(mres.shape[0], int(frac * mres.shape[0]), replace=False)
        mres[idx] = rng.integers(0, 25, idx.shape[0]).astype(np.int8)
        mutants.append(mres)
    seqs = synth.synth_scale_db(q.residues)
    db_hom = synth.database_from_arrays(seqs + mutants)
    exact5 = SearchEngine(SWConfig(top_k=5), device="cuda").search(q, db_hom).top_k(5)
    pre = SearchEngine(SWConfig(prefilter=0.05, top_k=5, prefilter_min_candidates=64), device="cuda").search(q, db_hom)
    planted = set(range(len(seqs), len(seqs) + 5))
    if pre.hits != exact5:
        raise AssertionError(f"planted-homolog recall: prefiltered {pre.hits} != exhaustive {exact5}")
    say("prefilter.recall", database=db_hom.n, planted=sorted(planted), hits=pre.hits, hits_equal_exhaustive=True,
        recall_of_exhaustive_top5=f"{len(set(exact5) & set(pre.hits))}/5",
        planted_in_exhaustive_top5=len(planted & {i for i, _ in exact5}), seconds=round(time.perf_counter() - t_phase, 3))
    return {
        "name": "coarse_counts (K7 int8 mma)", "route": "cuda", "source": "swtpu_torch/csrc/int8_mma.cu",
        "replaces": "tools/roofline.py:65", "launches": launched["coarse_counts"], "max_abs_err": counts_err,
        "ms": coarse1["ms"], "plain_ms": coarse1["plain_ms"], "bound_ms": coarse1["bound_ms"],
        "bound_by": coarse1["bound_by"], "library_ms": coarse1["library_ms"],
    }, {
        # plain_ms: the native host pass it replaces (swtpu builds the index on the host)
        "name": "kmer_signatures (K7 signatures)", "route": "cuda", "source": "swtpu_torch/csrc/kmer_signatures.cu",
        "replaces": "swtpu/native/sw_native.cpp:210", "launches": sig_launches, "max_abs_err": 0,
        "ms": sig_ms, "plain_ms": 1e3 * host_s, "bound_ms": sig_bound_ms, "bound_by": "bytes", "library_ms": None,
    }, {
        "name": "sw_long (prefilter long route)", "route": "cuda", "source": "swtpu_torch/csrc/sw_long.cu",
        "replaces": None, **long_lin, "bound_by": "operations", "library_ms": None,
    }, {
        # the affine instantiation on the same candidates; its error covers the two-pass Q9UKN1 pair too
        "name": "sw_long affine (prefilter long route)", "route": "cuda", "source": "swtpu_torch/csrc/sw_long.cu",
        "replaces": None, **long_aff, "max_abs_err": max(long_aff["max_abs_err"], long_q9["max_abs_err"]),
        "bound_by": "operations", "library_ms": None,
    }


MESH_QUERY_SHARD_SEQS = 20_000  # mesh.query_shard: the database's first sequences
MESH_QUERY_SHARD_QUERY = "P08519"  # mesh.query_shard: the suite's 4,548-residue query
MESH_SIZES = (4, 3)  # mesh.search's lane-sharded meshes


def mesh_devices(n):
    """The devices of an n-shard mesh: the one card named n times (every
    shard's kernels, the lane split and the merge run for real; no copy
    between cards and no scaling can show), and where the machine has n
    cards or more, also those cards."""
    import torch

    meshes = [("cuda:0 x %d" % n, ["cuda:0"] * n)]
    if n > 1 and torch.cuda.device_count() >= n:
        meshes.append(("cuda:0..%d" % (n - 1), [f"cuda:{i}" for i in range(n)]))
    return meshes


def phase_mesh_kernel():
    """mesh.kernel: tools/tpu_fuzz.py's main_shard cases (seed 555) and
    tools/tpu_validate.py's check 7 through the query-band pipeline at n = 1,
    2, 4, linear and at gaps 11/1, against one sw_wave over the whole
    profile and its plain version; every launch a band-carry hand-off.  Then
    make_sharded_step's K3 route on 2 and 3 shards of check 7's subjects,
    ties across shards included, against one K3 launch and the plain
    scorer."""
    import numpy as np
    import torch

    from swtpu_torch.matrices import blosum50_ref
    from swtpu_torch.ops import bucket_sw, row_sw, wave_sw
    from swtpu_torch.ops.profile import PAD_SUBJECT, make_profile
    from swtpu_torch.parallel import make_sharded_step, query_shard
    from swtpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    mat = blosum50_ref()
    rng = np.random.default_rng(555)
    cases = []
    for _ in range(3):  # tpu_fuzz.main_shard's draws, in its order
        L = int(rng.choice([150, 333, 700]))
        B = int(rng.integers(100, 900))
        Q = int(rng.integers(40, 600))
        gap = int(rng.choice([1, 2]))
        subj = np.full((B, L), PAD_SUBJECT, np.int8)
        for b in range(B):
            m = int(rng.integers(0, L + 1))
            subj[b, :m] = rng.integers(0, 25, m)
        cases.append((f"fuzz B={B} L={L} Q={Q}", rng.integers(0, 25, Q).astype(np.int8), subj, gap))
    rng2 = np.random.default_rng(13)  # tpu_validate.py check 7
    subj = np.full((700, 333), PAD_SUBJECT, np.int8)
    for i in range(700):
        m = int(rng2.integers(5, 333))
        subj[i, :m] = rng2.integers(0, 25, m)
    cases.append(("check7 B=700 L=333 Q=500", rng2.integers(0, 25, 500).astype(np.int8), subj, 2))

    rows, err, launched = [], 0, 0
    for name, q, subj, gap in cases:
        subjT, bt = query_shard.wave_layout(subj)
        n_tiles = subjT.shape[1] // bt
        prof = torch.from_numpy(make_profile(q, mat, pad_rows_to=wave_sw.W)).cuda()
        stack = torch.from_numpy(subjT).cuda()
        for gaps in (dict(gap=gap), dict(gap_open=11, gap_extend=1)):
            single = wave_sw.sw_wave(prof, stack, **gaps)[: subj.shape[0]].cpu().numpy()
            plain = wave_sw.sw_wave_plain(prof, stack, **gaps)[: subj.shape[0]].cpu().numpy()
            if not np.array_equal(single, plain):
                raise AssertionError(f"mesh.kernel {name} {gaps}: one sw_wave differs from its plain version")
            for n in (1, 2, 4):
                for label, devices in mesh_devices(n):
                    before = wave_sw.sw_wave.carry_launches
                    got = query_shard.wave_query_sharded_scores(make_mesh(devices=devices), q, subj, mat, **gaps)
                    launches = wave_sw.sw_wave.carry_launches - before
                    launched += launches
                    if launches != n * n_tiles:
                        raise AssertionError(f"mesh.kernel {name}: {launches} hand-off launches for {n} x {n_tiles} tiles")
                    err = max(err, int(np.abs(got.astype(np.int64) - single).max()))
                    if not np.array_equal(got, single):
                        raise AssertionError(f"mesh.kernel {name} {gaps} on {label}: pipeline differs from one sw_wave")
                    rows.append((name, "linear" if "gap" in gaps else "11/1", label, n_tiles, launches))
    # make_sharded_step's K3 route: check 7's subjects and 68 of them again
    # (each tied with a row of another shard), one K3 launch a shard, the
    # merged top-8 against one K3 launch over the batch and the plain scorer.
    _, q7, subj7, gap7 = cases[-1]
    k3_prof = torch.from_numpy(make_profile(q7, mat, pad_rows_to=32)).cuda()
    k3_subj = torch.from_numpy(np.concatenate([subj7, subj7[:68]])).cuda()
    whole = bucket_sw.sw_score_bucket(k3_prof, k3_subj, gap=gap7, strip=32).cpu().numpy()
    plain = row_sw.sw_score_bucket(k3_prof, k3_subj, gap=gap7, strip=32).cpu().numpy()
    top = np.lexsort((np.arange(whole.shape[0]), -whole))[:8]  # (score desc, id asc)
    k3_runs = []
    for n in (2, 3):
        for label, devices in mesh_devices(n):
            step = make_sharded_step(make_mesh(devices=devices), gap=gap7, strip=32, top_k=8, use_pallas=True)
            before = bucket_sw.sw_score_bucket.launches
            scores, top_ids, top_scores = step(k3_prof, k3_subj)
            launches = bucket_sw.sw_score_bucket.launches - before
            ok = (launches == n and np.array_equal(whole, plain) and np.array_equal(scores.cpu().numpy(), whole)
                  and np.array_equal(top_ids.cpu().numpy(), top) and np.array_equal(top_scores.cpu().numpy(), whole[top]))
            if not ok:
                raise AssertionError(f"mesh.kernel make_sharded_step K3 on {label}: differs from one K3 launch and the plain scorer")
            k3_runs.append((label, launches))
    say("mesh.kernel", cases=len(cases), runs=len(rows), hand_off_launches=launched, max_abs_err=err,
        columns=["case", "gaps", "mesh", "lane_tiles", "launches"], rows=rows, equal_single_and_plain=True,
        sharded_step_k3=k3_runs, seconds=round(time.perf_counter() - t_phase, 3))
    return err


def phase_mesh_search(db, first_scores, suite_scores, affine_engine):
    """mesh.search: the SwissProt-shaped database on lane-sharded meshes of 4
    and 3 (the card named n times): P01008's scores (counts zeroed just
    before the first search, read just after: n launches a bucket), top-10
    hits and E-values, gaps 10/2, the 17-query suite
    through search_many and search_queued, and 3 streamed queries, all
    bit-equal to the single-device engine; each shard's launches and ms; the
    n = 4 shards' launches alone against their plain version."""
    import numpy as np
    import torch

    from swtpu_torch.config import SWConfig
    from swtpu_torch.io.fasta import parse_query
    from swtpu_torch.models.search import SearchEngine
    from swtpu_torch.ops import wave_sw
    from swtpu_torch.parallel.mesh import on_device

    t_phase = time.perf_counter()
    queries = [parse_query(ROOT / "tests" / "data" / "queries" / f"{name}.fasta") for name in SUITE]
    query = queries[SUITE.index(MAIN_QUERY)]
    affine_want = affine_engine.search(query, db).scores
    ref_topk = SearchEngine(SWConfig(top_k=10, evalue=True), device="cuda").search(query, db)
    entry = None

    def same(name, got, want):
        if not np.array_equal(got, want):
            raise AssertionError(f"mesh.search {name}: {int((got != want).sum())} scores differ from one device's")

    for n in MESH_SIZES:
        for label, devices in mesh_devices(n):
            t_mesh = time.perf_counter()
            eng = SearchEngine(SWConfig(mesh_shape=(n,)), device=devices)
            # --- the mesh's main path: counts zeroed just before, read just after
            wave_sw.sw_wave.launches = 0
            t0 = time.perf_counter()
            res = eng.search(query, db)
            first_wall = time.perf_counter() - t0
            launches = wave_sw.sw_wave.launches
            packed = eng._resident_packed(db)
            groups = packed.wave_groups
            if launches != n * len(groups) or launches == 0:
                raise AssertionError(f"mesh.search {label}: {launches} launches for {n} shards x {len(groups)} buckets")
            same(f"{label} P01008", res.scores, first_scores)
            timed = [eng.search(query, db).metrics for _ in range(3)]
            # each shard's launches alone, back to back on its device
            profile = eng._profile(query)
            gap = eng.config.gap_penalty
            shard_ms, shard_lanes = [], []
            for k in range(n):
                dev = groups[0].parts[k].device
                prof_k = profile.to(dev)
                fn = lambda k=k, p=prof_k: [wave_sw.sw_wave(p, g.parts[k], gap=gap, n_segs=g.n_segs) for g in groups]  # noqa: E731
                with on_device(dev):  # events and launches on the shard's own device
                    events_ms(fn)  # warm
                    shard_ms.append(events_ms(fn, reps=3)[0])
                shard_lanes.append(sum(g.parts[k].shape[1] for g in groups))
            topk = SearchEngine(SWConfig(mesh_shape=(n,), top_k=10, evalue=True), device=devices).search(query, db)
            if topk.hits != ref_topk.hits or topk.top_k_stats(10) != ref_topk.top_k_stats(10):
                raise AssertionError(f"mesh.search {label}: top-10 hits or E-values differ from one device's")
            aff = SearchEngine(SWConfig(mesh_shape=(n,), **AFFINE), device=devices)
            same(f"{label} affine", aff.search(query, db).scores, affine_want)
            del aff
            t0 = time.perf_counter()
            many = eng.search_many(queries, db)
            many_wall = time.perf_counter() - t0
            t0 = time.perf_counter()
            queued = eng.search_queued(queries, db)
            queued_wall = time.perf_counter() - t0
            for name, a, b, want in zip(SUITE, many, queued, suite_scores):
                same(f"{label} search_many {name}", a.scores, want)
                same(f"{label} search_queued {name}", b.scores, want)
            three = [SUITE.index(x) for x in ("P02232", "P05013", "P14942")]
            streamed = SearchEngine(SWConfig(mesh_shape=(n,), device_resident=False), device=devices)
            for i, r in zip(three, streamed.search_many([queries[i] for i in three], db)):
                same(f"{label} streamed {SUITE[i]}", r.scores, suite_scores[i])
            say("mesh.search", mesh=label, shards=n, buckets=len(groups), launches_first_search=launches,
                first_search_wall_s=first_wall, device_seconds=[m.device_seconds for m in timed],
                wall_seconds=[m.wall_seconds for m in timed], shard_launches=[len(groups)] * n, shard_ms=shard_ms,
                shard_lanes=shard_lanes, suite_many_device_s=sum(r.metrics.device_seconds for r in many),
                suite_many_wall_s=many_wall, suite_queued_device_s=sum(r.metrics.device_seconds for r in queued),
                suite_queued_wall_s=queued_wall, topk_hits_and_evalues_equal=True, bit_equal_to_single=True,
                seconds=round(time.perf_counter() - t_mesh, 3))
            if entry is None:  # n = 4 on the one card: the kernel line's mesh entry
                kernel_ms = sum(shard_ms)
                plain_ms, plain = events_ms(lambda: [
                    wave_sw.sw_wave_plain(profile, part, gap=gap, n_segs=g.n_segs) for g in groups for part in g.parts
                ])
                flat = torch.cat([
                    torch.cat([plain[i * n + k] for k in range(n)]) for i in range(len(groups))
                ]).cpu().numpy()
                plain_scores = eng._reduce_flat(flat, packed)
                err = int(np.abs(plain_scores.astype(np.int64) - res.scores.astype(np.int64)).max())
                if err:
                    raise AssertionError(f"mesh.search: the shards' plain version differs by {err}")
                qpad = profile.shape[0]
                cells = sum(qpad * g.n_segs * g.seg_cols * g.lanes for g in groups)
                nbytes = sum(g.cells + n * qpad * 32 + 4 * g.rows for g in groups)
                bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * OPS_PER_CELL * cells / int32_ops_per_s
                entry = {
                    "name": f"sw_wave (lane-sharded mesh, {label})", "route": "cuda",
                    "source": "swtpu_torch/csrc/sw_wave.cu", "replaces": "swtpu/ops/wave_sw.py:815",
                    "launches": launches, "max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
                    "bound_ms": max(bytes_ms, ops_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
                    "library_ms": None,
                }
            del eng, streamed
            torch.cuda.empty_cache()
    say("mesh.search.done", seconds=round(time.perf_counter() - t_phase, 3))
    return entry


def phase_mesh_query_shard(db):
    """mesh.query_shard: the suite's 4,548-residue query against the
    database's first 20,000 sequences through the query-band pipeline at n = 4
    (counts zeroed just before each search, read just after: every launch a
    band-carry hand-off, four a lane tile), linear and at gaps 10/2, against
    the single-device engine; the CLI with --mesh 1 and --mesh 1
    --query-shard on the committed subset against its golden, and --mesh 2,
    which fails on one card and runs where there are two."""
    import contextlib
    import io

    import numpy as np
    import torch

    from swtpu_torch.cli import main as cli_main
    from swtpu_torch.config import SWConfig
    from swtpu_torch.io.fasta import parse_query
    from swtpu_torch.models.search import SearchEngine
    from swtpu_torch.ops import wave_sw
    from swtpu_torch.ops.profile import make_profile

    t_phase = time.perf_counter()
    query = parse_query(ROOT / "tests" / "data" / "queries" / f"{MESH_QUERY_SHARD_QUERY}.fasta")
    sub = db.take(np.arange(MESH_QUERY_SHARD_SEQS))
    n = 4
    entry = None
    for gname, gaps in (("linear", {}), ("affine", AFFINE)):
        one = SearchEngine(SWConfig(**gaps), device="cuda")
        want = one.search(query, sub).scores
        single_s = [one.search(query, sub).metrics.device_seconds for _ in range(2)]
        del one
        for label, devices in mesh_devices(n):
            eng = SearchEngine(SWConfig(mesh_shape=(n,), query_shard=True, **gaps), device=devices)
            packed = eng._resident_packed(sub)
            tiles = sum(g.parts[0].shape[0] for g in packed.wave_groups)
            wave_sw.sw_wave.launches = wave_sw.sw_wave.carry_launches = 0
            res = eng.search(query, sub)
            launched = {"launches": wave_sw.sw_wave.launches, "carry_launches": wave_sw.sw_wave.carry_launches}
            if launched["carry_launches"] != n * tiles or launched["launches"] != n * tiles:
                raise AssertionError(f"mesh.query_shard {label}: {launched} for {n} devices x {tiles} tiles")
            err = int(np.abs(res.scores.astype(np.int64) - want.astype(np.int64)).max())
            if err:
                raise AssertionError(f"mesh.query_shard {gname} {label}: scores differ from one device's by {err}")
            timed = [eng.search(query, sub).metrics for _ in range(2)]
            profile = eng._profile(query)
            # events on one device span the pipeline only when every stage is on it
            kernel_ms = events_ms(lambda: eng._flat(profile, packed), reps=2)[0] if len(eng._devices) == 1 else None
            say("mesh.query_shard", query=MESH_QUERY_SHARD_QUERY, query_length=query.length, sequences=sub.n, gaps=gname, mesh=label,
                buckets=len(packed.wave_groups), lane_tiles=tiles, launches=launched, pipeline_kernel_ms=kernel_ms,
                device_seconds=[m.device_seconds for m in timed], wall_seconds=[m.wall_seconds for m in timed],
                single_device_seconds=single_s,
                max_abs_err=err, bit_equal_to_single=True)
            if entry is None:
                # The plain version of the hand-off on one lane tile of each
                # bucket, the pipeline's kernels on the same tiles beside it.
                bands = [profile[k * profile.shape[0] // n:(k + 1) * profile.shape[0] // n] for k in range(n)]

                def pipe(fn):
                    outs = []
                    for g in packed.wave_groups:
                        carry = None
                        for k in range(n):
                            s_k, carry = fn(bands[k], g.parts[k][0], carry, return_carry=True, **eng._gaps)
                            outs.append(s_k)
                    return outs

                sample_ms, got = events_ms(lambda: pipe(wave_sw.sw_wave))
                plain_ms, plain = events_ms(lambda: pipe(wave_sw.sw_wave_plain))
                sample_err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, plain))
                if sample_err:
                    raise AssertionError(f"mesh.query_shard: the hand-off pipeline differs from its plain version by {sample_err}")
                qpad = profile.shape[0]
                cells = sum(qpad * g.width * g.lanes for g in packed.wave_groups)
                carry_io = sum(4 * g.width * g.lanes * (2 * n - 1) for g in packed.wave_groups)
                nbytes = sum(n * g.cells + qpad * 32 + n * 4 * g.lanes for g in packed.wave_groups) + carry_io
                bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * OPS_PER_CELL * cells / int32_ops_per_s
                entry = {
                    "name": f"sw_wave (carry hand-off, query-shard pipeline, {label})", "route": "cuda",
                    "source": "swtpu_torch/csrc/sw_wave.cu", "replaces": "swtpu/ops/wave_sw.py:815",
                    "launches": launched["carry_launches"], "max_abs_err": max(err, sample_err), "ms": kernel_ms,
                    "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                    "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "library_ms": None,
                    "plain_sample": "the first lane tile of each bucket, the %d devices' bands in turn (kernel %.3f ms "
                                    "on the same sample)" % (n, sample_ms),
                }
            del eng
    # --- the CLI: --mesh 1, --mesh 1 --query-shard, --mesh 2
    golden = (ROOT / "tests" / "data" / "golden_P02232_subset.txt").read_text().split()
    base = ["--query", str(ROOT / "tests" / "data" / "queries" / "P02232.fasta"),
            "--db", str(ROOT / "tests" / "data" / "uniprot_subset.fasta")]
    cli = {}
    for flags in (["--mesh", "1"], ["--mesh", "1", "--query-shard"], ["--mesh", "2"]):
        out, errs = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(errs):
            rc = cli_main(base + flags)
        dump = [ln.split(":")[1] for ln in out.getvalue().splitlines() if ln[:1].isdigit() and ":" in ln]
        two_cards = torch.cuda.device_count() >= 2
        if flags == ["--mesh", "2"] and not two_cards:
            if rc != 2 or "only 1 available" not in errs.getvalue():
                raise AssertionError(f"--mesh 2 on one card: rc {rc}, {errs.getvalue()!r}")
        elif rc != 0 or dump != golden:
            raise AssertionError(f"CLI {' '.join(flags)}: rc {rc}, dump equal to the golden: {dump == golden}")
        cli[" ".join(flags)] = {"rc": rc, "stderr": errs.getvalue().strip()[:160]}
    say("mesh.cli", runs=cli, golden="tests/data/golden_P02232_subset.txt", seconds=round(time.perf_counter() - t_phase, 3))
    return entry


def phase_mesh_rows(db, first_scores):
    """mesh.rows: the row path on meshes of 4 and 3 (the card named n
    times): P01008 through K2 on every row shard with PyTorch seg16 (int32;
    K2's counts zeroed just before the first search, read just after:
    groups x n launches), the int16 mode and the streamed K3 route (on the
    primary), each bit-equal to the one-device wavefront scores; each
    shard's K2 ms and device_seconds; at the 4-shard split every shard's K2
    launch against its plain version (the per-shard shapes cross
    bucket_sw.BAND_ROWS at other groups than one device's)."""
    import numpy as np
    import torch

    from swtpu_torch.config import SWConfig
    from swtpu_torch.io.fasta import parse_query
    from swtpu_torch.models.search import SearchEngine
    from swtpu_torch.ops import bucket_sw, row_sw
    from swtpu_torch.parallel.mesh import on_device

    t_phase = time.perf_counter()
    query = parse_query(ROOT / "tests" / "data" / "queries" / f"{MAIN_QUERY}.fasta")
    entry = None

    def same(name, got):
        if not np.array_equal(got, first_scores):
            raise AssertionError(f"mesh.rows {name}: {int((got != first_scores).sum())} scores differ from one device's")

    for n in MESH_SIZES:
        for label, devices in mesh_devices(n):
            t_mesh = time.perf_counter()
            eng = SearchEngine(SWConfig(mesh_shape=(n,), use_wave=False), device=devices)
            # --- this phase's main path: counts zeroed just before, read just after
            bucket_sw.sw_score_bucket_fused.launches = bucket_sw.sw_score_bucket.launches = 0
            t0 = time.perf_counter()
            res = eng.search(query, db)  # packs on the host, places the row shards, then scores
            first_wall = time.perf_counter() - t0
            launches, k3_stray = bucket_sw.sw_score_bucket_fused.launches, bucket_sw.sw_score_bucket.launches
            packed = eng._resident_packed(db)
            profile = eng._profile(query)
            profiles = eng._replicas(profile)
            steps = [[eng._fused_step(profiles[k], part) for k, part in enumerate(g.parts)] for g in packed.groups]
            expect = sum(-(-g.chunks // step) for g, st in zip(packed.groups, steps) for step in st)
            if launches != expect or launches < n * len(packed.groups) or k3_stray:
                raise AssertionError(f"mesh.rows {label}: K2 {launches} launches (K3 {k3_stray}) for {len(packed.groups)} "
                                     f"groups x {n} shards in {expect}")
            same(f"{label} K2 + seg16", res.scores)
            timed = eng.search(query, db).metrics
            shard_ms = []
            for k in range(n):
                dev = packed.groups[0].parts[k].device
                fn = lambda k=k: [eng._fused_stack(profiles[k], g.parts[k]) for g in packed.groups]  # noqa: E731
                with on_device(dev):
                    events_ms(fn)  # warm
                    shard_ms.append(events_ms(fn, reps=3)[0])
            i16 = SearchEngine(SWConfig(mesh_shape=(n,), score_dtype="int16"), device=devices)
            before = bucket_sw.sw_score_bucket_fused.launches
            i16_res = i16.search(query, db)
            same(f"{label} int16", i16_res.scores)
            i16_launches = bucket_sw.sw_score_bucket_fused.launches - before
            if i16_launches < n:
                raise AssertionError(f"mesh.rows {label}: the int16 mode launched K2 {i16_launches} times on {n} shards")
            del i16
            streamed = SearchEngine(SWConfig(mesh_shape=(n,), use_wave=False, device_resident=False), device=devices)
            before = bucket_sw.sw_score_bucket.launches
            st_res = streamed.search(query, db)
            k3_launches = bucket_sw.sw_score_bucket.launches - before
            batches = len(streamed.plan(db).batches)
            if k3_launches != batches:
                raise AssertionError(f"mesh.rows {label}: streamed K3 {k3_launches} launches for {batches} batches")
            same(f"{label} streamed K3", st_res.scores)
            shapes = {}
            n_bands = -(-profile.shape[0] // bucket_sw.W)
            for g, st in zip(packed.groups, steps):
                for part, step in zip(g.parts, st):
                    key = "G{}H{}".format(*bucket_sw.rows_shape(n_bands, min(g.chunks, step) * part.shape[1]))
                    shapes[key] = shapes.get(key, 0) + 1
            say("mesh.rows", mesh=label, shards=n, ladder_groups=len(packed.groups), seg_groups=len(packed.seg_groups),
                k2_launches_first_search=launches, k2_shapes=shapes, first_search_wall_s=first_wall,
                device_seconds=timed.device_seconds, wall_seconds=timed.wall_seconds, shard_k2_ms=shard_ms,
                rescored_rows=eng.rescored_rows, int16_k2_launches=i16_launches,
                int16_device_seconds=i16_res.metrics.device_seconds, streamed_k3_launches=k3_launches,
                streamed_device_seconds=st_res.metrics.device_seconds, streamed_wall_seconds=st_res.metrics.wall_seconds,
                bit_equal_to_single=True, seconds=round(time.perf_counter() - t_mesh, 3))
            if entry is None:  # n = 4 on the one card: every shard's K2 launches against the plain version
                gap = eng.config.gap_penalty
                plain_ms, plain = events_ms(lambda: [row_sw.sw_score_stack(profiles[k], part, gap=gap, strip=32)
                                                     for g in packed.groups for k, part in enumerate(g.parts)])
                got = [eng._fused_stack(profiles[k], part) for g in packed.groups for k, part in enumerate(g.parts)]
                err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, plain))
                if err or not all(torch.equal(a, b) for a, b in zip(got, plain)):
                    raise AssertionError(f"mesh.rows: a row shard's K2 differs from its plain version by {err}")
                qpad = profile.shape[0]
                cells = sum(qpad * g.chunks * g.rows * g.width for g in packed.groups)
                nbytes = sum(part.numel() + qpad * 32 + 4 * part.shape[0] * part.shape[1]
                             for g in packed.groups for part in g.parts)
                b_ms, b_by = row_bound(cells, nbytes)
                entry = {
                    "name": f"sw_rows_fused (K2, row-sharded mesh, {label})", "route": "cuda",
                    "source": "swtpu_torch/csrc/sw_rows.cu", "replaces": "swtpu/ops/pallas_sw.py:200",
                    "launches": launches, "max_abs_err": err, "ms": sum(shard_ms), "plain_ms": plain_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                }
                del got, plain
            del eng, streamed, packed, profiles
            torch.cuda.empty_cache()
    say("mesh.rows.done", seconds=round(time.perf_counter() - t_phase, 3))
    return entry


def phase_mesh_prefilter(db):
    """mesh.prefilter: P01008 at prefilter 0.05, top-10, with E-values on 4
    shards (the card named four times; the coarse pass and the gathered
    exact phase on the primary, as swtpu's): hits and E-values equal to the
    one-device prefilter's, one coarse launch (counts zeroed just before,
    read just after); the host phases' seconds of a second search beside
    one device's."""
    from swtpu_torch.config import SWConfig
    from swtpu_torch.io.fasta import parse_query
    from swtpu_torch.models.search import SearchEngine
    from swtpu_torch.ops import int8_mma

    t_phase = time.perf_counter()
    query = parse_query(ROOT / "tests" / "data" / "queries" / f"{MAIN_QUERY}.fasta")
    one_eng = SearchEngine(SWConfig(evalue=True, **PREFILTER), device="cuda")
    one = one_eng.search(query, db)
    one_timed = one_eng.search(query, db).metrics
    say("mesh.prefilter.single", query=MAIN_QUERY, device_seconds=one_timed.device_seconds,
        wall_seconds=one_timed.wall_seconds, phases=one_timed.phases)
    for label, devices in mesh_devices(4):
        eng = SearchEngine(SWConfig(mesh_shape=(4,), evalue=True, **PREFILTER), device=devices)
        int8_mma.coarse_counts.launches = 0
        t0 = time.perf_counter()
        res = eng.search(query, db)
        wall = time.perf_counter() - t0
        coarse = int8_mma.coarse_counts.launches
        if coarse != 1 or res.hits != one.hits or res.top_k_stats(10) != one.top_k_stats(10):
            raise AssertionError(f"mesh.prefilter {label}: {coarse} coarse launches; hits or E-values differ from one device's")
        timed = eng.search(query, db).metrics
        say("mesh.prefilter", mesh=label, query=MAIN_QUERY, coarse_launches=coarse, kernel_launches=res.metrics.kernel_launches,
            first_search_wall_s=wall, device_seconds=timed.device_seconds, wall_seconds=timed.wall_seconds,
            phases=timed.phases, first_search_phases=res.metrics.phases, hits_and_evalues_equal_single=True, seconds=round(time.perf_counter() - t_phase, 3))
        del eng


def phase_mesh_query_shard_streamed(db):
    """mesh.query_shard.streamed: mesh.query_shard's 20,000-sequence
    database and P08519 at n = 4 under a residency budget that forces
    streaming: swtpu's route, the row ladder batch by batch on the primary
    (K3, one launch a batch: counts zeroed just before, read just after),
    bit-equal to one device."""
    import numpy as np

    from swtpu_torch.config import SWConfig
    from swtpu_torch.io.fasta import parse_query
    from swtpu_torch.models.search import SearchEngine
    from swtpu_torch.ops import bucket_sw, wave_sw

    t_phase = time.perf_counter()
    query = parse_query(ROOT / "tests" / "data" / "queries" / f"{MESH_QUERY_SHARD_QUERY}.fasta")
    sub = db.take(np.arange(MESH_QUERY_SHARD_SEQS))
    want = SearchEngine(SWConfig(), device="cuda").search(query, sub).scores
    for label, devices in mesh_devices(4):
        # a budget of a quarter of its residues: no plan of it fits
        eng = SearchEngine(SWConfig(mesh_shape=(4,), query_shard=True, device_resident_cells=sub.length_sum // 4), device=devices)
        bucket_sw.sw_score_bucket.launches = wave_sw.sw_wave.launches = 0
        res = eng.search(query, sub)
        k3, k1 = bucket_sw.sw_score_bucket.launches, wave_sw.sw_wave.launches
        batches = len(eng.plan(sub).batches)
        if eng._resident is not None or k3 != batches or k1:
            raise AssertionError(f"mesh.query_shard.streamed {label}: K3 {k3} launches for {batches} batches, K1 {k1}")
        err = int(np.abs(res.scores.astype(np.int64) - want.astype(np.int64)).max())
        if err:
            raise AssertionError(f"mesh.query_shard.streamed {label}: scores differ from one device's by {err}")
        say("mesh.query_shard.streamed", mesh=label, query=MESH_QUERY_SHARD_QUERY, sequences=sub.n, k3_launches=k3,
            batches=batches, device_seconds=res.metrics.device_seconds, wall_seconds=res.metrics.wall_seconds,
            pack_seconds=res.metrics.phases.get("pack_and_put"), bit_equal_to_single=True,
            seconds=round(time.perf_counter() - t_phase, 3))


FLEET_TIMEOUT = 600  # seconds a dist.fleet process may take before it is killed

FLEET_WORKER = r"""
import json, sys, time
import torch
import torch.distributed as dist
from chip_smoke import MAIN_QUERY, ROOT, SUITE, events_ms
from swtpu_torch.config import SWConfig
from swtpu_torch.io.fasta import parse_database, parse_query
from swtpu_torch.ops import wave_sw
from swtpu_torch.parallel import distributed as D
from swtpu_torch.utils.bucketing import pack_database_wave

pid, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
t0 = time.perf_counter()
D.initialize(f"127.0.0.1:{port}", 2, pid, timeout=300)
t = time.perf_counter()
db = parse_database(path)
queries = [parse_query(ROOT / "tests" / "data" / "queries" / f"{name}.fasta") for name in SUITE]
parse_s = time.perf_counter() - t
eng = D.DistributedSearchEngine(SWConfig(evalue=True), device="cuda")  # cuda:<process id mod the cards>
shard, base = eng.shard_of(db)
t = time.perf_counter()
resident = eng.pack(shard, 10)
pack_s = time.perf_counter() - t
main = queries[SUITE.index(MAIN_QUERY)]
# --- this phase's main path, P01008 then the suite: counts zeroed just
# before each, read just after
wave_sw.sw_wave.launches = 0
one = eng.search(main, shard, base, top_k=10)
main_launches = wave_sw.sw_wave.launches
wave_sw.sw_wave.launches = 0
t = time.perf_counter()
res = eng.search_many(queries, shard, base, top_k=10)
search_s = time.perf_counter() - t
suite_launches = wave_sw.sw_wave.launches

# K1 on this shard's buckets for P01008 (the launches of the P01008 search;
# packed here when the shard streams) against its plain version, one process
# at a time so that the two do not share the card while timed
local = eng._engine(10)
packed = local._resident_packed(shard)
if packed is None:
    packed = pack_database_wave(shard, device=local.device, plan=local._wave_plan(shard))
profile = local._profile(main)
kernel = {}
for turn in range(2):
    if turn == pid:
        groups = packed.wave_groups
        run = lambda f: [f(profile, g.stack, **local._gaps, n_segs=g.n_segs) for g in groups]  # noqa: E731
        events_ms(lambda: run(wave_sw.sw_wave))  # warm
        ms, got = events_ms(lambda: run(wave_sw.sw_wave), 3)
        plain_ms, plain = events_ms(lambda: run(wave_sw.sw_wave_plain))
        err = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, plain))
        kernel = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                      cells=sum(profile.shape[0] * g.n_segs * g.seg_cols * g.lanes for g in groups),
                      bytes=sum(g.stack.numel() + profile.shape[0] * 32 + 4 * g.rows for g in groups), buckets=len(groups))
    dist.barrier()
dist.destroy_process_group()
print("FLEET " + json.dumps({
    "process": pid, "device": str(eng.device), "route": "resident" if resident else "streamed", "n_local": shard.n,
    "shard_base": base, "main_hits": one.hits, "hits": [r.hits for r in res],
    "stats": [[[h.evalue, h.bits] for h in r.hit_stats()] for r in res],
    "collective_seconds": res[0].collective_seconds, "k1_launches_main": main_launches,
    "k1_launches_suite": suite_launches, "parse_seconds": parse_s, "pack_seconds": pack_s, "search_seconds": search_s,
    "wall_seconds": time.perf_counter() - t0, "kernel": kernel,
}), flush=True)
"""


def fleet_run(commands):
    """Start every command at once (cwd the repository), wait for each with
    a timeout, kill all on any failure or expiry; their stdout texts."""
    procs = [subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for cmd in commands]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=FLEET_TIMEOUT)
            if p.returncode != 0:
                raise AssertionError(f"dist.fleet: a process exited {p.returncode}:\n{err[-4000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_dist_fleet(path, db, suite_scores):
    """dist.fleet: two processes of the multi-process fleet with gloo on
    127.0.0.1, both on the one card, on the SwissProt-shaped FASTA file of
    native.parse.  First ``python -m swtpu_torch.parallel.launch --json``:
    both print the same hits, the one-device top-10 of P01008.  Then
    DistributedSearchEngine.search_many over the 17-query suite with
    E-values in two worker processes (K1's counts zeroed just before, read
    just after, in each): hits equal to the one-device engine's, E-values
    within swtpu's battery tolerance (log-E 5%, bits 1%) of the one-device
    null under the pooled law the fleet uses (length bins are shard-local);
    and K1 on each shard's buckets against its plain version, one process at
    a time.  Each process's wall, parse, pack and search seconds, the
    collective's, and its route (resident or streamed).  The file is
    deleted afterwards."""
    import numpy as np

    from swtpu_torch.config import SWConfig
    from swtpu_torch.io.fasta import parse_query
    from swtpu_torch.models.search import SearchEngine, SearchResult
    from swtpu_torch.stats import hit_significance

    t_phase = time.perf_counter()
    qdir = ROOT / "tests" / "data" / "queries"
    want10 = SearchResult(scores=suite_scores[SUITE.index(MAIN_QUERY)], metrics=None).top_k(10)
    port = free_port()
    cmd = [sys.executable, "-m", "swtpu_torch.parallel.launch", "--query", str(qdir / f"{MAIN_QUERY}.fasta"),
           "--db", str(path), "--json", "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2"]
    t0 = time.perf_counter()
    outs = fleet_run([cmd + ["--process-id", str(p)] for p in range(2)])
    launch_wall = time.perf_counter() - t0
    launch = [json.loads([ln for ln in out.splitlines() if ln.startswith("{")][-1]) for out in outs]
    if not all(p["device"].startswith("cuda") for p in launch):
        raise AssertionError(f"dist.fleet launch: a process ran off the card: {[p['device'] for p in launch]}")
    if not launch[0]["hits"] == launch[1]["hits"] == [list(h) for h in want10]:
        raise AssertionError(f"dist.fleet launch: the processes' hits {launch[0]['hits']} / {launch[1]['hits']} "
                             f"are not the one-device top-10 {want10}")
    say("dist.fleet.launch", query=MAIN_QUERY, processes=launch, both_wall_s=launch_wall, hits_equal_single_top10=True)

    port = free_port()
    t0 = time.perf_counter()
    outs = fleet_run([[sys.executable, "-c", FLEET_WORKER, str(p), str(port), str(path)] for p in range(2)])
    fleet_wall = time.perf_counter() - t0
    path.unlink()
    ranks = [json.loads([ln for ln in out.splitlines() if ln.startswith("FLEET ")][-1][len("FLEET "):]) for out in outs]
    if not all(r["device"].startswith("cuda") for r in ranks):
        raise AssertionError(f"dist.fleet: a process ran off the card: {[r['device'] for r in ranks]}")
    if not ranks[0]["main_hits"] == ranks[1]["main_hits"] == [list(h) for h in want10]:
        raise AssertionError(f"dist.fleet: the processes' {MAIN_QUERY} hits are not the one-device top-10 {want10}")
    queries = [parse_query(qdir / f"{name}.fasta") for name in SUITE]
    one = SearchEngine(SWConfig(top_k=10, evalue=True), device="cuda").search_many(queries, db)
    worst_loge = worst_bits = 0.0
    for qi, r in enumerate(one):
        if not ranks[0]["hits"][qi] == ranks[1]["hits"][qi] == [list(h) for h in r.hits]:
            raise AssertionError(f"dist.fleet: {SUITE[qi]}'s hits differ from the one-device engine's")
        if ranks[0]["stats"][qi] != ranks[1]["stats"][qi]:
            raise AssertionError(f"dist.fleet: {SUITE[qi]}'s E-values differ between the processes")
        for (ev, bits), h in zip(ranks[0]["stats"][qi], hit_significance(r.null_stats, r.hits, length_correct=False)):
            worst_loge = max(worst_loge, abs(np.log(max(ev, 1e-300)) - np.log(max(h.evalue, 1e-300))))
            worst_bits = max(worst_bits, abs(bits - h.bits) / abs(h.bits))
    if worst_loge > 0.05 or worst_bits > 0.01:
        raise AssertionError(f"dist.fleet: E-values off the one-device pooled fit by log-E {worst_loge}, bits {worst_bits}")
    if any(r["k1_launches_main"] == 0 or r["k1_launches_suite"] == 0 for r in ranks):
        raise AssertionError(f"dist.fleet: a process launched no K1: {ranks}")
    kernels = [r.pop("kernel") for r in ranks]
    for r in ranks:
        r.pop("main_hits"), r.pop("hits"), r.pop("stats")
    if any(r["k1_launches_main"] != k["buckets"] for r, k in zip(ranks, kernels)):
        raise AssertionError(f"dist.fleet: {MAIN_QUERY}'s K1 launches {[r['k1_launches_main'] for r in ranks]} "
                             f"are not the shards' buckets {[k.get('buckets') for k in kernels]}")
    err = max(k["max_abs_err"] for k in kernels)
    if err:
        raise AssertionError(f"dist.fleet: K1 on a shard differs from its plain version by {err}")
    b_ms, b_by = row_bound(sum(k["cells"] for k in kernels), sum(k["bytes"] for k in kernels))
    say("dist.fleet", queries=len(SUITE), processes=ranks, both_wall_s=fleet_wall, hits_equal_single=True,
        suite_k1_launches=sum(r["k1_launches_suite"] for r in ranks),
        max_abs_log_evalue_diff=worst_loge, max_rel_bits_diff=worst_bits, shard_kernel_ms=[k["ms"] for k in kernels],
        seconds=round(time.perf_counter() - t_phase, 3))
    return {
        "name": "sw_wave (K1 in a 2-process gloo fleet, one shard a process, cuda:0 twice)", "route": "cuda",
        "source": "swtpu_torch/csrc/sw_wave.cu", "replaces": "swtpu/ops/wave_sw.py:815",
        "launches": sum(r["k1_launches_main"] for r in ranks), "max_abs_err": err,
        "ms": sum(k["ms"] for k in kernels), "plain_ms": sum(k["plain_ms"] for k in kernels),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not installed: {e}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        import swtpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: swtpu_torch not found beside this script: {e}", file=sys.stderr)
        return 1
    import tempfile

    t0 = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")  # the FASTA file of native.parse and dist.fleet
    try:
        smi = phase_card()
        built = phase_build()
        kernel_err = phase_kernel()
        multi_err = phase_kernel_multi()
        affine_err = phase_kernel_affine()
        rows_err = phase_kernel_rows()
        rows_lab_err = phase_kernel_rows_lab()
        carry_err = phase_kernel_carry()
        mesh_kernel_err = phase_mesh_kernel()
        counts_err, probe_err = phase_kernel_mma()
        chain_err = phase_kernel_chain()
        lab_err = phase_kernel_lab()
        i16_err = phase_kernel_i16()
        probe, chain = phase_roofline(built)
        k9 = phase_i16_rates(built)  # three entries: elementwise tiles, dp_row tiles, chains
        phase_goldens()
        phase_goldens_affine()
        t_fuzz = time.perf_counter()
        fuzz_err = phase_fuzz()
        phase_battery()
        added_s = time.perf_counter() - t_fuzz
        entry, db, engine, q1_bucket_ms, first_scores = phase_scale()
        t_profile = time.perf_counter()
        phase_profile(db, engine, first_scores, tmp.name)
        added_s += time.perf_counter() - t_profile
        say("fuzz.battery.profile", seconds=round(added_s, 3))
        fasta = phase_native_parse_and_cli(db, engine, tmp.name)
        multi, suite_scores = phase_serving(db, engine, q1_bucket_ms)
        affine, affine_engine = phase_affine(db, q1_bucket_ms)
        phase_align(db, engine, affine_engine)
        k2, k3, row_engine = phase_rows(db, engine)
        phase_native_pack(db, engine, row_engine)
        mesh_lanes = phase_mesh_search(db, suite_scores[SUITE.index(MAIN_QUERY)], suite_scores, affine_engine)
        mesh_bands = phase_mesh_query_shard(db)
        mesh_rows = phase_mesh_rows(db, suite_scores[SUITE.index(MAIN_QUERY)])
        phase_mesh_prefilter(db)
        phase_mesh_query_shard_streamed(db)
        dist_fleet = phase_dist_fleet(fasta, db, suite_scores)
        coarse, signatures, long_route, long_affine = phase_prefilter(db, engine)
        labs = phase_lab(db, engine)
        k10 = phase_lab_rows(db, engine, row_engine)
    except Exception:  # every phase failure ends the run without a result
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    finally:
        tmp.cleanup()
    fuzz = lambda *keys: max((fuzz_err.get(k, 0) for k in keys), default=0)  # noqa: E731
    entry["max_abs_err"] = max(entry["max_abs_err"], kernel_err, fuzz("K1 B1a", "K1 B1b"))
    multi["max_abs_err"] = max(multi["max_abs_err"], multi_err, fuzz("K1 B1c"))
    affine["max_abs_err"] = max(affine["max_abs_err"], affine_err, fuzz("K1 B1e"))
    for k in (k2, mesh_rows):
        k["max_abs_err"] = max(k["max_abs_err"], rows_err, fuzz("K2 stack", "K2 fast16"))
    k3["max_abs_err"] = max(k3["max_abs_err"], rows_err, fuzz("K3 bucket"))
    mesh_bands["max_abs_err"] = max(mesh_bands["max_abs_err"], mesh_kernel_err, carry_err, fuzz("K1 B1d"))
    coarse["max_abs_err"] = max(coarse["max_abs_err"], counts_err)
    probe["max_abs_err"] = max(probe["max_abs_err"], probe_err)
    chain["max_abs_err"] = max(chain["max_abs_err"], chain_err)
    for k in labs:
        k["max_abs_err"] = max(k["max_abs_err"], lab_err)
    for k in k10:
        k["max_abs_err"] = max(k["max_abs_err"], rows_lab_err)
    for k in k9:
        k["max_abs_err"] = max(k["max_abs_err"], i16_err)
    print(json.dumps({"kernels": [entry, multi, affine, k2, k3, mesh_lanes, mesh_bands, mesh_rows, dist_fleet, coarse,
                                  signatures, long_route, long_affine, probe, chain, *labs, *k9, *k10]}))
    print(smi)
    say("done", seconds=round(time.perf_counter() - t0, 3))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
