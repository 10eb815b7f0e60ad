// Row-parallel lab kernels for Hopper (sm_90a): one query against row-major
// (C, B, L) stacks of subjects, linear gaps, exact int32.
//
// Replaces K10, the four row-parallel lab kernels of tools/pallas_lab.py,
// behind one C entry point, sw_rows_lab_launch, in two designs:
//  * v2 and v3, the warp-scan design: sw_rows_lab_kernel<STAGE, SCAN, S, ILP,
//    FOLD>, one WARP a subject row, the horizontal gap as a u-space max-scan
//    over the 32 lanes, the scores staged by mma.sync one-hots;
//  * v4 and v41, the wavefront design: sw_rows_wave_lab_kernel<H, ILP,
//    ROLL>, a copy of K2's warp wavefront (sw_rows.cu: wave_rows<G>), G
//    threads a subject row, the schedule the row kernel ships.  A lab kernel
//    that does not run the shipping schedule measures nothing about it, so
//    each TPU knob became a knob of K2's schedule, beside K2 in the lab.
// Every variant computes K2's contract (sw_rows.cu; xla_sw.sw_score_bucket):
// for each subject row, the Smith-Waterman maximum of the (n_strips * S, 32)
// int8 profile against the row's L residues (pads PAD_SUBJECT = 25).  A strip
// (band) height changes no score; the wrapper pads the profile to whole
// strips with PAD_SCORE rows, which cannot raise a maximum.
//
// v2, sw_v2 (tools/pallas_lab.py:102, kernel _v2_kernel :44): STAGE =
// SUBJECT, SCAN = SHFL_UP, S = 16 or 32.  Each warp stages its own subject's
// scores: an mma's 8 columns are 8 consecutive columns of that subject
// (swtpu's per-subject block-diagonal lhs, expand_profile_blockdiag).  The
// gap is added in the cell (s + gap), as v2 adds it to s_row.
// v3, sw_v3 (:206, _v3_kernel :144): STAGE = SHARED, SCAN = SHFL_UP, S = 16
// or 32.  A block of 8 warps is v3's sub-batch of 8 subjects and stages its
// chunk together: one A fragment in registers serves the 8 subjects, an
// mma's 8 columns are one column of the 8 subjects, and the scores land in
// DP order in a (S, 8, 32) shared tile, as v3's s_ref (strip, tile_b, L).
// The template keeps the ILP, SCAN = ROLL and FOLD parameters that v4 and v41
// took in the warp-scan design; no instantiation uses them now.
//
// The warp-scan form (swtpu's intra-sequence u-space form, redesigned for a warp).
// With u[j] = H[j] + j*gap, a query row is t = max(j*gap, diag_u + s + gap,
// u_prev - gap), then u = the running max of t along the row, and the best H
// is the max of t - j*gap.  One warp owns a subject row; its 32 lanes hold 32
// consecutive columns (a chunk).  The query runs in strips of S rows; within
// a strip the warp walks the row's chunks left to right and, inside a chunk,
// steps the S rows: u_prev is the lane's own u of the row above, diag_u the
// lane to the left's (a shuffle; at lane 0 the previous chunk's last column,
// or -gap at column 0), then an inclusive max-scan over the 32 lanes (five
// shuffle steps) and a max with the row's carry-in, the previous chunk's last
// u of the same row; best = max(best, t - j*gap), before the scan.  The
// strip's bottom row of u goes to a per-subject global carry, one int32 a
// column, read as the next strip's top row.  Lanes past L take a floor of
// -2^30 and subtract 2^30 for the best.  Scores: mma.sync.m16n8k32.s8, A =
// 16 profile rows x 32 residues from the profile's bytes, B = the one-hot of
// 8 columns, staged to a shared tile; each lane reads its column back.  It
// spends about 20 instructions a cell and lane (the scan's 5 shuffles and 5
// maxes, the diagonal's shuffle and select, the carry-in max and the
// broadcast of lane 31, on top of K2's cell), and two block barriers a chunk
// where it is SHARED: 7-8x K2's time on P01008's row-path groups (PERF.md).
//
// v4 and v41 on K2's warp wavefront.  Copied from sw_rows.cu, not shared
// (that file does not move): the Stage<H> shared profile ([band][residue]
// [row] int32, row stride H + 4), the first thread's 16-byte chunk loads of
// the row, one chunk ahead, the cell, the volatile-PTX hand-off, and the
// carry through global memory only between passes, column-major across the
// rows.  G threads of a warp score a group of rows; thread g holds band g of
// the pass (H query rows) in registers and at step t computes column t - g,
// handing its band's bottom H, the column's residue and the running best to
// thread g + 1 by one shuffle each.  A pass is G bands; the block stages them
// once for all its threads.  G is a runtime argument: the fewest power of two
// at least the bands, at most MAX_G (16 at 32-row bands, as K2; 32 at 16-row
// bands), passes ceil(bands / G) (WaveSchedule here; ops/rows_lab.py:
// wave_schedule, which the tests pin, computes the same).  The knobs:
//  * v4, sw_v4 (:304, _v4_kernel :236), "interleaved independent DP chains
//    hide the vector unit's latency": ILP = 2 or 4 subject rows a thread
//    group at H = 32.  Thread g holds band g of ILP rows; their cells are
//    interleaved row by row and their hand-offs step by step, so one chain's
//    shuffles and max chains overlap another's.  A block of 128 threads
//    still stages one pass of profile, for 128 / G x ILP rows; it trades
//    blocks (a 64-row group gets 8 / ILP at G = 16) for independent chains.
//  * v41, sw_v41 (:389, _v41_kernel :334), "the shift as a rotate under
//    hoisted masks": ROLL, the hand-off as shfl.sync.idx from a source lane
//    hoisted out of the column loop, (lane & ~(G-1)) | ((lane - 1) & (G-1)),
//    where K2 uses shfl.sync.up; the group's first thread takes its own
//    values by the select on `first`, hoisted to the pass, as the warp-scan
//    ROLL scan selected under its masks.  At strip 16 the bands are 16 rows
//    and G runs up to 32 (P01008's 480-row profile: 30 bands, one pass at G = 32,
//    against K2's 15 at G = 16), half a step's cell chain; the block is 256
//    threads there, so one 82,432-byte stage (2 blocks an SM by shared
//    memory) still serves 8 rows at G = 32, as K2's 128 threads at G = 16.
//    At strip 32 it is K2's shape.
//  * FOLD has no counterpart.  The warp-scan u-space cell adds the gap to the
//    score (diag_u + s + gap), which v4 and v41 folded into the staging.  In
//    K2's H-space cell the diagonal takes no gap, and the gap terms, left -
//    gap and up - gap, are each the add of an add-max (VIADDMNMX: an add,
//    then a max, one issue slot) with the gap as its operand, folded or not:
//    there is nothing to fold.  chip_smoke.py's build line counts the column
//    loops' VIADDMNMX and IADD3 a cell: 2.00 VIADDMNMX a cell in K2's and in
//    these four on an H100 (PERF.md).
// Every hand-off is volatile PTX issued by every lane where it stands: ptxas
// once sank a shuffle into a branch on the lane and made a kernel 4x slower.
//
// What bounds the rebuilt variants: int32 operations, K2's ~6 a padded cell
// (add, two add-max, max with 0, running-best max) at the card's int32 rate;
// memory is no limit (one subject byte a column of H cells, and on P01008 no
// carry at all: one pass at either height).  A launch's occupancy is set by
// its stage (Stage<H>::bytes(G): 73,984 bytes at H = 32, G = 16, 3 blocks an
// SM) and, at ILP 4, by registers (4 x 32 band values a thread: 255
// registers, spills and 2 blocks an SM with no cap set).

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int A = 32;           // profile columns (padded alphabet)
constexpr int SUBJ = 8;         // subjects a block: an mma's N for the SHARED staging
constexpr int TS = 33;          // shared tile stride of a (row, subject) in int32
constexpr int NEG = -(1 << 30);
constexpr int OUT_OF_ROW = 1 << 30;  // subtracted from lanes past L before the best
constexpr unsigned FULL = 0xffffffffu;

enum Stage { SUBJECT = 0, SHARED = 1 };
enum Scan { SHFL_UP = 0, ROLL = 1 };
enum Variant { V2 = 0, V3 = 1, V4 = 2, V41 = 3 };

// int8_mma.cu's mma_s8 (copied: the build hashes one source a library).
__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t load4(const int8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

// B fragment of the one-hot of residue r (0..31) for a lane with t = lane % 4:
// b0 holds k = 4t..4t+3, b1 k = 16+4t..16+4t+3, one byte each.
__device__ __forceinline__ void one_hot(int r, int t, uint32_t& b0, uint32_t& b1) {
  const uint32_t one = 1u << (8 * (r & 3));
  b0 = (r >> 2) == t ? one : 0u;
  b1 = (r >> 2) == t + 4 ? one : 0u;
}

// One column's S scores for 8 columns (SUBJECT: 8 columns of one subject) or
// 8 subjects (SHARED: one column of 8 subjects): D = A (S x 32) x one-hot.
template <int MT>
__device__ __forceinline__ void stage(int (&d)[MT][4], uint32_t (&af)[MT][4], int r, int t, int c_init) {
  uint32_t b0, b1;
  one_hot(r & (A - 1), t, b0, b1);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    d[mt][0] = d[mt][1] = d[mt][2] = d[mt][3] = c_init;
    mma_s8(d[mt], af[mt][0], af[mt][1], af[mt][2], af[mt][3], b0, b1);
  }
}

// The diagonal's shuffle, as volatile PTX: lane 0 replaces its result, and
// ptxas otherwise sank the shuffle into a branch on the lane (a divergent
// branch, with BRA.DIV checks, every row: on an H100 v4 ran 4x slower than
// v3).
template <int SCAN>
__device__ __forceinline__ int from_left(int x, int src) {
  int y;
  if constexpr (SCAN == SHFL_UP) {
    asm volatile("shfl.sync.up.b32 %0, %1, 1, 0, 0xffffffff;" : "=r"(y) : "r"(x));
  } else {
    asm volatile("shfl.sync.idx.b32 %0, %1, %2, 31, 0xffffffff;" : "=r"(y) : "r"(x), "r"(src));
  }
  return y;
}

// Inclusive max-scan of each chain's x over the warp's lanes, the chains'
// steps interleaved.
template <int SCAN, int ILP>
__device__ __forceinline__ void scan_max(int (&x)[ILP], const int (&src)[5], const bool (&below)[5]) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
#pragma unroll
    for (int i = 0; i < ILP; ++i) {
      if constexpr (SCAN == SHFL_UP) {
        x[i] = max(x[i], __shfl_up_sync(FULL, x[i], 1 << k));
      } else {
        const int y = __shfl_sync(FULL, x[i], src[k]);
        x[i] = max(x[i], below[k] ? NEG : y);
      }
    }
  }
}

// Grid (ceil(B / 8), C); a block of 8 / ILP warps owns subjects 8x .. 8x+7 of
// stack c, warp w the ILP subjects 8x + w*ILP + i.  tile[r][k][j]: row r's
// score of the block's subject k at the chunk's column j.
template <int STAGE, int SCAN, int S, int ILP, bool FOLD>
__global__ void __launch_bounds__(SUBJ / ILP * 32)
sw_rows_lab_kernel(const int8_t* __restrict__ profile,  // (n_strips * S, A)
                   const int8_t* __restrict__ stack,    // (C, B, L)
                   int32_t* __restrict__ carry,         // (C, B, L), unused if n_strips == 1
                   int32_t* __restrict__ out,           // (C, B)
                   int n_strips, int B, int L, int gap) {
  static_assert(STAGE == SHARED || ILP == 1, "a SUBJECT-staged warp scores one subject");
  constexpr int WARPS = SUBJ / ILP;
  constexpr int MT = S / 16;        // m16 tiles a strip
  constexpr int COLS = 32 / WARPS;  // SHARED: chunk columns a warp stages
  __shared__ int32_t tile[S][SUBJ][TS];
  __shared__ int8_t sres[SUBJ][32];  // SHARED: the chunk's residues of the block's subjects

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t cells = static_cast<size_t>(B) * L;
  const int8_t* bucket = stack + blockIdx.y * cells;
  int32_t* cc = carry + (n_strips > 1 ? blockIdx.y * cells : 0);
  int sub[ILP];
  bool act[ILP];
#pragma unroll
  for (int i = 0; i < ILP; ++i) {
    sub[i] = blockIdx.x * SUBJ + w * ILP + i;
    act[i] = sub[i] < B;
  }
  if constexpr (STAGE == SUBJECT) {
    if (!act[0]) return;  // no block barrier in this form
  }
  const bool any = act[0];  // the warp's first subject is its lowest

  int src[5];
  bool below[5];  // hoisted lane masks (ROLL): lanes a rotation by 2^k wraps into
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    src[k] = (lane - (1 << k)) & 31;
    below[k] = lane < (1 << k);
  }
  const int gap_in = FOLD ? 0 : gap;  // added in the cell
  const int c_init = FOLD ? gap : 0;  // folded into the accumulator
  int best[ILP];
#pragma unroll
  for (int i = 0; i < ILP; ++i) best[i] = 0;
  const int n_chunks = (L + 31) / 32;

  for (int strip = 0; strip < n_strips; ++strip) {
    uint32_t af[MT][4];
    const int8_t* prow = profile + static_cast<size_t>(strip) * S * A;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      af[mt][0] = load4(prow + (mt * 16 + g) * A + 4 * t);
      af[mt][1] = load4(prow + (mt * 16 + g + 8) * A + 4 * t);
      af[mt][2] = load4(prow + (mt * 16 + g) * A + 16 + 4 * t);
      af[mt][3] = load4(prow + (mt * 16 + g + 8) * A + 16 + 4 * t);
    }
    const bool has_top = strip > 0, put_bottom = strip + 1 < n_strips;
    // edge[i][0]: the top row's u at the previous chunk's last column;
    // edge[i][r + 1]: row r's.  Column -1 holds H = 0, u = -gap.
    int edge[ILP][S + 1];
#pragma unroll
    for (int i = 0; i < ILP; ++i) {
#pragma unroll
      for (int r = 0; r <= S; ++r) edge[i][r] = -gap;
    }

    for (int ch = 0; ch < n_chunks; ++ch) {
      const int j = ch * 32 + lane;
      const bool valid = j < L;
      int d[MT][4];
      if constexpr (STAGE == SUBJECT) {
        const int res = valid ? bucket[static_cast<size_t>(sub[0]) * L + j] : 0;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          stage<MT>(d, af, __shfl_sync(FULL, res, nt * 8 + g), t, c_init);
          const int col = nt * 8 + 2 * t;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            tile[mt * 16 + g][w][col] = d[mt][0];
            tile[mt * 16 + g][w][col + 1] = d[mt][1];
            tile[mt * 16 + g + 8][w][col] = d[mt][2];
            tile[mt * 16 + g + 8][w][col + 1] = d[mt][3];
          }
        }
        __syncwarp();
      } else {
#pragma unroll
        for (int i = 0; i < ILP; ++i) {
          sres[w * ILP + i][lane] = act[i] && valid ? bucket[static_cast<size_t>(sub[i]) * L + j] : 0;
        }
        __syncthreads();  // the residues are in; every reader of the last tile is done
#pragma unroll
        for (int q = 0; q < COLS; ++q) {
          const int col = w * COLS + q;
          stage<MT>(d, af, sres[g][col], t, c_init);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            tile[mt * 16 + g][2 * t][col] = d[mt][0];
            tile[mt * 16 + g][2 * t + 1][col] = d[mt][1];
            tile[mt * 16 + g + 8][2 * t][col] = d[mt][2];
            tile[mt * 16 + g + 8][2 * t + 1][col] = d[mt][3];
          }
        }
        __syncthreads();  // the tile is in
      }
      if (any) {  // idle warps (every subject past B) still reached both barriers
        const int reb = j * gap;
        const int floor_u = valid ? reb : NEG;
        const int rsub = valid ? reb : OUT_OF_ROW;
        int up[ILP], top_last[ILP], dg[ILP];
#pragma unroll
        for (int i = 0; i < ILP; ++i) {
          up[i] = !(valid && act[i]) ? NEG : has_top ? cc[static_cast<size_t>(sub[i]) * L + j] : reb;
          top_last[i] = __shfl_sync(FULL, up[i], 31);
          dg[i] = edge[i][0];  // lane 0's diagonal for row 0
        }
#pragma unroll
        for (int r = 0; r < S; ++r) {
          int x[ILP];
#pragma unroll
          for (int i = 0; i < ILP; ++i) {
            const int s = tile[r][w * ILP + i][lane] + gap_in;
            const int left = from_left<SCAN>(up[i], src[0]);  // every lane shuffles; lane 0 then drops it
            const int diag = below[0] ? dg[i] : left;
            x[i] = max(max(diag + s, up[i] - gap), floor_u);
            best[i] = max(best[i], x[i] - rsub);
          }
          scan_max<SCAN, ILP>(x, src, below);
#pragma unroll
          for (int i = 0; i < ILP; ++i) {
            dg[i] = edge[i][r + 1];  // row r's carry-in: row r + 1's diagonal at lane 0
            up[i] = max(x[i], dg[i]);
            edge[i][r + 1] = __shfl_sync(FULL, up[i], 31);
          }
        }
#pragma unroll
        for (int i = 0; i < ILP; ++i) {
          edge[i][0] = top_last[i];
          if (put_bottom && valid && act[i]) cc[static_cast<size_t>(sub[i]) * L + j] = up[i];
        }
      }
      if constexpr (STAGE == SUBJECT) __syncwarp();  // the tile is read before the next chunk's staging
    }
  }
#pragma unroll
  for (int i = 0; i < ILP; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) best[i] = max(best[i], __shfl_xor_sync(FULL, best[i], off));
    if (lane == 0 && act[i]) out[blockIdx.y * static_cast<size_t>(B) + sub[i]] = best[i];
  }
}

template <int STAGE, int SCAN, int S, int ILP, bool FOLD>
int launch(const void* profile, const void* stack, void* carry, void* out, int C, int n_strips, int B, int L,
           int gap, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((B + SUBJ - 1) / SUBJ), static_cast<unsigned>(C));
  sw_rows_lab_kernel<STAGE, SCAN, S, ILP, FOLD><<<grid, SUBJ / ILP * 32, 0, stream>>>(
      static_cast<const int8_t*>(profile), static_cast<const int8_t*>(stack), static_cast<int32_t*>(carry),
      static_cast<int32_t*>(out), n_strips, B, L, gap);
  return static_cast<int>(cudaGetLastError());
}

// ---- v4 and v41: K2's warp wavefront (sw_rows.cu), copied ----
namespace wave {

constexpr int CHUNK = 16;          // subject bytes a thread loads at once
constexpr int NEG_S = -(1 << 28);  // the score of a profile row past the query's end
constexpr int MAX_DEVICES = 64;    // devices whose shared-memory attribute is remembered as set

// Threads a block and most bands a pass at band height H: K2's 128 threads
// and G <= 16 at 32-row bands; 256 threads and G <= 32 at 16-row bands, so
// that a block of the widest pass still holds 8 rows.
template <int H> struct Shape {
  static constexpr int BLOCK = H == 16 ? 256 : 128;
  static constexpr int MAX_G = H == 16 ? 32 : 16;
};

// Shared layout of one band: [residue][row] int32, rows padded to stride
// H + 4 (16-byte aligned), and bands 16 bytes apart modulo the 32 banks.
template <int H> struct Stage {
  static constexpr int STRIDE = H + 4;
  static constexpr int BAND = A * STRIDE + 4;
  static constexpr int bytes(int g) { return g * BAND * 4; }
};

// A launch over n_bands bands of H rows and B rows of a bucket, as
// ops/rows_lab.py: wave_schedule computes it.
struct Schedule {
  int g, passes, rows_per_block, blocks, stage_bytes;
};

template <int H, int ILP>
Schedule schedule(int n_bands, int B) {
  int g = 1;
  while (g < n_bands && g < Shape<H>::MAX_G) g <<= 1;
  const int per_block = Shape<H>::BLOCK / g * ILP;
  return {g, (n_bands + g - 1) / g, per_block, (B + per_block - 1) / per_block, Stage<H>::bytes(g)};
}

// The hand-off from thread g - 1 of the group, as volatile PTX that every
// lane issues where it stands: shfl.sync.up within groups of g lanes (clamp
// = (32 - g) << 8), or with ROLL shfl.sync.idx from the hoisted `src`.
template <bool ROLL>
__device__ __forceinline__ int hand_off(int v, int clamp, int src) {
  int r;
  if constexpr (ROLL) {
    asm volatile("shfl.sync.idx.b32 %0, %1, %2, 31, -1;" : "=r"(r) : "r"(v), "r"(src));
  } else {
    asm volatile("shfl.sync.up.b32 %0, %1, 1, %2, -1;" : "=r"(r) : "r"(v), "r"(clamp));
  }
  return r;
}

__device__ __forceinline__ void cell(int& h, int s, int& diag, int& up, int& best, int gap) {
  const int left = h;
  const int x = max(max(diag + s, left - gap), 0);  // independent of up
  const int v = max(x, up - gap);
  diag = left;
  h = v;
  up = v;
  best = max(best, v);
}

// Bytes j0 .. j0 + 15 of a row of L bytes; bytes past L are never read.
__device__ __forceinline__ uint4 load_chunk(const int8_t* row, int j0, int L, bool vec) {
  if (vec) return *reinterpret_cast<const uint4*>(row + j0);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int k = 0; k < CHUNK; ++k) {
    if (j0 + k < L) w[k / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(row[j0 + k])) << (8 * (k % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Profile rows row0 .. row0 + n - 1 into shared memory, [row / H][residue][row % H]
// int32; rows at or past `rows` staged as NEG_S.
template <int H, int NTHREADS>
__device__ __forceinline__ void stage(int32_t* sprof, const int8_t* __restrict__ profile, int row0, int n,
                                      int rows) {
  using S = Stage<H>;
  for (int k = threadIdx.x; k < n * (A / 4); k += NTHREADS) {
    const int r = k / (A / 4), a = (k % (A / 4)) * 4;
    int32_t* dst = sprof + (r / H) * S::BAND + a * S::STRIDE + r % H;
    if (row0 + r < rows) {
      const char4 v = *reinterpret_cast<const char4*>(profile + static_cast<size_t>(row0 + r) * A + a);
      dst[0] = v.x;
      dst[S::STRIDE] = v.y;
      dst[2 * S::STRIDE] = v.z;
      dst[3 * S::STRIDE] = v.w;
    } else {
      dst[0] = dst[S::STRIDE] = dst[2 * S::STRIDE] = dst[3 * S::STRIDE] = NEG_S;
    }
  }
}

// Opaque copy of a pointer: kept in a register rather than rebuilt from
// blockIdx in every column.
template <typename T>
__device__ __forceinline__ T* opaque(T* p) {
  unsigned long long a = reinterpret_cast<unsigned long long>(p);
  asm volatile("mov.b64 %0, %0;" : "+l"(a));
  return reinterpret_cast<T*>(a);
}

// Grid (blocks, C); a block of Shape<H>::BLOCK threads holds BLOCK / g
// groups of g threads, group k of the grid rows k*ILP .. k*ILP + ILP - 1 of
// bucket blockIdx.y.  Rows past B compute on row B - 1's data and store
// nothing.  Bucket c's carry is the c-th (L, B) slice, used only when the
// launch takes several passes.
template <int H, int ILP, bool ROLL>
__global__ void __launch_bounds__(Shape<H>::BLOCK)
sw_rows_wave_lab_kernel(const int8_t* __restrict__ profile,  // (n_bands * H, A)
                        const int8_t* __restrict__ stack,    // (C, B, L)
                        int32_t* __restrict__ carry,         // (C, L, B); unused with one pass
                        int32_t* __restrict__ out,           // (C, B)
                        int n_bands, int B, int L, int gap, int g, int n_pass, bool vec) {
  using S = Stage<H>;
  constexpr int BLOCK = Shape<H>::BLOCK;
  extern __shared__ int4 smem[];
  int32_t* sprof = reinterpret_cast<int32_t*>(smem);
  const size_t cells = static_cast<size_t>(B) * L;
  const int8_t* subj = stack + blockIdx.y * cells;
  int32_t* cbase = n_pass > 1 ? carry + blockIdx.y * cells : carry;
  int32_t* outc = out + blockIdx.y * static_cast<size_t>(B);
  const int rows = n_bands * H;
  const int pass_rows = g * H;
  const int lg = __ffs(g) - 1;             // g is a power of two
  const int gi = threadIdx.x & (g - 1);    // this thread's band in the pass
  const int lane = threadIdx.x & 31;
  const int clamp = (32 - g) << 8;                             // shfl.sync.up in groups of g lanes
  const int src = (lane & ~(g - 1)) | ((lane - 1) & (g - 1));  // ROLL: the rotate's source, hoisted
  const int b0 = (blockIdx.x * (BLOCK >> lg) + (threadIdx.x >> lg)) * ILP;
  bool active[ILP];
  const int8_t* row[ILP];
  int32_t* cc[ILP];
#pragma unroll
  for (int i = 0; i < ILP; ++i) {
    active[i] = b0 + i < B;
    const int bb = active[i] ? b0 + i : B - 1;
    row[i] = opaque(subj + static_cast<size_t>(bb) * L);
    cc[i] = opaque(cbase + bb);
  }

  for (int pass = 0; pass < n_pass; ++pass) {
    const int row0 = pass * pass_rows;
    const int nb = min(pass_rows, rows - row0) / H;  // bands in this pass
    __syncthreads();  // every reader of the previous pass's profile is done
    stage<H, BLOCK>(sprof, profile, row0, nb * H, rows);
    __syncthreads();
    const int32_t* bprof = sprof + gi * S::BAND;
    const bool real = gi < nb;
    const bool first = gi == 0;
    const bool last = gi == nb - 1;
    const bool top_in = first && pass > 0;
    const bool put_bottom = last && pass + 1 < n_pass;
    const int steps = L + nb - 1;

    int h[ILP][H];
    // What this thread hands to thread g + 1, a row each: the residue of its
    // last column, its band's bottom H there and the row's running best.
    int best[ILP], top_prev[ILP], send_res[ILP], send_h[ILP], send_cb[ILP], top_next[ILP];
    // The first thread's row bytes, a chunk ahead.
    uint4 cur[ILP], nxt[ILP];
#pragma unroll
    for (int i = 0; i < ILP; ++i) {
#pragma unroll
      for (int r = 0; r < H; ++r) h[i][r] = 0;
      best[i] = top_prev[i] = send_res[i] = send_h[i] = send_cb[i] = 0;
      cur[i] = nxt[i] = make_uint4(0u, 0u, 0u, 0u);
      if (first) nxt[i] = load_chunk(row[i], 0, L, vec);
      top_next[i] = top_in ? cc[i][0] : 0;  // column t + 1's top
    }

    for (int t0 = 0; t0 < steps; t0 += CHUNK) {
      if (first) {
#pragma unroll
        for (int i = 0; i < ILP; ++i) {
          cur[i] = nxt[i];
          if (t0 + CHUNK < L) nxt[i] = load_chunk(row[i], t0 + CHUNK, L, vec);
        }
      }
#pragma unroll 1
      for (int q = 0; q < CHUNK / 4; ++q) {
        uint32_t word[ILP];
#pragma unroll
        for (int i = 0; i < ILP; ++i) word[i] = q == 0 ? cur[i].x : q == 1 ? cur[i].y : q == 2 ? cur[i].z : cur[i].w;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int t = t0 + 4 * q + k;
          if (t < steps) {  // the same for every lane of the block
            int r_res[ILP], r_h[ILP], r_cb[ILP];
#pragma unroll
            for (int i = 0; i < ILP; ++i) r_res[i] = hand_off<ROLL>(send_res[i], clamp, src);
#pragma unroll
            for (int i = 0; i < ILP; ++i) r_h[i] = hand_off<ROLL>(send_h[i], clamp, src);
#pragma unroll
            for (int i = 0; i < ILP; ++i) r_cb[i] = hand_off<ROLL>(send_cb[i], clamp, src);
            if (first) {
#pragma unroll
              for (int i = 0; i < ILP; ++i) {
                r_res[i] = (word[i] >> (8 * k)) & (A - 1);
                r_h[i] = top_next[i];
                r_cb[i] = 0;
                if (top_in && t + 1 < L) top_next[i] = cc[i][static_cast<size_t>(t + 1) * B];
              }
            }
            const int c = t - gi;
            if (real && c >= 0 && c < L) {
              const int4* s4[ILP];
              int diag[ILP], up[ILP];
#pragma unroll
              for (int i = 0; i < ILP; ++i) {
                s4[i] = reinterpret_cast<const int4*>(bprof + r_res[i] * S::STRIDE);
                diag[i] = top_prev[i];
                up[i] = r_h[i];
              }
#pragma unroll
              for (int p = 0; p < H / 4; ++p) {
#pragma unroll
                for (int i = 0; i < ILP; ++i) {  // the ILP rows' cells interleaved, row by row
                  const int4 s = s4[i][p];
                  cell(h[i][4 * p + 0], s.x, diag[i], up[i], best[i], gap);
                  cell(h[i][4 * p + 1], s.y, diag[i], up[i], best[i], gap);
                  cell(h[i][4 * p + 2], s.z, diag[i], up[i], best[i], gap);
                  cell(h[i][4 * p + 3], s.w, diag[i], up[i], best[i], gap);
                }
              }
#pragma unroll
              for (int i = 0; i < ILP; ++i) {
                if (put_bottom && active[i]) cc[i][static_cast<size_t>(c) * B] = h[i][H - 1];
                top_prev[i] = r_h[i];
                const int cb = max(best[i], r_cb[i]);
                if (last && active[i] && c == L - 1) outc[b0 + i] = pass > 0 ? max(outc[b0 + i], cb) : cb;
                send_h[i] = h[i][H - 1];
                send_cb[i] = cb;
              }
            }
#pragma unroll
            for (int i = 0; i < ILP; ++i) send_res[i] = r_res[i];
          }
        }
      }
    }
  }
}

// Let the (H, ILP, ROLL) instantiation take its largest stage: once a
// device (setting it twice from two threads is harmless).
template <int H, int ILP, bool ROLL>
cudaError_t allow_stage(int device) {
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (device < MAX_DEVICES && smem_set[device].load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(sw_rows_wave_lab_kernel<H, ILP, ROLL>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Stage<H>::bytes(Shape<H>::MAX_G));
  if (err == cudaSuccess && device < MAX_DEVICES) smem_set[device].store(true, std::memory_order_relaxed);
  return err;
}

template <int H, int ILP, bool ROLL>
int launch(int device, cudaStream_t stream, const void* profile, const void* stack, void* carry, void* out, int C,
           int n_bands, int B, int L, int gap) {
  const cudaError_t err = allow_stage<H, ILP, ROLL>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Schedule s = schedule<H, ILP>(n_bands, B);
  // Every row of every bucket is 16-byte aligned when the stack is and L % 16 == 0.
  const bool vec = L % CHUNK == 0 && reinterpret_cast<uintptr_t>(stack) % CHUNK == 0;
  const dim3 grid(static_cast<unsigned>(s.blocks), static_cast<unsigned>(C));
  sw_rows_wave_lab_kernel<H, ILP, ROLL><<<grid, Shape<H>::BLOCK, s.stage_bytes, stream>>>(
      static_cast<const int8_t*>(profile), static_cast<const int8_t*>(stack), static_cast<int32_t*>(carry),
      static_cast<int32_t*>(out), n_bands, B, L, gap, s.g, s.passes, vec);
  return static_cast<int>(cudaGetLastError());
}

// The launch's schedule into sched[0..4] and its blocks an SM, by the
// runtime's occupancy calculator (registers, threads, stage), into sched[5].
template <int H, int ILP, bool ROLL>
int describe(int device, int n_bands, int B, int* sched) {
  const cudaError_t err = allow_stage<H, ILP, ROLL>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Schedule s = schedule<H, ILP>(n_bands, B);
  sched[0] = s.g;
  sched[1] = s.passes;
  sched[2] = s.rows_per_block;
  sched[3] = s.blocks;
  sched[4] = s.stage_bytes;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &sched[5], sw_rows_wave_lab_kernel<H, ILP, ROLL>, Shape<H>::BLOCK, s.stage_bytes));
}

}  // namespace wave

// The rebuilt (variant, strip, ilp) instantiations: (H, ILP, ROLL).
#define SW_ROWS_WAVE_LAB(X) X(V4, 32, 2, 32, 2, false) X(V4, 32, 4, 32, 4, false) \
  X(V41, 16, 1, 16, 1, true) X(V41, 32, 1, 32, 1, true)

}  // namespace

extern "C" {

// K10 for a (C, B, L) stack on `stream` of `device`: variant 0 = v2, 1 = v3
// (the warp-scan template, `ilp` 1), 2 = v4, 3 = v41 (K2's warp wavefront, `ilp`
// rows a thread group), with strip (band) height `strip`.  `profile` is
// (n_strips * strip, 32) int8; `carry` holds C * B * L int32 when n_strips >
// 1 for v2 and v3, and when the launch takes more than one pass for v4 and
// v41 (sw_rows_lab_schedule).  Returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a (variant, strip, ilp) with no instantiation.
int sw_rows_lab_launch(const void* profile, const void* stack, void* carry, void* out, int C, int n_strips, int B,
                       int L, int gap, int variant, int strip, int ilp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SW_ROWS_LAB(STAGE, SCAN, S, ILP, FOLD) \
  launch<STAGE, SCAN, S, ILP, FOLD>(profile, stack, carry, out, C, n_strips, B, L, gap, st)
  if (variant == V2 && ilp == 1 && strip == 16) return SW_ROWS_LAB(SUBJECT, SHFL_UP, 16, 1, false);
  if (variant == V2 && ilp == 1 && strip == 32) return SW_ROWS_LAB(SUBJECT, SHFL_UP, 32, 1, false);
  if (variant == V3 && ilp == 1 && strip == 16) return SW_ROWS_LAB(SHARED, SHFL_UP, 16, 1, false);
  if (variant == V3 && ilp == 1 && strip == 32) return SW_ROWS_LAB(SHARED, SHFL_UP, 32, 1, false);
#undef SW_ROWS_LAB
#define SW_ROWS_WAVE_CASE(V, STRIP, I, H, ILP, ROLL)                                                        \
  if (variant == V && strip == STRIP && ilp == I)                                                           \
    return wave::launch<H, ILP, ROLL>(device, st, profile, stack, carry, out, C, n_strips, B, L, gap);
  SW_ROWS_WAVE_LAB(SW_ROWS_WAVE_CASE)
#undef SW_ROWS_WAVE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// v4's and v41's launch for a profile of n_strips bands of `strip` rows on
// a bucket of B rows: sched[0..5] = G, passes, rows a block, blocks a
// bucket, stage bytes and blocks an SM (the runtime's occupancy).  Returns 0,
// a CUDA error, or cudaErrorInvalidValue for v2, v3 or an uninstantiated
// (variant, strip, ilp).
int sw_rows_lab_schedule(int variant, int strip, int ilp, int n_strips, int B, int device, int* sched) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
#define SW_ROWS_WAVE_CASE(V, STRIP, I, H, ILP, ROLL) \
  if (variant == V && strip == STRIP && ilp == I) return wave::describe<H, ILP, ROLL>(device, n_strips, B, sched);
  SW_ROWS_WAVE_LAB(SW_ROWS_WAVE_CASE)
#undef SW_ROWS_WAVE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* sw_rows_lab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
