// Row-parallel lab kernels for Hopper (sm_90a): one query against row-major
// (C, B, L) stacks of subjects, linear gaps, exact int32, one WARP a subject.
//
// Replaces K10, the four row-parallel lab kernels of tools/pallas_lab.py, as
// compile-time variants of one kernel, sw_rows_lab_kernel<STAGE, SCAN, S,
// ILP, FOLD>, behind one C entry point, sw_rows_lab_launch:
//  * v2, sw_v2 (:102, kernel _v2_kernel :44): STAGE = SUBJECT, SCAN =
//    SHFL_UP, S = 16 or 32.  Each warp stages its own subject's scores: an
//    mma's 8 columns are 8 consecutive columns of that subject (swtpu's
//    per-subject block-diagonal lhs, expand_profile_blockdiag).  The gap is
//    added in the cell (s + gap), as v2 adds it to s_row.
//  * v3, sw_v3 (:206, _v3_kernel :144): STAGE = SHARED, SCAN = SHFL_UP, S =
//    16 or 32.  A block of 8 warps is v3's sub-batch of 8 subjects and stages
//    its chunk together: one A fragment in registers serves the 8 subjects,
//    an mma's 8 columns are one column of the 8 subjects, and the scores land
//    in DP order in a (S, 8, 32) shared tile, as v3's s_ref (strip, tile_b, L).
//  * v4, sw_v4 (:304, _v4_kernel :236): v3 with ILP = 2 or 4 subjects a warp
//    (a block of 8 / ILP warps still stages 8 subjects), their chains
//    interleaved step by step so that one chain's shuffles overlap another's,
//    and the gap folded into the mma's accumulator; S = 32.
//  * v41, sw_v41 (:389, _v41_kernel :334): v3 with the gap folded and SCAN =
//    ROLL: each scan step is a rotate, __shfl_sync(x, (lane - s) & 31), then a
//    select of -2^30 under the masks lane < s, hoisted out of the row loop
//    (pltpu.roll plus hoisted masks).  v2-v4's jnp.pad shift is
//    __shfl_up_sync, which leaves lanes < s their own value: already right
//    for a max, so it needs no mask.
// Every variant computes K2's contract (sw_rows.cu; xla_sw.sw_score_bucket):
// for each subject row, the Smith-Waterman maximum of the (n_strips * S, 32)
// int8 profile against the row's L residues (pads PAD_SUBJECT = 25).  A strip
// height changes no score; the wrapper pads the profile to whole strips with
// PAD_SCORE rows, which cannot raise a maximum.
//
// Shared form (swtpu's intra-sequence u-space form, redesigned for a warp).
// With u[j] = H[j] + j*gap, a query row is t = max(j*gap, diag_u + s + gap,
// u_prev - gap), then u = the running max of t along the row, and the best H
// is the max of t - j*gap.  One warp owns a subject row; its 32 lanes hold 32
// consecutive columns (a chunk).  The query runs in strips of S rows; within
// a strip the warp walks the row's chunks left to right and, inside a chunk,
// steps the S rows:
//  * u_prev is the lane's own u of the row above; diag_u is the lane to the
//    left's (a shuffle), at lane 0 the previous chunk's last column, or -gap
//    at column 0;
//  * then an inclusive max-scan over the 32 lanes, five shuffle steps, and a
//    max with the row's carry-in, the previous chunk's last u of the same row
//    (in u-space a plain max, no gap term);
//  * best = max(best, t - j*gap), before the scan.
// The previous chunk's last column (S + 1 values: the strip's top row and
// its S rows) lives in registers, the same in every lane.  The strip's
// bottom row of u goes to a per-subject global carry, one int32 a column,
// row-major per subject (a warp's 32 columns are one coalesced 128-byte
// access), read as the next strip's top row; the first strip's top row is
// j*gap (H = 0).  In a tail chunk, lanes past L take a floor of -2^30 (so
// they feed nothing to the lanes left of them: a scan only moves right) and
// subtract 2^30 for the best, so they never reach it.
//
// Score staging (the MXU's counterpart): mma.sync.m16n8k32.s8, A = 16
// profile rows x 32 residues straight from the profile's row-major bytes (in
// registers for the whole strip), B = the one-hot of 8 columns (lane l builds
// bytes (res == k) for column l/4, k = 4(l%4) + 0..3 and + 16), C = 0 or, where
// the gap is folded, gap: exact in int32 for any gap (swtpu folds it into the
// int8 lhs, exact only while 15 + gap <= 127).  The (S, 32) int32 scores go
// to the shared tile and each lane reads its own column back.
//
// What bounds it: int32 operations.  The work is K2's: about 6 operations a
// padded cell.  This form spends about 20 instructions a cell and lane: the
// scan's 5 shuffles and 5 maxes, the diagonal's shuffle and lane-0 select,
// the carry-in max and the broadcast of lane 31, on top of K2's cell; so it
// should lose to K2 (one thread a subject, ~3.5 instructions a cell) wherever
// K2 fills the card, and can only win where a group has too few subjects to
// fill it (K2 gives a 64-row group one block of 64 threads; here 64 warps).
// Memory: one subject byte a cell column, and at S = 32 a carry of 8 bytes a
// column a strip (16 at S = 16), mostly in L2.  The staging costs S / 16 x 4
// mma a warp a chunk, and two block barriers a chunk where it is SHARED.

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

}  // namespace

extern "C" {

// K10 for a (C, B, L) stack on `stream` of `device`: variant 0 = v2, 1 = v3,
// 2 = v4, 3 = v41, with strip height `strip` and, for v4, `ilp` subjects a
// warp.  `profile` is (n_strips * strip, 32) int8; `carry` holds C * B * L
// int32 when n_strips > 1.  Returns cudaGetLastError() (0 = launched), or
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
  if (variant == V4 && ilp == 2 && strip == 32) return SW_ROWS_LAB(SHARED, SHFL_UP, 32, 2, true);
  if (variant == V4 && ilp == 4 && strip == 32) return SW_ROWS_LAB(SHARED, SHFL_UP, 32, 4, true);
  if (variant == V41 && ilp == 1 && strip == 16) return SW_ROWS_LAB(SHARED, ROLL, 16, 1, true);
  if (variant == V41 && ilp == 1 && strip == 32) return SW_ROWS_LAB(SHARED, ROLL, 32, 1, true);
#undef SW_ROWS_LAB
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* sw_rows_lab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
