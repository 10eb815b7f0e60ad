// Row-parallel lab kernels for Hopper (sm_90a): one query against row-major
// (C, B, L) stacks of subjects, linear gaps, exact int32.
//
// Replaces K10, the four row-parallel lab kernels of tools/pallas_lab.py,
// behind one C entry point, sw_rows_lab_launch, in one design:
// sw_rows_wave_lab_kernel<H, ILP, ROLL, BLOCK>, a copy of K2's warp wavefront
// (sw_rows.cu: wave_rows<G>), G threads a subject row, the schedule the row
// kernel ships.  A lab kernel that does not run the shipping schedule
// measures nothing about it, so each TPU knob became a knob of K2's schedule,
// timed beside K2 in the lab.  Every variant computes K2's contract
// (sw_rows.cu; xla_sw.sw_score_bucket): for each subject row, the
// Smith-Waterman maximum of the (n_bands * H, 32) int8 profile against the
// row's L residues (pads PAD_SUBJECT = 25).  A band height changes no score;
// the wrapper pads the profile to whole bands with PAD_SCORE rows, which
// cannot raise a maximum.
//
// The wavefront.  Copied from sw_rows.cu, not shared (that file does not
// move): the Stage<H> shared profile ([band][residue][row] int32, row stride
// H + 4), the first thread's 16-byte chunk loads of the row, one chunk ahead,
// the cell, the volatile-PTX hand-off, and the carry through global memory
// only between passes, column-major across the rows.  G threads of a warp
// score a group of rows; thread g holds band g of the pass (H query rows) in
// registers and at step t computes column t - g, handing its band's bottom H,
// the column's residue and the running best to thread g + 1 by one shuffle
// each.  A pass is G bands; a block of BLOCK threads stages them once for
// its BLOCK / G x ILP rows.  G is a runtime argument: the fewest power of two
// at least the bands, at most MAX_G (16 at 32-row bands, as K2; 32 at 16-row
// bands), passes ceil(bands / G) (Schedule here; ops/rows_lab.py:
// wave_schedule, which the tests pin, computes the same).
//
// What each TPU knob became:
//  * v2, sw_v2 (tools/pallas_lab.py:102, kernel _v2_kernel :44): each subject
//    its own copy of the profile (the per-subject block-diagonal lhs) became
//    a block of ONE warp that stages its own pass: BLOCK = 32, 32 / G rows a
//    stage (2 at H = 32, G = 16; 1 at H = 16, G = 32).  A small group spreads
//    over 4x or 8x the SMs of K2's 8-row blocks; the stage (73,984 or 82,432
//    bytes) then allows 3 or 2 blocks, so 3 or 2 warps, an SM.
//  * v3, sw_v3 (:206, _v3_kernel :144): one lhs shared by a tile of 16
//    subjects (tile_b) became one staged pass shared by 16 rows: BLOCK = 256
//    at H = 32 (G = 16) and 512 at H = 16 (G = 32).  The stage is K2's or v41
//    S16's, for twice the rows, so at the same shared memory it buys 24 or 32
//    warps an SM where K2 has 12, if registers allow: its launch bound asks
//    for the blocks the stage allows (3 at H = 32: 80 registers; 2 at H = 16:
//    64), and ptxas spills what does not fit.
//  * v4, sw_v4 (:304, _v4_kernel :236), "interleaved independent DP chains
//    hide the vector unit's latency": ILP = 2 or 4 subject rows a thread
//    group at H = 32, BLOCK = 128.  Thread g holds band g of ILP rows; their
//    cells are interleaved row by row and their hand-offs step by step, so
//    one chain's shuffles and max chains overlap another's.  A block still
//    stages one pass, for 128 / G x ILP rows: it trades blocks (a 64-row
//    group gets 8 / ILP at G = 16) for independent chains.
//  * v41, sw_v41 (:389, _v41_kernel :334), "the shift as a rotate under
//    hoisted masks": ROLL, the hand-off as shfl.sync.idx from a source lane
//    hoisted out of the column loop, (lane & ~(G-1)) | ((lane - 1) & (G-1)),
//    where K2 uses shfl.sync.up; the group's first thread takes its own
//    values by the select on `first`, hoisted to the pass.  At H = 16 the
//    bands are 16 rows and G runs up to 32 (P01008's 480-row profile: 30
//    bands, one pass at G = 32, against K2's 15 at G = 16), half a step's
//    cell chain, in 256-thread blocks: 8 rows a stage, as K2.  At H = 32 it
//    is K2's shape.
//  * The gap fold has no counterpart.  The TPU's u-space cell adds the gap
//    to the score (diag_u + s + gap), which v4 and v41 folded into the
//    staging.  In K2's H-space cell the diagonal takes no gap, and the gap
//    terms, left - gap and up - gap, are each the add of an add-max
//    (VIADDMNMX: an add, then a max, one issue slot) with the gap as its
//    operand: there is nothing to fold.  chip_smoke.py's build line counts
//    the column loops' VIADDMNMX and IADD3 a cell (PERF.md).
// Every hand-off is volatile PTX issued by every lane where it stands: ptxas
// once sank a shuffle into a branch on the lane and made a kernel 4x slower.
//
// What bounds them: int32 operations, K2's ~6 a padded cell (add, two
// add-max, max with 0, running-best max) at the card's int32 rate; memory is
// no limit (one subject byte a column of H cells, and on P01008 no carry at
// all: one pass at either height).  A launch's occupancy is set by its stage
// (Stage<H>::bytes(G): 73,984 bytes at H = 32, G = 16, 3 blocks an SM;
// 82,432 at H = 16, G = 32, 2 blocks), by its block (v2's one warp), and by
// registers (v3's launch bound; v4's 2 x 32 and 4 x 32 band values a thread).

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int A = 32;  // profile columns (padded alphabet)

enum Variant { V2 = 0, V3 = 1, V4 = 2, V41 = 3 };

// ---- K2's warp wavefront (sw_rows.cu), copied ----
namespace wave {

constexpr int CHUNK = 16;          // subject bytes a thread loads at once
constexpr int NEG_S = -(1 << 28);  // the score of a profile row past the query's end
constexpr int MAX_DEVICES = 64;    // devices whose shared-memory attribute is remembered as set
constexpr int SM_SHARED = 233472;    // an H100 SM's shared memory
constexpr int BLOCK_RESERVED = 1024;  // shared memory the runtime reserves a block

// Shared layout of one band: [residue][row] int32, rows padded to stride
// H + 4 (16-byte aligned), and bands 16 bytes apart modulo the 32 banks.
template <int H> struct Stage {
  static constexpr int STRIDE = H + 4;
  static constexpr int BAND = A * STRIDE + 4;
  static constexpr int bytes(int g) { return g * BAND * 4; }
};

// Most bands a pass at band height H (K2's 16 at 32-row bands, 32 at 16-row
// bands), and the blocks an SM that the widest pass's stage allows (3 at
// H = 32, 2 at H = 16).  Static members, not constexpr calls: the launch
// bound below reads them.
template <int H> struct Shape {
  static constexpr int MAX_G = H == 16 ? 32 : 16;
  static constexpr int STAGE_BLOCKS = SM_SHARED / (4 * MAX_G * Stage<H>::BAND + BLOCK_RESERVED);
};

// A launch over n_bands bands of H rows and B rows of a bucket, as
// ops/rows_lab.py: wave_schedule computes it.
struct Schedule {
  int g, passes, rows_per_block, blocks, stage_bytes;
};

template <int H, int ILP, int BLOCK>
Schedule schedule(int n_bands, int B) {
  int g = 1;
  while (g < n_bands && g < Shape<H>::MAX_G) g <<= 1;
  const int per_block = BLOCK / g * ILP;
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

// Grid (blocks, C); a block of BLOCK threads holds BLOCK / g groups of g
// threads, group k of the grid rows k*ILP .. k*ILP + ILP - 1 of bucket
// blockIdx.y.  Rows past B compute on row B - 1's data and store nothing.
// Bucket c's carry is the c-th (L, B) slice, used only when the launch takes
// several passes.  The launch bound: v3's 16 rows a stage (at the widest
// pass) are there to buy warps an SM, so it asks ptxas for as many blocks
// as the stage allows (3 at H = 32: 80 registers a thread; 2 at H = 16: 64).
// Every other block asks for none (0), as K2's __launch_bounds__(BLOCK): a
// minimum of 1 is not the same to ptxas, which then gave v4 ILP 2 185
// registers instead of 168, and 2 blocks an SM instead of 3, on an H100.
template <int H, int ILP, bool ROLL, int BLOCK>
__global__ void __launch_bounds__(BLOCK, BLOCK / Shape<H>::MAX_G == 16 ? Shape<H>::STAGE_BLOCKS : 0)
sw_rows_wave_lab_kernel(const int8_t* __restrict__ profile,  // (n_bands * H, A)
                        const int8_t* __restrict__ stack,    // (C, B, L)
                        int32_t* __restrict__ carry,         // (C, L, B); unused with one pass
                        int32_t* __restrict__ out,           // (C, B)
                        int n_bands, int B, int L, int gap, int g, int n_pass, bool vec) {
  using S = Stage<H>;
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

// Let the (H, ILP, ROLL, BLOCK) instantiation take its largest stage: once
// a device and instantiation (setting it twice from two threads is
// harmless).
template <int H, int ILP, bool ROLL, int BLOCK>
cudaError_t allow_stage(int device) {
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (device < MAX_DEVICES && smem_set[device].load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(sw_rows_wave_lab_kernel<H, ILP, ROLL, BLOCK>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               Stage<H>::bytes(Shape<H>::MAX_G));
  if (err == cudaSuccess && device < MAX_DEVICES) smem_set[device].store(true, std::memory_order_relaxed);
  return err;
}

template <int H, int ILP, bool ROLL, int BLOCK>
int launch(int device, cudaStream_t stream, const void* profile, const void* stack, void* carry, void* out, int C,
           int n_bands, int B, int L, int gap) {
  const cudaError_t err = allow_stage<H, ILP, ROLL, BLOCK>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Schedule s = schedule<H, ILP, BLOCK>(n_bands, B);
  // Every row of every bucket is 16-byte aligned when the stack is and L % 16 == 0.
  const bool vec = L % CHUNK == 0 && reinterpret_cast<uintptr_t>(stack) % CHUNK == 0;
  const dim3 grid(static_cast<unsigned>(s.blocks), static_cast<unsigned>(C));
  sw_rows_wave_lab_kernel<H, ILP, ROLL, BLOCK><<<grid, BLOCK, s.stage_bytes, stream>>>(
      static_cast<const int8_t*>(profile), static_cast<const int8_t*>(stack), static_cast<int32_t*>(carry),
      static_cast<int32_t*>(out), n_bands, B, L, gap, s.g, s.passes, vec);
  return static_cast<int>(cudaGetLastError());
}

// The launch's schedule into sched[0..4] and its blocks an SM, by the
// runtime's occupancy calculator (registers, threads, stage), into sched[5].
template <int H, int ILP, bool ROLL, int BLOCK>
int describe(int device, int n_bands, int B, int* sched) {
  const cudaError_t err = allow_stage<H, ILP, ROLL, BLOCK>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Schedule s = schedule<H, ILP, BLOCK>(n_bands, B);
  sched[0] = s.g;
  sched[1] = s.passes;
  sched[2] = s.rows_per_block;
  sched[3] = s.blocks;
  sched[4] = s.stage_bytes;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &sched[5], sw_rows_wave_lab_kernel<H, ILP, ROLL, BLOCK>, BLOCK, s.stage_bytes));
}

}  // namespace wave

// The (variant, strip, ilp) instantiations: (H, ILP, ROLL, BLOCK).  v2: one
// warp a block; v3: 16 rows a stage; v4: ILP rows a thread group; v41: the
// rotate hand-off, 8 rows a stage.
#define SW_ROWS_WAVE_LAB(X)                                                                                 \
  X(V2, 16, 1, 16, 1, false, 32) X(V2, 32, 1, 32, 1, false, 32) X(V3, 16, 1, 16, 1, false, 512)            \
  X(V3, 32, 1, 32, 1, false, 256) X(V4, 32, 2, 32, 2, false, 128) X(V4, 32, 4, 32, 4, false, 128)          \
  X(V41, 16, 1, 16, 1, true, 256) X(V41, 32, 1, 32, 1, true, 128)

}  // namespace

extern "C" {

// K10 for a (C, B, L) stack on `stream` of `device`: variant 0 = v2, 1 = v3,
// 2 = v4, 3 = v41, band height `strip`, `ilp` rows a thread group (v4).
// `profile` is (n_strips * strip, 32) int8; `carry` holds C * B * L int32
// when the launch takes more than one pass (sw_rows_lab_schedule).  Returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a
// (variant, strip, ilp) with no instantiation.
int sw_rows_lab_launch(const void* profile, const void* stack, void* carry, void* out, int C, int n_strips, int B,
                       int L, int gap, int variant, int strip, int ilp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SW_ROWS_WAVE_CASE(V, STRIP, I, H, ILP, ROLL, BLOCK)                                                 \
  if (variant == V && strip == STRIP && ilp == I)                                                           \
    return wave::launch<H, ILP, ROLL, BLOCK>(device, st, profile, stack, carry, out, C, n_strips, B, L, gap);
  SW_ROWS_WAVE_LAB(SW_ROWS_WAVE_CASE)
#undef SW_ROWS_WAVE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch for a profile of n_strips bands of `strip` rows on a bucket of B
// rows: sched[0..5] = G, passes, rows a block, blocks a bucket, stage bytes
// and blocks an SM (the runtime's occupancy).  Returns 0, a CUDA error, or
// cudaErrorInvalidValue for an uninstantiated (variant, strip, ilp).
int sw_rows_lab_schedule(int variant, int strip, int ilp, int n_strips, int B, int device, int* sched) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
#define SW_ROWS_WAVE_CASE(V, STRIP, I, H, ILP, ROLL, BLOCK)                                                 \
  if (variant == V && strip == STRIP && ilp == I)                                                           \
    return wave::describe<H, ILP, ROLL, BLOCK>(device, n_strips, B, sched);
  SW_ROWS_WAVE_LAB(SW_ROWS_WAVE_CASE)
#undef SW_ROWS_WAVE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* sw_rows_lab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
