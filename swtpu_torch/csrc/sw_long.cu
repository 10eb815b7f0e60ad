// Smith-Waterman scores of one query against a list of long database
// sequences, each scored with the roles swapped: the sequence down the rows
// of the DP, the query along its columns.  Linear or affine (Gotoh) gaps,
// exact int32.
//
// Replaces no TPU kernel: swtpu scores a prefiltered search's candidates on
// its wavefront kernel (swtpu/ops/wave_sw.py::_wave_kernel) in padded width
// classes, and so does this package's K1 (csrc/sw_wave.cu) for the
// candidates of at most 992 residues.  It was added for the longer ones.  On
// K1 a lane's group walks every column of its class's width in turn, the
// query's 32-row bands in passes of at most 16: a class of a few hundred
// candidates of 3,000-8,000 residues is a few hundred lanes (one warp on each
// busy scheduler) and a serial chain of 8,000 columns a pass, at 1% of the
// card's rate.  In K1's orientation no schedule goes below the longest
// candidate's length in serial steps.  The score is symmetric: swapping the
// two sequences swaps E and F under the same costs, and the cell (row r,
// column c) still reads matrix[query[c]][sequence[r]], so no symmetry of the
// matrix is assumed.
//
// What bounds it on this card.  Not the work: a search's long candidates are
// ~0.3-0.5 G cells, ~0.1 ms at the int32 issue rate.  The serial chain is the
// bound: a band's column waits on the band above it, and each of its 32 rows
// on the row above (one DPX instruction a row under either gap model: for
// Gotoh, F(r) = max(F(r-1) - ext, X(r-1) - open), with X the cell's max of
// 0, diag + s and E, since open >= ext).
//
// Design: one block a sequence, a block-deep wavefront.
//  * Thread b of the block's 128 holds band b of a pass: 32 sequence rows in
//    registers (H, and E under affine gaps).  A pass is 4,096 rows, so a
//    sequence of 8,000 residues is two passes of (query length + 172)
//    steps, against K1's 8,000 columns a pass.
//  * At step t thread b computes column t - lag(b).  Within a warp the band's
//    bottom H (and F) goes to the next thread by a shuffle every step (lag:
//    one step a band).  Between warps it goes through a ring in shared
//    memory, and the block's active warps meet at a barrier once every CHUNK
//    steps: warp w + 1 trails warp w by CHUNK + 31 steps, so what its first
//    thread reads at a step was written in an earlier chunk.
//  * A pass boundary goes through a global carry, one slot a query column:
//    the pass's last band writes its bottom row, the next pass's first band
//    reads it as its top.
//  * The band's scores stay on chip: each pass, thread b stages its own rows'
//    table, [query letter][row] = matrix[letter][sequence[row]], as int8 in
//    shared memory from the sequence's residues and the 25 x 32 matrix (staged
//    once a block), laid out [letter][half][band] in 16-byte units, so the two
//    16-byte loads of a step hit distinct banks whatever letters the threads
//    read.  Rows past the sequence's end score -128: they lie below every real
//    row and can raise no maximum.
//  * The query is read from device memory (L1), each thread at its own
//    column, one step ahead; the sequence's residues from the database's
//    resident buffer at its offset, with no gather and no padding.
//  * Warps with no band in a pass skip it; every thread keeps its running
//    best, and the block's maximum is the score.
//  * Shared memory is 102 KB a block (25 letters x 32 rows x 128 bands), two
//    blocks an SM; the caller orders the sequences longest first, so the
//    longest start first.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int A = 32;                   // columns of the matrix table: the padded alphabet
constexpr int NL = 25;                  // query letters: the alphabet
constexpr int RB = 32;                  // sequence rows a band (a thread)
constexpr int LBLOCK = 128;             // threads (bands) a block
constexpr int WARPS = LBLOCK / 32;
constexpr int PASS_ROWS = LBLOCK * RB;  // 4,096 rows a pass
constexpr int CHUNK = 16;               // steps between the active warps' barriers
constexpr int LAG = CHUNK + 31;         // steps warp w + 1's first thread trails warp w's
constexpr int RING = 2 * CHUNK;         // ring slots a warp boundary: two chunks of columns
constexpr int NEG = -(1 << 30);         // minus infinity of the affine E and F boundaries
constexpr int MAX_DEVICES = 64;

template <bool AFFINE> struct Slot { using T = int32_t; };  // a bottom H
template <> struct Slot<true> { using T = int2; };           // a bottom (H, F)

constexpr int TAB_UNITS = NL * 2 * LBLOCK;  // 16-byte units of the band tables
template <bool AFFINE>
constexpr int smem_bytes() {
  return TAB_UNITS * 16 + (WARPS - 1) * RING * static_cast<int>(sizeof(typename Slot<AFFINE>::T)) + NL * A;
}

// __shfl_up_sync(~0u, v, 1) as volatile PTX: every lane issues it where it
// stands in the source.
__device__ __forceinline__ int shfl_up1(int v) {
  int r;
  asm volatile("shfl.sync.up.b32 %0, %1, 1, 0, -1;" : "=r"(r) : "r"(v));
  return r;
}

// Byte i of w, sign-extended (one PRMT).
__device__ __forceinline__ int sbyte(uint32_t w, int i) {
  uint32_t r;
  asm("prmt.b32 %0, %1, 0, %2;" : "=r"(r) : "r"(w), "r"(0x8880u + 0x1111u * i));
  return static_cast<int>(r);
}

// Query letter c, kept inside the table (the alphabet has 25).
__device__ __forceinline__ int letter(const int8_t* query, int c) {
  return min(static_cast<int>(static_cast<uint8_t>(query[c])), NL - 1);
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(threads) : "memory");
}

// The band's 32 rows at one column.  h (and e) hold the rows' H (and E) of
// the previous column on entry and of this column on exit; diag is the
// band's top H at the previous column, up (and fup) its top H (and F) here.
// Returns the bottom row's F (affine).
template <bool AFFINE>
__device__ __forceinline__ int band_column(int (&h)[RB], int (&e)[AFFINE ? RB : 1], const uint32_t (&s)[RB / 4],
                                           int diag, int up, int fup, int& best, int gap, int ext) {
  int best2 = 0;
  if constexpr (AFFINE) {
    int f = __viaddmax_s32(fup, -ext, up - gap);  // row 0's F: max(top H - open, top F - ext)
    int xo = 0;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int left = h[r];
      e[r] = __viaddmax_s32(e[r], -ext, left - gap);
      const int x = __viaddmax_s32_relu(diag, sbyte(s[r / 4], r % 4), e[r]);  // max(0, diag + s, E)
      if (r > 0) f = __viaddmax_s32(f, -ext, xo);  // max(F above - ext, H above - open)
      xo = x - gap;
      diag = left;
      h[r] = max(x, f);
      if (r % 2) {
        if (r % 4 == 1) best = __vimax3_s32(best, h[r - 1], h[r]);
        else best2 = __vimax3_s32(best2, h[r - 1], h[r]);
      }
    }
    best = max(best, best2);
    return f;
  } else {
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int left = h[r];
      const int x = __viaddmax_s32_relu(diag, sbyte(s[r / 4], r % 4), left - gap);  // max(0, diag + s, left - gap)
      up = __viaddmax_s32(up, -gap, x);
      diag = left;
      h[r] = up;
      if (r % 2) {
        if (r % 4 == 1) best = __vimax3_s32(best, h[r - 1], h[r]);
        else best2 = __vimax3_s32(best2, h[r - 1], h[r]);
      }
    }
    best = max(best, best2);
    return 0;
  }
}

template <bool AFFINE>
__global__ void __launch_bounds__(LBLOCK, 2)
sw_long_kernel(const int8_t* __restrict__ query, int m, const int8_t* __restrict__ flat,
               const int64_t* __restrict__ offsets, const int64_t* __restrict__ ids, const int8_t* __restrict__ table,
               typename Slot<AFFINE>::T* __restrict__ carry, int32_t* __restrict__ out, int gap, int ext) {
  using S = typename Slot<AFFINE>::T;
  extern __shared__ int4 smem[];
  __shared__ int red[WARPS];
  int4* tab = smem;                                             // [letter][half][band]
  S* ring = reinterpret_cast<S*>(tab + TAB_UNITS);              // [warp boundary][RING]
  int8_t* smat = reinterpret_cast<int8_t*>(ring + (WARPS - 1) * RING);  // [letter][residue]

  const int b = threadIdx.x;  // this thread's band in a pass
  const int lane = b & 31, warp = b >> 5;
  const int64_t id = ids[blockIdx.x];
  const int64_t start = offsets[id];
  const int n = static_cast<int>(offsets[id + 1] - start);
  const int n_pass = (n + PASS_ROWS - 1) / PASS_ROWS;
  const int8_t* seq = flat + start;
  carry += static_cast<size_t>(blockIdx.x) * m;
  const int lag = lane + warp * LAG;  // steps behind band 0
  for (int k = b; k < NL * A; k += LBLOCK) smat[k] = table[k];
  int best = 0;

  for (int pass = 0; pass < n_pass; ++pass) {
    __syncthreads();  // the matrix staged; the previous pass's carry written and its ring read
    const int row0 = pass * PASS_ROWS + b * RB;
    const int nb = min(LBLOCK, (n - pass * PASS_ROWS + RB - 1) / RB);  // bands in this pass
    const int active_warps = (nb + 31) / 32;
    if (warp >= active_warps) continue;  // no band here: only the pass barrier
    const bool real = b < nb;
    if (real) {  // stage this band's table
      int res[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) res[r] = row0 + r < n ? seq[row0 + r] & (A - 1) : -1;
#pragma unroll 1
      for (int a = 0; a < NL; ++a) {
        const int8_t* row = smat + a * A;
        uint32_t w[RB / 4];
#pragma unroll
        for (int k = 0; k < RB / 4; ++k) {
          uint32_t v = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int r = 4 * k + j;
            const uint32_t byte = res[r] < 0 ? 0x80u : static_cast<uint8_t>(row[res[r]]);
            v |= byte << (8 * j);
          }
          w[k] = v;
        }
        tab[(2 * a) * LBLOCK + b] = make_int4(w[0], w[1], w[2], w[3]);
        tab[(2 * a + 1) * LBLOCK + b] = make_int4(w[4], w[5], w[6], w[7]);
      }
    }
    const int last = nb - 1;
    const int steps = m + (last & 31) + (last >> 5) * LAG;
    const bool top_in = b == 0 && pass > 0;
    const bool ring_in = lane == 0 && warp > 0;
    const bool ring_out = real && lane == 31 && warp + 1 < active_warps;
    const bool put_bottom = b == last && pass + 1 < n_pass;
    S* ring_rd = ring + (ring_in ? warp - 1 : 0) * RING;
    S* ring_wr = ring + (ring_out ? warp : 0) * RING;

    int h[RB];
    int e[AFFINE ? RB : 1];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      h[r] = 0;
      if constexpr (AFFINE) e[r] = NEG;
    }
    int top_prev = 0, send_h = 0, send_f = NEG;
    // Column c + 1's query letter (and, for a later pass's first band, its
    // top) load while column c computes.
    int a_next = letter(query, 0);
    S top_next;
    if constexpr (AFFINE) top_next = top_in ? carry[0] : make_int2(0, NEG);
    else top_next = top_in ? carry[0] : 0;

    for (int t0 = 0; t0 < steps; t0 += CHUNK) {
#pragma unroll 1
      for (int t = t0; t < t0 + CHUNK; ++t) {
        int r_h = shfl_up1(send_h);
        int r_f = AFFINE ? shfl_up1(send_f) : 0;
        const int c = t - lag;
        if (real && c >= 0 && c < m) {
          if (b == 0) {
            if constexpr (AFFINE) {
              r_h = top_next.x;
              r_f = top_next.y;
            } else {
              r_h = top_next;
            }
            if (top_in && c + 1 < m) top_next = carry[c + 1];
          } else if (ring_in) {
            const S v = ring_rd[c & (RING - 1)];
            if constexpr (AFFINE) {
              r_h = v.x;
              r_f = v.y;
            } else {
              r_h = v;
            }
          }
          const int a = a_next;
          if (c + 1 < m) a_next = letter(query, c + 1);
          const int4 lo = tab[(2 * a) * LBLOCK + b], hi = tab[(2 * a + 1) * LBLOCK + b];
          const uint32_t s[RB / 4] = {static_cast<uint32_t>(lo.x), static_cast<uint32_t>(lo.y),
                                      static_cast<uint32_t>(lo.z), static_cast<uint32_t>(lo.w),
                                      static_cast<uint32_t>(hi.x), static_cast<uint32_t>(hi.y),
                                      static_cast<uint32_t>(hi.z), static_cast<uint32_t>(hi.w)};
          const int f = band_column<AFFINE>(h, e, s, top_prev, r_h, r_f, best, gap, ext);
          top_prev = r_h;
          send_h = h[RB - 1];
          send_f = f;
          S bottom;
          if constexpr (AFFINE) bottom = make_int2(send_h, f);
          else bottom = send_h;
          if (ring_out) ring_wr[c & (RING - 1)] = bottom;
          if (put_bottom) carry[c] = bottom;
        }
      }
      if (active_warps > 1) named_barrier(1, 32 * active_warps);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) best = max(best, __shfl_xor_sync(~0u, best, o));
  if (lane == 0) red[warp] = best;
  __syncthreads();
  if (b == 0) {
    int v = red[0];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v = max(v, red[w]);
    out[blockIdx.x] = v;
  }
}

template <bool AFFINE>
cudaError_t launch(const void* query, int m, const void* flat, const void* offsets, const void* ids, int n_seqs,
                   const void* table, void* carry, void* out, int gap, int ext, int device, cudaStream_t stream) {
  static std::atomic<bool> smem_set[MAX_DEVICES];  // the attribute, once a device
  constexpr int smem = smem_bytes<AFFINE>();
  if (device >= MAX_DEVICES || !smem_set[device].load(std::memory_order_relaxed)) {
    const cudaError_t err =
        cudaFuncSetAttribute(sw_long_kernel<AFFINE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (device < MAX_DEVICES) smem_set[device].store(true, std::memory_order_relaxed);
  }
  sw_long_kernel<AFFINE><<<n_seqs, LBLOCK, smem, stream>>>(
      static_cast<const int8_t*>(query), m, static_cast<const int8_t*>(flat), static_cast<const int64_t*>(offsets),
      static_cast<const int64_t*>(ids), static_cast<const int8_t*>(table),
      static_cast<typename Slot<AFFINE>::T*>(carry), static_cast<int32_t*>(out), gap, ext);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Score the query (m int8 letters, each below 25) against the `n_seqs`
// sequences `ids` (int64) of the database's resident residues `flat` (int8)
// with int64 `offsets`, one block each, on `stream` of `device`: out[i] the
// exact int32 Smith-Waterman score of sequence ids[i].  `table` is the
// (25, 32) int8 matrix, [query letter][residue].  Linear gaps when `affine`
// is 0 (`gap`), else Gotoh's with gap_open `gap` and gap_extend `ext` (gap
// >= ext >= 0).  `carry`: n_seqs x m int32 (linear) or int2 (affine) slots.
// Returns cudaGetLastError() (0: launched).
int sw_long_launch(const void* query, int m, const void* flat, const void* offsets, const void* ids, int n_seqs,
                   const void* table, void* carry, void* out, int gap, int ext, int affine, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  err = affine ? launch<true>(query, m, flat, offsets, ids, n_seqs, table, carry, out, gap, ext, device, s)
               : launch<false>(query, m, flat, offsets, ids, n_seqs, table, carry, out, gap, 0, device, s);
  return static_cast<int>(err);
}

const char* sw_long_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
