// Smith-Waterman database scoring for Hopper (sm_90a): linear or affine
// (Gotoh) gaps, one or Q queries against one transposed bucket of subjects,
// exact int32.
//
// Replaces the TPU kernel swtpu/ops/wave_sw.py::_wave_kernel (launched by
// sw_wave) in its linear modes -- one query, unchained (n_segs = 1) and
// chained (n_segs > 1), and Q queries in one launch (a 4-D lhsB there) --
// in its affine mode (gap_open/gap_extend), in each of those, and in its
// band-carry hand-off (top_in/return_carry, one query).  It computes what
// that kernel computes -- for every query and every (lane, segment) of a
// transposed (L2, B) int8 bucket, the Smith-Waterman maximum of the query's
// profile against the segment's seg_cols columns, flat at
// out[query][lane * n_segs + seg] -- and not how: the TPU's MXU skew
// staging, banded profile, 8-aligned DMAs and one-hot hoisting are not
// carried over.
//
// Design: one thread per (query, lane, segment), inter-sequence.
//  * Grid axis y is the query.  A block stages its own query's bands and
//    owns that query's slice of the carry and of the output: the TPU grid
//    runs the query axis in order and shares one carry buffer, but blocks
//    of different queries run here at once, so each query has its own.
//  * Thread t scores segment t / B of lane t % B, so neighbouring threads
//    read neighbouring bytes of a subject column and neighbouring words of
//    the carry.
//  * A thread walks the query in bands of W = 32 rows.  The band's H column
//    lives in 32 registers; the thread sweeps its segment's columns left to
//    right and computes H = max(0, diag + S, up - gap, left - gap) down the
//    band.
//  * The band's bottom row goes to a global carry, one slot per column of
//    the thread's own segment (read as the top boundary, then overwritten
//    in place), and is the next band's top boundary.  Row 0's diagonal is
//    the previous column's top value, kept in a register.
//  * The band's 32 profile rows are staged in shared memory, transposed to
//    [residue][row] int32 with a padded stride, so a column's 32 scores are
//    eight 16-byte loads.
//  * Segments are independent problems with zero boundaries, so chaining
//    needs no separator logic: nothing of segment s reaches segment s + 1,
//    and a segment whose last column is a real residue is scored like any
//    other.  The best is written once per thread.
//
// Affine mode (template parameter AFFINE, so the linear kernel is compiled
// as before): E(r,j) = max(H(r,j-1) - open, E(r,j-1) - ext) is row-local and
// crosses columns, so each of the 32 rows keeps an E register beside its H;
// F(r,j) = max(H(r-1,j) - open, F(r-1,j) - ext) runs down the band beside
// `up`; H = max(0, diag + S, E, F).  The carry slot holds the band's bottom
// H and F interleaved (one 8-byte load and store per column).  E at a
// segment's first column and F above band 0 are NEG, as in swtpu; with H >= 0
// every later E and F is >= -open, so NEG - ext cannot wrap.  Segments are
// separate threads, so the TPU kernel's separator resets of E and F come for
// free here too.
//
// Carry hand-off (template parameter HAND_OFF, and two runtime flags
// tested once a band): a query's bands can run as a chain of launches, each
// launch a group of bands.  With has_top_in, band 0 reads its top boundary
// from the carry, as every later band does, instead of H = 0 (and F = NEG);
// with put_last, the last band also writes its bottom row there.  The carry
// is then an input and an output: (n_segs * seg_cols, B) int32 H, or int2
// (H, F) slots in affine mode, row = the bucket column (the TPU's (B/Bt,
// L2+w, Bt) tiles with row = column + w are its own layout).  It is
// overwritten in place, column j's bottom after column j + 1's top is read,
// so one buffer a bucket serves the whole chain.  A hand-off launch scores
// one query, as in swtpu (the wrapper refuses a profile stack).  A launch
// with either flag runs the HAND_OFF instantiation, and the other modes'
// kernels compile as they did before the flags.  Measured on an H100 with
// wave_ab.py, P01008's 27 fused launches: 123.8 ms linear as before, and
// 132.6 ms with the flags tested in the one kernel of every mode; the 108
// launches of a composed search: 144.7 ms, and 172.5 ms with both flags
// made compile-time constants in the hand-off kernel (ptxas then schedules
// the linear sweep worse).
//
// What bounds it: int32 ALU operations.  The linear recurrence needs about 6
// a cell (add, two max, subtract, clamp at 0, running-best max); the form
// below spends 7 so that the dependent chain through `up` is two operations
// long.  The affine one needs 11 (E and F: two subtracts and a max each; H:
// an add and three max with the clamp; the running best).  An H100 SXM's
// 132 SMs x 64 int32 lanes at up to 1.98 GHz issue 16.7 T int32 instructions
// a second, each at most two operations (VIADDMNMX: an add then a max), so
// 33.5 T operations, and 6 a cell bound it near 5.6 T cells a second (11:
// 3.0 T).  Memory is no limit: a column costs 1 subject byte per 32 cells
// and 8 carry bytes per band (16 affine).  The cell loop spends nothing on
// staging or masks.  Left for later work (ROADMAP.md): DPX three-way max
// (__vimax3_s32_relu), packed int16 pairs, and occupancy, since a bucket of
// a few thousand (lane, segment) pairs fills only part of the card (a
// Q-query launch has Q times the threads, which is all the multi-query mode
// does about it).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 32;          // query rows per band (register tile)
constexpr int A = 32;          // profile columns (padded alphabet)
constexpr int STRIDE = W + 4;  // shared row stride in int32: 16-byte aligned, spreads banks
constexpr int BLOCK = 64;      // small blocks spread a bucket over more SMs
constexpr int NEG = -(1 << 30);  // minus infinity of the affine E and F boundaries

// One carry slot per column and lane: the band's bottom H, and in affine
// mode its bottom F beside it.
template <bool AFFINE> struct Carry { using Slot = int32_t; };
template <> struct Carry<true> { using Slot = int2; };

__device__ __forceinline__ void cell(int& h, int s, int& diag, int& up, int& best, int gap) {
  const int left = h;
  const int x = max(max(diag + s, left - gap), 0);  // independent of up
  const int v = max(x, up - gap);
  diag = left;
  h = v;
  up = v;
  best = max(best, v);
}

// One Gotoh cell: h and e hold the row's H and E of the previous column on
// entry and of this column on exit; up and fup carry H and F down the band.
__device__ __forceinline__ void cell_affine(int& h, int& e, int s, int& diag, int& up, int& fup, int& best,
                                            int open, int ext) {
  const int left = h;
  const int ev = max(left - open, e - ext);
  const int x = max(max(diag + s, ev), 0);  // independent of up
  const int f = max(up - open, fup - ext);
  const int v = max(x, f);
  diag = left;
  e = ev;
  h = v;
  up = v;
  fup = f;
  best = max(best, v);
}

// gap is the linear penalty, or the affine open penalty with ext beside it.
template <bool AFFINE, bool HAND_OFF>
__global__ void __launch_bounds__(BLOCK)
sw_wave_kernel(const int8_t* __restrict__ profile,                   // (Q, n_bands * W, A)
               const int8_t* __restrict__ subjT,                     // (L2, B)
               typename Carry<AFFINE>::Slot* __restrict__ carry,     // (Q, n_segs * seg_cols, B); unused if
                                                                     // n_bands == 1 and neither flag is set
               int32_t* __restrict__ out,                            // (Q, B * n_segs)
               int n_bands, int B, int n_segs, int seg_cols, int gap, int ext, bool has_top_in,
               bool put_last) {
  using Slot = typename Carry<AFFINE>::Slot;
  __shared__ __align__(16) int32_t sprof[A * STRIDE];
  const size_t query = blockIdx.y;
  const size_t slots = static_cast<size_t>(B) * n_segs;
  profile += query * n_bands * W * A;
  out += query * slots;
  if (n_bands > 1) carry += query * seg_cols * slots;  // a hand-off launch has one query: no offset
  const long long t = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  const bool active = t < static_cast<long long>(B) * n_segs;
  const int seg = active ? static_cast<int>(t / B) : 0;
  const int lane = active ? static_cast<int>(t - static_cast<long long>(seg) * B) : 0;
  const size_t base = static_cast<size_t>(seg) * seg_cols * B + lane;
  const int8_t* col = subjT + base;
  // An opaque copy keeps the carry pointer in registers: left as an
  // expression of blockIdx.y, ptxas rebuilds it from SR_CTAID.Y in every
  // column, which made the sweep 1.5x slower (H100, chip_smoke's buckets).
  unsigned long long cc_addr = reinterpret_cast<unsigned long long>(carry + base);
  asm volatile("mov.b64 %0, %0;" : "+l"(cc_addr));
  Slot* cc = reinterpret_cast<Slot*>(cc_addr);
  int best = 0;

  for (int band = 0; band < n_bands; ++band) {
    __syncthreads();  // every reader of the previous band's rows is done
    for (int k = threadIdx.x; k < W * A; k += BLOCK) {
      const int r = k / A, a = k % A;
      sprof[a * STRIDE + r] = profile[static_cast<size_t>(band * W + r) * A + a];
    }
    __syncthreads();
    if (!active) continue;  // idle threads still reach both barriers
    const bool has_top = band > 0 || (HAND_OFF && has_top_in);
    const bool put_bottom = band + 1 < n_bands || (HAND_OFF && put_last);
    if constexpr (AFFINE) {
      int h[W], e[W];
#pragma unroll
      for (int r = 0; r < W; ++r) {
        h[r] = 0;
        e[r] = NEG;
      }
      int top_prev = 0;
      // Column j + 1's residue and top (H, F) load while column j computes.
      int a_next = col[0] & (A - 1);
      int2 top_next = has_top ? cc[0] : make_int2(0, NEG);
      for (int j = 0; j < seg_cols; ++j) {
        const int a = a_next;
        const int2 top = top_next;
        if (j + 1 < seg_cols) {
          const size_t nxt = static_cast<size_t>(j + 1) * B;
          a_next = col[nxt] & (A - 1);
          if (has_top) top_next = cc[nxt];
        }
        const int4* s4 = reinterpret_cast<const int4*>(sprof + a * STRIDE);
        int diag = top_prev, up = top.x, fup = top.y;
#pragma unroll
        for (int q = 0; q < W / 4; ++q) {
          const int4 s = s4[q];
          cell_affine(h[4 * q + 0], e[4 * q + 0], s.x, diag, up, fup, best, gap, ext);
          cell_affine(h[4 * q + 1], e[4 * q + 1], s.y, diag, up, fup, best, gap, ext);
          cell_affine(h[4 * q + 2], e[4 * q + 2], s.z, diag, up, fup, best, gap, ext);
          cell_affine(h[4 * q + 3], e[4 * q + 3], s.w, diag, up, fup, best, gap, ext);
        }
        if (put_bottom) cc[static_cast<size_t>(j) * B] = make_int2(h[W - 1], fup);
        top_prev = top.x;
      }
    } else {
      int h[W];
#pragma unroll
      for (int r = 0; r < W; ++r) h[r] = 0;
      int top_prev = 0;
      // Column j + 1's residue and top value load while column j computes.
      int a_next = col[0] & (A - 1);
      int top_next = has_top ? cc[0] : 0;
      for (int j = 0; j < seg_cols; ++j) {
        const int a = a_next, top = top_next;
        if (j + 1 < seg_cols) {
          const size_t nxt = static_cast<size_t>(j + 1) * B;
          a_next = col[nxt] & (A - 1);
          if (has_top) top_next = cc[nxt];
        }
        const int4* s4 = reinterpret_cast<const int4*>(sprof + a * STRIDE);
        int diag = top_prev, up = top;
#pragma unroll
        for (int q = 0; q < W / 4; ++q) {
          const int4 s = s4[q];
          cell(h[4 * q + 0], s.x, diag, up, best, gap);
          cell(h[4 * q + 1], s.y, diag, up, best, gap);
          cell(h[4 * q + 2], s.z, diag, up, best, gap);
          cell(h[4 * q + 3], s.w, diag, up, best, gap);
        }
        if (put_bottom) cc[static_cast<size_t>(j) * B] = h[W - 1];
        top_prev = top;
      }
    }
  }
  if (active) out[static_cast<size_t>(lane) * n_segs + seg] = best;
}

template <bool AFFINE>
int launch(const void* profile, const void* subjT, void* carry, void* out, int n_queries, int n_bands, int B,
           int n_segs, int seg_cols, int gap, int ext, int has_top_in, int put_last, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long threads = static_cast<long long>(B) * n_segs;
  const dim3 grid(static_cast<unsigned>((threads + BLOCK - 1) / BLOCK), static_cast<unsigned>(n_queries));
  auto kernel = has_top_in || put_last ? sw_wave_kernel<AFFINE, true> : sw_wave_kernel<AFFINE, false>;
  kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(profile), static_cast<const int8_t*>(subjT),
      static_cast<typename Carry<AFFINE>::Slot*>(carry), static_cast<int32_t*>(out), n_bands, B, n_segs,
      seg_cols, gap, ext, has_top_in != 0, put_last != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch for `n_queries` queries on `stream` of `device`; return
// cudaGetLastError() (0 = launched).  Linear gaps: `carry` holds one int32
// per slot.  Nonzero `has_top_in` / `put_last` hand the carry on (one query).
int sw_wave_launch(const void* profile, const void* subjT, void* carry, void* out, int n_queries,
                   int n_bands, int B, int n_segs, int seg_cols, int gap, int has_top_in, int put_last,
                   int device, void* stream) {
  return launch<false>(profile, subjT, carry, out, n_queries, n_bands, B, n_segs, seg_cols, gap, 0, has_top_in,
                       put_last, device, stream);
}

// The same with affine gaps (a length-L gap costs gap_open + (L-1) *
// gap_extend): `carry` holds two int32 (H, F) per slot.
int sw_wave_affine_launch(const void* profile, const void* subjT, void* carry, void* out, int n_queries,
                          int n_bands, int B, int n_segs, int seg_cols, int gap_open, int gap_extend,
                          int has_top_in, int put_last, int device, void* stream) {
  return launch<true>(profile, subjT, carry, out, n_queries, n_bands, B, n_segs, seg_cols, gap_open,
                      gap_extend, has_top_in, put_last, device, stream);
}

const char* sw_wave_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
