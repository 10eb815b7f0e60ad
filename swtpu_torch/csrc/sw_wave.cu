// Smith-Waterman database scoring for Hopper (sm_90a): linear gaps, one
// query against one transposed bucket of subjects, exact int32.
//
// Replaces the TPU kernel swtpu/ops/wave_sw.py::_wave_kernel (launched by
// sw_wave) in its single-query linear modes, unchained (n_segs = 1) and
// chained (n_segs > 1).  It computes what that kernel computes -- for every
// (lane, segment) of a transposed (L2, B) int8 bucket, the Smith-Waterman
// maximum of the query profile against the segment's seg_cols columns, flat
// at out[lane * n_segs + seg] -- and not how: the TPU's MXU skew staging,
// banded profile, 8-aligned DMAs and one-hot hoisting are not carried over.
//
// Design: one thread per (lane, segment), inter-sequence.
//  * Thread t scores segment t / B of lane t % B, so neighbouring threads
//    read neighbouring bytes of a subject column and neighbouring words of
//    the carry.
//  * A thread walks the query in bands of W = 32 rows.  The band's H column
//    lives in 32 registers; the thread sweeps its segment's columns left to
//    right and computes H = max(0, diag + S, up - gap, left - gap) down the
//    band.
//  * The band's bottom row goes to a global int32 carry, one slot per column
//    of the thread's own segment (read as the top boundary, then overwritten
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
// What bounds it: int32 ALU operations.  The recurrence needs about 6 a cell
// (add, two max, subtract, clamp at 0, running-best max); the form below
// spends 7 so that the dependent chain through `up` is two operations long.
// An H100 SXM has 132 SMs x 64 int32 lanes at up to 1.98 GHz, 16.7 T int32
// operations a second, so 6 operations a cell bound it near 2.8 T cells a
// second.  Memory is no limit: a column costs 1 subject byte per 32 cells and
// 8 carry bytes per band.  The cell loop spends nothing on staging or masks.
// Left for later work (ROADMAP.md): DPX three-way max (__vimax3_s32_relu),
// packed int16 pairs, and occupancy, since a bucket of a few thousand
// (lane, segment) pairs fills only part of the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 32;          // query rows per band (register tile)
constexpr int A = 32;          // profile columns (padded alphabet)
constexpr int STRIDE = W + 4;  // shared row stride in int32: 16-byte aligned, spreads banks
constexpr int BLOCK = 64;      // small blocks spread a bucket over more SMs

__device__ __forceinline__ void cell(int& h, int s, int& diag, int& up, int& best, int gap) {
  const int left = h;
  const int x = max(max(diag + s, left - gap), 0);  // independent of up
  const int v = max(x, up - gap);
  diag = left;
  h = v;
  up = v;
  best = max(best, v);
}

__global__ void __launch_bounds__(BLOCK)
sw_wave_kernel(const int8_t* __restrict__ profile,  // (n_bands * W, A)
               const int8_t* __restrict__ subjT,    // (L2, B)
               int32_t* __restrict__ carry,         // (n_segs * seg_cols, B), unused if n_bands == 1
               int32_t* __restrict__ out,           // (B * n_segs,)
               int n_bands, int B, int n_segs, int seg_cols, int gap) {
  __shared__ __align__(16) int32_t sprof[A * STRIDE];
  const long long t = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  const bool active = t < static_cast<long long>(B) * n_segs;
  const int seg = active ? static_cast<int>(t / B) : 0;
  const int lane = active ? static_cast<int>(t - static_cast<long long>(seg) * B) : 0;
  const size_t base = static_cast<size_t>(seg) * seg_cols * B + lane;
  const int8_t* col = subjT + base;
  int32_t* cc = carry + base;
  int best = 0;

  for (int band = 0; band < n_bands; ++band) {
    __syncthreads();  // every reader of the previous band's rows is done
    for (int k = threadIdx.x; k < W * A; k += BLOCK) {
      const int r = k / A, a = k % A;
      sprof[a * STRIDE + r] = profile[static_cast<size_t>(band * W + r) * A + a];
    }
    __syncthreads();
    if (!active) continue;  // idle threads still reach both barriers
    const bool has_top = band > 0;
    const bool put_bottom = band + 1 < n_bands;
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
  if (active) out[static_cast<size_t>(lane) * n_segs + seg] = best;
}

}  // namespace

extern "C" {

// Launch on `stream` of `device`; returns cudaGetLastError() (0 = launched).
int sw_wave_launch(const void* profile, const void* subjT, void* carry, void* out, int n_bands,
                   int B, int n_segs, int seg_cols, int gap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long threads = static_cast<long long>(B) * n_segs;
  const unsigned grid = static_cast<unsigned>((threads + BLOCK - 1) / BLOCK);
  sw_wave_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(profile), static_cast<const int8_t*>(subjT),
      static_cast<int32_t*>(carry), static_cast<int32_t*>(out), n_bands, B, n_segs, seg_cols,
      gap);
  return static_cast<int>(cudaGetLastError());
}

const char* sw_wave_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
