// Lab variants of the wavefront Smith-Waterman kernel (csrc/sw_wave.cu), for
// Hopper (sm_90a): linear gaps, one query, exact int32.
//
// Replaces three TPU lab kernels, each a variant of the wavefront scorer:
//  K4  tools/pallas_wave.py:208 sw_wave -> _wave_kernel (:68, pallas_call
//      :219), the V5 wavefront with its knobs W (band height), Lc, g, Bt;
//  K5  tools/pallas_wave2.py:201 sw_wave6 -> _wave6_kernel (:69, pallas_call
//      :211), V6: chunk c + 1's staging interleaved with chunk c's DP;
//  K6  tools/probe_breakdown.py:199 run_variant -> _kernel (:33, pallas_call
//      :208), K1 with one stage at a time switched off, a timing probe.
// They are one kernel here, sw_wave.cu's linear sweep with four
// compile-time knobs, and take K1's input contract: a (n_bands * H, 32) int8
// profile, a (L2, B) int8 transposed bucket of n_segs chained segments of
// seg_cols columns, and flat int32 out[lane * n_segs + seg].  A thread owns a
// (lane, segment), holds H query rows in registers, sweeps its columns and
// hands each band's bottom row to the next through a global carry, as K1
// does (sw_wave.cu's notes).  The TPU knobs with no Hopper meaning are not
// carried over: g, KPAD and the banded lhs (the MXU's skew staging), Lc
// (VMEM chunking: a thread streams its whole segment) and Bt (lanes are
// threads here).
//  * H (K4's W): query rows a band, 16, 32 or 64.  It sets the registers a
//    thread holds, the carry bytes (8 / H a cell) and the profile-staging
//    barriers (one pair a band).
//  * BLOCK (K4): threads a block, 32, 64 or 128.  A narrow bucket of 128-768
//    threads spreads over more SMs with smaller blocks.
//  * D (K5): subject residues and carry tops load D columns ahead into a
//    register ring, 1, 2, 4 or 8; the column loop is unrolled by D so the
//    ring's indices are constants.  D = 1 is K1's schedule (sw_wave.cu's
//    "column j + 1 ... load while column j computes").  The TPU's chunk c + 1
//    under chunk c is the same idea: loads in flight under the DP.
//  * SKIP (K6): one stage dropped, with an exactly defined result, so every
//    variant is checked as well as timed (the TPU probe's outputs were
//    garbage by design):
//      NONE     K1's function: the SW maximum of each (lane, segment).
//      SUBJECT  no subject loads: column c (of the bucket, seg * seg_cols + j)
//               of lane `lane` holds residue (lane + c) & 31; otherwise NONE.
//      CARRY    no carry reads or writes: every band starts from a zero top,
//               so the result is the largest band-local SW maximum,
//               max over bands b of SW(profile rows [bH, bH + H), segment).
//      DP       no cell DP: column j of band b folds its H profile scores to
//               m = their maximum and computes v = top + m, where top is the
//               carry (v of band b - 1 at column j, 0 for band 0); v is the
//               band's bottom, and the result is max(0, every v).
// K4 at every (H, BLOCK), K5 at every D and K6 at NONE compute K1's scores.
//
// What bounds it: int32 operations, 6 a padded cell (sw_wave.cu's count) over
// the card's int32 rate, as K1; SKIP = DP does H + 2 a column (H max, an add,
// the running best), its bound the larger of those and its bytes (subjects,
// profile and scores once).  PERF.md's
// questions: is a narrow bucket's column bound by load latency (K6: SUBJECT
// and CARRY against NONE), does loading D columns ahead cut it (K5), and
// which band height and block size win per bucket group (K4).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int A = 32;  // profile columns (padded alphabet)
enum Skip { NONE = 0, SUBJECT = 1, CARRY = 2, DP = 3 };

__device__ __forceinline__ void cell(int& h, int s, int& diag, int& up, int& best, int gap) {
  const int left = h;
  const int x = max(max(diag + s, left - gap), 0);  // independent of up
  const int v = max(x, up - gap);
  diag = left;
  h = v;
  up = v;
  best = max(best, v);
}

template <int H, int BLOCK, int D, int SKIP>
__global__ void __launch_bounds__(BLOCK)
sw_wave_lab_kernel(const int8_t* __restrict__ profile,  // (n_bands * H, A)
                   const int8_t* __restrict__ subjT,    // (L2, B)
                   int32_t* __restrict__ carry,         // (n_segs * seg_cols, B); unused if n_bands == 1 or CARRY
                   int32_t* __restrict__ out,           // (B * n_segs)
                   int n_bands, int B, int n_segs, int seg_cols, int gap) {
  static_assert(H % 4 == 0 && D >= 1, "a band is read as int4 score quads");
  constexpr int STRIDE = H + 4;  // shared row stride in int32: 16-byte aligned, spreads banks
  __shared__ __align__(16) int32_t sprof[A * STRIDE];
  const long long t = static_cast<long long>(blockIdx.x) * BLOCK + threadIdx.x;
  const bool active = t < static_cast<long long>(B) * n_segs;
  const int seg = active ? static_cast<int>(t / B) : 0;
  const int lane = active ? static_cast<int>(t - static_cast<long long>(seg) * B) : 0;
  const size_t base = static_cast<size_t>(seg) * seg_cols * B + lane;
  const int8_t* col = subjT + base;
  const int first = lane + seg * seg_cols;  // SUBJECT: residue of column j is (first + j) & 31
  // The opaque copy of sw_wave.cu, so both sweeps address the carry alike.
  unsigned long long cc_addr = reinterpret_cast<unsigned long long>(carry + base);
  asm volatile("mov.b64 %0, %0;" : "+l"(cc_addr));
  int32_t* cc = reinterpret_cast<int32_t*>(cc_addr);
  auto residue = [&](int j) -> int {
    if constexpr (SKIP == SUBJECT) return (first + j) & (A - 1);
    return col[static_cast<size_t>(j) * B] & (A - 1);
  };
  int best = 0;

  for (int band = 0; band < n_bands; ++band) {
    __syncthreads();  // every reader of the previous band's rows is done
    for (int k = threadIdx.x; k < H * A; k += BLOCK) {
      const int r = k / A, a = k % A;
      sprof[a * STRIDE + r] = profile[static_cast<size_t>(band * H + r) * A + a];
    }
    __syncthreads();
    if (!active) continue;  // idle threads still reach both barriers
    const bool has_top = SKIP != CARRY && band > 0;
    const bool put_bottom = SKIP != CARRY && band + 1 < n_bands;
    int h[H];
#pragma unroll
    for (int r = 0; r < H; ++r) h[r] = 0;
    int top_prev = 0;
    // The ring: column j's residue and top sit in slot j % D, loaded at
    // column j - D (the first D before the sweep).
    int a_ring[D], top_ring[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      a_ring[k] = k < seg_cols ? residue(k) : 0;
      top_ring[k] = has_top && k < seg_cols ? cc[static_cast<size_t>(k) * B] : 0;
    }
    // Column j from ring slot k, which then takes column j + D.
    auto column = [&](int j, int k) {
      const int a = a_ring[k], top = top_ring[k];
      if (j + D < seg_cols) {
        a_ring[k] = residue(j + D);
        if (has_top) top_ring[k] = cc[static_cast<size_t>(j + D) * B];
      }
      const int4* s4 = reinterpret_cast<const int4*>(sprof + a * STRIDE);
      int bottom;
      if constexpr (SKIP == DP) {
        int m = s4[0].x;
#pragma unroll
        for (int q = 0; q < H / 4; ++q) {
          const int4 s = s4[q];
          m = max(max(m, s.x), max(max(s.y, s.z), s.w));
        }
        bottom = top + m;
        best = max(best, bottom);
      } else {
        int diag = top_prev, up = top;
#pragma unroll
        for (int q = 0; q < H / 4; ++q) {
          const int4 s = s4[q];
          cell(h[4 * q + 0], s.x, diag, up, best, gap);
          cell(h[4 * q + 1], s.y, diag, up, best, gap);
          cell(h[4 * q + 2], s.z, diag, up, best, gap);
          cell(h[4 * q + 3], s.w, diag, up, best, gap);
        }
        bottom = h[H - 1];
        top_prev = top;
      }
      if (put_bottom) cc[static_cast<size_t>(j) * B] = bottom;
    };
    if constexpr (D == 1) {
      for (int j = 0; j < seg_cols; ++j) column(j, 0);
    } else {
      // Whole groups of D columns, then the last seg_cols % D: each column's
      // slot is a constant, so the ring stays in registers.  (A group loop
      // that breaks at the segment's end is not unrolled by the compiler.)
      int j0 = 0;
      for (; j0 + D <= seg_cols; j0 += D) {
#pragma unroll
        for (int k = 0; k < D; ++k) column(j0 + k, k);
      }
#pragma unroll
      for (int k = 0; k < D - 1; ++k) {
        if (j0 + k < seg_cols) column(j0 + k, k);
      }
    }
  }
  if (active) out[static_cast<size_t>(lane) * n_segs + seg] = best;
}

using Kernel = void (*)(const int8_t*, const int8_t*, int32_t*, int32_t*, int, int, int, int, int);

struct Variant {
  int height, block, depth, skip;
  Kernel kernel;
};

// K4: every (H, BLOCK) at D = 1; K5: every D at K1's H = 32, BLOCK = 64;
// K6: every SKIP at K1's H, BLOCK and D.  (32, 64, 1, NONE) serves all three.
const Variant VARIANTS[] = {
    {16, 32, 1, NONE, sw_wave_lab_kernel<16, 32, 1, NONE>},
    {16, 64, 1, NONE, sw_wave_lab_kernel<16, 64, 1, NONE>},
    {16, 128, 1, NONE, sw_wave_lab_kernel<16, 128, 1, NONE>},
    {32, 32, 1, NONE, sw_wave_lab_kernel<32, 32, 1, NONE>},
    {32, 64, 1, NONE, sw_wave_lab_kernel<32, 64, 1, NONE>},
    {32, 128, 1, NONE, sw_wave_lab_kernel<32, 128, 1, NONE>},
    {64, 32, 1, NONE, sw_wave_lab_kernel<64, 32, 1, NONE>},
    {64, 64, 1, NONE, sw_wave_lab_kernel<64, 64, 1, NONE>},
    {64, 128, 1, NONE, sw_wave_lab_kernel<64, 128, 1, NONE>},
    {32, 64, 2, NONE, sw_wave_lab_kernel<32, 64, 2, NONE>},
    {32, 64, 4, NONE, sw_wave_lab_kernel<32, 64, 4, NONE>},
    {32, 64, 8, NONE, sw_wave_lab_kernel<32, 64, 8, NONE>},
    {32, 64, 1, SUBJECT, sw_wave_lab_kernel<32, 64, 1, SUBJECT>},
    {32, 64, 1, CARRY, sw_wave_lab_kernel<32, 64, 1, CARRY>},
    {32, 64, 1, DP, sw_wave_lab_kernel<32, 64, 1, DP>},
};

}  // namespace

extern "C" {

// Launch the (height, block, depth, skip) variant on `stream` of `device`;
// return cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a
// variant that is not compiled.
int sw_wave_lab_launch(const void* profile, const void* subjT, void* carry, void* out, int n_bands, int B,
                       int n_segs, int seg_cols, int gap, int height, int block, int depth, int skip, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (const Variant& v : VARIANTS) {
    if (v.height != height || v.block != block || v.depth != depth || v.skip != skip) continue;
    const long long threads = static_cast<long long>(B) * n_segs;
    const unsigned grid = static_cast<unsigned>((threads + block - 1) / block);
    v.kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(profile), static_cast<const int8_t*>(subjT), static_cast<int32_t*>(carry),
        static_cast<int32_t*>(out), n_bands, B, n_segs, seg_cols, gap);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* sw_wave_lab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
