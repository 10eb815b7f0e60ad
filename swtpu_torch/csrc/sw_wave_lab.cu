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
// All take K1's input contract: a (n_bands * H, 32) int8 profile for K4 (its
// rows past the query score PAD_SCORE, below every real cell, so they raise
// no maximum), K1's own (n_bands * 32, 32) profile for K5 and K6, a (L2, B)
// int8 transposed bucket of n_segs chained segments of seg_cols columns, and
// flat int32 out[lane * n_segs + seg].  The TPU knobs with no Hopper meaning
// are not carried over: g, KPAD and the banded lhs (the MXU's skew staging),
// Lc (VMEM chunking) and Bt (lanes are threads or thread groups here).
//
// K4: the warp wavefront of K1 (sw_wave.cu: sw_wave_kernel, its notes) with
// K4's two knobs, so that the lab measures the shipping kernel's schedule
// (sw_wave_band_kernel<H, BLOCK>):
//  * G threads of a warp score one lane, all its chained segments end to
//    end (a reset at each segment's first column); thread b holds band b's
//    H query rows in registers.  At step t it computes column t - b and
//    hands its bottom row, the column's residue and the segment's running
//    best to thread b + 1 by a volatile-PTX shfl.sync.up, issued by every
//    thread at every step (ptxas twice sank a shuffle into a branch in this
//    package).  A pass is G bands; the global carry is read by a pass's
//    first band and written by its last only between passes.
//  * G, a runtime argument, is the next power of two of the profile's
//    bands, at most 16 (ops/wave_lab.py: band_schedule, the pure function
//    the wrapper passes it from; wave_sw.wave_shape's rule at H = 32); a
//    block of BLOCK threads holds BLOCK / G lanes.  Every bucket runs the
//    wavefront: there is no band-sweep route, so the lab times the full
//    buckets on it.
//  * The block stages a pass's bands of profile once for its warps, in
//    K1's int32 layout ([band][residue][row], row stride H + 4): G x 32 x
//    (H + 4) x 4 bytes of dynamic shared memory, 139 KB at H = 64, G = 16.
//    That stage is kept, and the lab shows its cost: at that shape one
//    block fits an SM (a single warp at BLOCK = 32).  P01008 runs H = 64 at
//    G = 8 (70 KB), H = 32 and 16 at G = 16 (74 and 41 KB).
//  * H (K4's W): 16, 32 or 64 rows a band: registers a thread, the skew's
//    fill (G - 1 columns a pass) against passes (ceil(bands / G)).  BLOCK:
//    32, 64 or 128 threads, so with the stage the warps an SM.
// K5 and K6 run K1's linear band sweep, sw_band_kernel<false, false, 64>
// (sw_wave.cu), as sw_band_lab_kernel<64, D, SKIP>: its linear branch copied
// with everything it does -- H = 64, BAND_BLOCK = 64 threads, a thread a
// (lane, segment) holding H query rows in registers, the band staged in
// dynamic shared memory by char4 loads (Stage<64>, 8,720 bytes), K1's
// 32-row-band profile with nb = ceil(rows / 64) sweep bands and the 32-row
// tail of an odd band count staged as NEG_S, the opaque carry pointer, the
// residue and top loaded one column ahead -- so that D = 1 with SKIP = NONE
// is that sweep, and the lab's knobs sit on top of it:
//  * D (K5): subject residues and carry tops load D columns ahead into a
//    register ring, 1, 2, 4 or 8; the column loop is unrolled by D so the
//    ring's indices are constants.  D = 1 is K1's own one column ahead.  The
//    TPU's chunk c + 1 under chunk c is the same idea: loads in flight under
//    the DP.
//  * SKIP (K6): one stage dropped, with an exactly defined result, so every
//    variant is checked as well as timed (the TPU probe's outputs were
//    garbage by design).  Bands are the sweep's: rows [64b, 64b + 64) of the
//    profile, the last one 32 rows where the 32-row band count is odd.
//      NONE     K1's function: the SW maximum of each (lane, segment).
//      SUBJECT  no subject loads: column c (of the bucket, seg * seg_cols + j)
//               of lane `lane` holds residue (lane + c) & 31; otherwise NONE.
//      CARRY    no carry reads or writes: every band starts from a zero top,
//               so the result is the largest band-local SW maximum,
//               max over bands b of SW(band b's rows, segment).  A tail's
//               NEG_S rows raise no maximum (K1's argument, gap >= 0).
//      DP       no cell DP: column j of band b folds its staged scores to
//               m = their maximum and computes v = top + m, where top is the
//               carry (v of band b - 1 at column j, 0 for band 0); v is the
//               band's bottom, and the result is max(0, every v).  NEG_S rows
//               never give m: every band holds at least 32 real rows.
// K4 at every (H, BLOCK), K5 at every D and K6 at NONE compute K1's scores.
//
// What bounds it: int32 operations, 6 a padded cell (sw_wave.cu's count) over
// the card's int32 rate, as K1; SKIP = DP does H + 2 a column of H = 64 rows
// (H max, an add, the running best), its bound the larger of those and its
// bytes (subjects, profile and scores once).  PERF.md's questions: on which
// buckets the wavefront loses to K1's band sweep and whether more warps an
// SM or a smaller stage helps (K4); how much of the sweep K1 ships is its
// carry through memory, its subject loads and its DP (K6: each against
// NONE), and does loading D columns ahead cut it (K5).

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int A = 32;             // profile columns (padded alphabet)
constexpr int MAX_G = 16;         // bands a pass of the wavefront
constexpr int SWEEP_H = 64;       // rows a band of K1's linear band sweep (wave_sw.BAND_H[False])
constexpr int BAND_BLOCK = 64;    // threads a block of the band sweep (sw_wave.cu)
constexpr int NEG_S = -(1 << 28);  // the score of a profile row past the query's end (sw_wave.cu)
enum Skip { NONE = 0, SUBJECT = 1, CARRY = 2, DP = 3 };

// K1's shared layout of one band: [residue][row] int32, rows padded to
// stride H + 4 (16-byte aligned), bands 16 bytes apart modulo the 32 banks.
template <int H> struct Stage {
  static constexpr int STRIDE = H + 4;
  static constexpr int BAND = A * STRIDE + 4;
  static constexpr int bytes(int g) { return g * BAND * 4; }
};

// __shfl_up_sync(~0u, v, 1, g) as volatile PTX, with the width's clamp
// (32 - g) << 8 a register: every thread issues it where it stands.
__device__ __forceinline__ int shfl_up1(int v, int clamp) {
  int r;
  asm volatile("shfl.sync.up.b32 %0, %1, 1, %2, -1;" : "=r"(r) : "r"(v), "r"(clamp));
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

// K4: the warp wavefront, g bands of H rows a pass in g threads of a warp
// (g a power of two, at most MAX_G), BLOCK / g lanes a block.
template <int H, int BLOCK>
__global__ void __launch_bounds__(BLOCK)
sw_wave_band_kernel(const int8_t* __restrict__ profile,  // (n_bands * H, A)
                    const int8_t* __restrict__ subjT,    // (L2, B)
                    int32_t* __restrict__ carry,         // (n_segs * seg_cols, B); unused with one pass
                    int32_t* __restrict__ out,           // (B * n_segs)
                    int n_bands, int B, int n_segs, int seg_cols, int gap, int g) {
  using S = Stage<H>;
  extern __shared__ int4 smem[];
  int32_t* sprof = reinterpret_cast<int32_t*>(smem);
  const int n_pass = (n_bands + g - 1) / g;
  const int total_cols = n_segs * seg_cols;
  const int clamp = (32 - g) << 8;
  const int b = threadIdx.x & (g - 1);  // this thread's band in the pass
  const int lane = blockIdx.x * (BLOCK / g) + threadIdx.x / g;
  const bool active = lane < B;  // lanes past B compute on lane B - 1's data and store nothing
  const int ln = active ? lane : B - 1;
  const int8_t* col = subjT + ln;
  // sw_wave.cu's opaque copy: the carry pointer stays in a register.
  unsigned long long cc_addr = reinterpret_cast<unsigned long long>(carry + ln);
  asm volatile("mov.b64 %0, %0;" : "+l"(cc_addr));
  int32_t* cc = reinterpret_cast<int32_t*>(cc_addr);

  for (int pass = 0; pass < n_pass; ++pass) {
    const int band0 = pass * g;
    const int nb = min(g, n_bands - band0);  // bands in this pass
    __syncthreads();  // every reader of the previous pass's profile is done
    for (int k = threadIdx.x; k < nb * H * (A / 4); k += BLOCK) {
      const int row = k / (A / 4), a = (k % (A / 4)) * 4;
      int32_t* dst = sprof + (row / H) * S::BAND + a * S::STRIDE + row % H;
      const char4 v = *reinterpret_cast<const char4*>(profile + (static_cast<size_t>(band0) * H + row) * A + a);
      dst[0] = v.x;
      dst[S::STRIDE] = v.y;
      dst[2 * S::STRIDE] = v.z;
      dst[3 * S::STRIDE] = v.w;
    }
    __syncthreads();
    const int32_t* bprof = sprof + b * S::BAND;
    const bool real = b < nb;
    const bool first = b == 0;
    const bool top_in = first && pass > 0;
    const bool put_bottom = active && b == nb - 1 && pass + 1 < n_pass;
    const bool put_best = active && b == nb - 1;
    const int steps = total_cols + nb - 1;

    int h[H];
    int best = 0, top_prev = 0, sc = 0, seg = 0;
    // What this thread hands to thread b + 1: the residue of its last column,
    // its band's bottom there and the segment's running best.
    int send_res = 0, send_h = 0, send_cb = 0;
    // The first thread's column t + 1 (residue and top) loads while column t computes.
    int a_next = col[0] & (A - 1);
    int top_next = top_in ? cc[0] : 0;

    for (int t = 0; t < steps; ++t) {
      int r_res = shfl_up1(send_res, clamp);
      int r_h = shfl_up1(send_h, clamp);
      int r_cb = shfl_up1(send_cb, clamp);
      if (first) {
        r_res = a_next;
        r_h = top_next;
        r_cb = 0;
        if (t + 1 < total_cols) {
          const size_t nxt = static_cast<size_t>(t + 1) * B;
          a_next = col[nxt] & (A - 1);
          if (top_in) top_next = cc[nxt];
        }
      }
      const int c = t - b;
      if (real && c >= 0 && c < total_cols) {
        if (sc == 0) {  // a segment's first column: zero left boundary, fresh best
#pragma unroll
          for (int r = 0; r < H; ++r) h[r] = 0;
          best = 0;
          top_prev = 0;
        }
        const int4* s4 = reinterpret_cast<const int4*>(bprof + r_res * S::STRIDE);
        int diag = top_prev, up = r_h;
#pragma unroll
        for (int q = 0; q < H / 4; ++q) {
          const int4 s = s4[q];
          cell(h[4 * q + 0], s.x, diag, up, best, gap);
          cell(h[4 * q + 1], s.y, diag, up, best, gap);
          cell(h[4 * q + 2], s.z, diag, up, best, gap);
          cell(h[4 * q + 3], s.w, diag, up, best, gap);
        }
        if (put_bottom) cc[static_cast<size_t>(c) * B] = h[H - 1];
        top_prev = r_h;
        const int cb = max(best, r_cb);
        if (++sc == seg_cols) {  // the segment's last column: its best over this pass's bands is cb
          if (put_best) {
            int32_t* o = out + static_cast<size_t>(lane) * n_segs + seg;
            *o = pass > 0 ? max(*o, cb) : cb;
          }
          sc = 0;
          ++seg;
        }
        send_h = h[H - 1];
        send_cb = cb;
      }
      send_res = r_res;
    }
  }
}

// K5 and K6: K1's linear band sweep (sw_wave.cu: sw_band_kernel<false, false,
// H>, its linear branch copied, not shared) with D and SKIP on top.  A thread
// a (lane, segment) walks nb = ceil(rows / H) bands of H rows, each band's
// bottom row handed to the next through the global carry; rows past the
// query (a 32-row tail band of an odd band count) are staged as NEG_S and
// the tail's bottom is its row 31, as in K1.
template <int H, int D, int SKIP>
__global__ void __launch_bounds__(BAND_BLOCK)
sw_band_lab_kernel(const int8_t* __restrict__ profile,  // (n_bands * 32, A): K1's profile
                   const int8_t* __restrict__ subjT,    // (L2, B)
                   int32_t* __restrict__ carry,         // (n_segs * seg_cols, B); unused for one band or CARRY
                   int32_t* __restrict__ out,           // (B * n_segs)
                   int n_bands, int B, int n_segs, int seg_cols, int gap) {
  static_assert(H % 32 == 0 && D >= 1, "bands of whole 32-row profile bands");
  using S = Stage<H>;
  extern __shared__ int4 smem[];
  int32_t* sprof = reinterpret_cast<int32_t*>(smem);
  const int rows = n_bands * 32;
  const int nb = (rows + H - 1) / H;
  const long long t = static_cast<long long>(blockIdx.x) * BAND_BLOCK + threadIdx.x;
  const bool active = t < static_cast<long long>(B) * n_segs;
  const int seg = active ? static_cast<int>(t / B) : 0;
  const int lane = active ? static_cast<int>(t - static_cast<long long>(seg) * B) : 0;
  const size_t base = static_cast<size_t>(seg) * seg_cols * B + lane;
  const int8_t* col = subjT + base;
  const int first = lane + seg * seg_cols;  // SUBJECT: residue of column j is (first + j) & 31
  unsigned long long cc_addr = reinterpret_cast<unsigned long long>(carry + base);
  asm volatile("mov.b64 %0, %0;" : "+l"(cc_addr));
  int32_t* cc = reinterpret_cast<int32_t*>(cc_addr);
  auto residue = [&](int j) -> int {
    if constexpr (SKIP == SUBJECT) return (first + j) & (A - 1);
    else return col[static_cast<size_t>(j) * B] & (A - 1);
  };
  int best = 0;

  for (int band = 0; band < nb; ++band) {
    __syncthreads();  // every reader of the previous band's rows is done
    for (int k = threadIdx.x; k < H * (A / 4); k += BAND_BLOCK) {
      const int r = k / (A / 4), a = (k % (A / 4)) * 4;
      const int grow = band * H + r;
      int32_t* dst = sprof + a * S::STRIDE + r;
      if (grow < rows) {
        const char4 v = *reinterpret_cast<const char4*>(profile + static_cast<size_t>(grow) * A + a);
        dst[0] = v.x;
        dst[S::STRIDE] = v.y;
        dst[2 * S::STRIDE] = v.z;
        dst[3 * S::STRIDE] = v.w;
      } else {
        dst[0] = dst[S::STRIDE] = dst[2 * S::STRIDE] = dst[3 * S::STRIDE] = NEG_S;
      }
    }
    __syncthreads();
    if (!active) continue;  // idle threads still reach both barriers
    const bool has_top = SKIP != CARRY && band > 0;
    const bool put_bottom = SKIP != CARRY && band + 1 < nb;
    const bool tail = H > 32 && rows - band * H < H;
    int h[H];
#pragma unroll
    for (int r = 0; r < H; ++r) h[r] = 0;
    int top_prev = 0;
    // The ring: column j's residue and top sit in slot j % D, loaded at
    // column j - D (the first D before the sweep; at D = 1 K1's one column
    // ahead, its slot 0 loaded unconditionally as K1 loads column 0).
    int a_ring[D], top_ring[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const bool in = k == 0 || k < seg_cols;
      a_ring[k] = in ? residue(k) : 0;
      top_ring[k] = has_top && in ? cc[static_cast<size_t>(k) * B] : 0;
    }
    // Column j from ring slot k, which then takes column j + D.
    auto column = [&](int j, int k) {
      const int a = a_ring[k], top = top_ring[k];
      if (j + D < seg_cols) {
        const size_t nxt = static_cast<size_t>(j + D) * B;
        if constexpr (SKIP == SUBJECT) a_ring[k] = residue(j + D);
        else a_ring[k] = col[nxt] & (A - 1);
        if (has_top) top_ring[k] = cc[nxt];
      }
      const int4* s4 = reinterpret_cast<const int4*>(sprof + a * S::STRIDE);
      if constexpr (SKIP == DP) {
        int m = s4[0].x;
#pragma unroll
        for (int q = 0; q < H / 4; ++q) {
          const int4 s = s4[q];
          m = max(max(m, s.x), max(max(s.y, s.z), s.w));
        }
        const int v = top + m;  // NEG_S rows never win: every band holds 32 real rows
        best = max(best, v);
        if (put_bottom) cc[static_cast<size_t>(j) * B] = v;
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
        if (put_bottom) cc[static_cast<size_t>(j) * B] = tail ? h[31] : h[H - 1];
        top_prev = top;
      }
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
using WaveKernel = void (*)(const int8_t*, const int8_t*, int32_t*, int32_t*, int, int, int, int, int, int);

struct Sweep {
  int depth, skip;
  Kernel kernel;
};

// K5: every D; K6: every SKIP at D = 1; (1, NONE) serves both.  All at K1's
// linear sweep height and block.
#define SWEEP(D, SKIP) {D, SKIP, sw_band_lab_kernel<SWEEP_H, D, SKIP>}
const Sweep SWEEPS[] = {
    SWEEP(1, NONE), SWEEP(2, NONE), SWEEP(4, NONE), SWEEP(8, NONE), SWEEP(1, SUBJECT), SWEEP(1, CARRY), SWEEP(1, DP),
};
#undef SWEEP
constexpr int SWEEP_STAGE = Stage<SWEEP_H>::bytes(1);  // one band of dynamic shared memory, 8,720 bytes

// The kernel of the sweep's (depth, skip), or nullptr.
Kernel sweep_kernel(int depth, int skip) {
  for (const Sweep& v : SWEEPS) {
    if (v.depth == depth && v.skip == skip) return v.kernel;
  }
  return nullptr;
}

struct Wave {
  int height, block, stage_max;
  WaveKernel kernel;
};

// K4: every (H, BLOCK).
#define K4_WAVE(H, BLOCK) {H, BLOCK, Stage<H>::bytes(MAX_G), sw_wave_band_kernel<H, BLOCK>}
const Wave WAVES[] = {
    K4_WAVE(16, 32), K4_WAVE(16, 64), K4_WAVE(16, 128), K4_WAVE(32, 32), K4_WAVE(32, 64),
    K4_WAVE(32, 128), K4_WAVE(64, 32), K4_WAVE(64, 64), K4_WAVE(64, 128),
};
#undef K4_WAVE

constexpr int N_WAVES = sizeof(WAVES) / sizeof(WAVES[0]);
constexpr int MAX_DEVICES = 64;  // devices whose shared-memory attribute is remembered as set

// cudaSetDevice only when `device` is not the thread's current device.
cudaError_t use_device(int device) {
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  return err != cudaSuccess || current == device ? err : cudaSetDevice(device);
}

// The index in WAVES of K4's (height, block), or -1.
int wave_index(int height, int block) {
  for (int k = 0; k < N_WAVES; ++k) {
    if (WAVES[k].height == height && WAVES[k].block == block) return k;
  }
  return -1;
}

// Let WAVES[k] take its largest stage: once a device per instantiation
// (setting it twice from two threads is harmless).
cudaError_t allow_stage(int k, int device) {
  static std::atomic<bool> smem_set[N_WAVES][MAX_DEVICES];
  if (device < MAX_DEVICES && smem_set[k][device].load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(WAVES[k].kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WAVES[k].stage_max);
  if (err == cudaSuccess && device < MAX_DEVICES) smem_set[k][device].store(true, std::memory_order_relaxed);
  return err;
}

cudaError_t launch_wave(int k, int device, cudaStream_t stream, const void* profile, const void* subjT, void* carry,
                        void* out, int n_bands, int B, int n_segs, int seg_cols, int gap, int g) {
  const Wave& w = WAVES[k];
  const cudaError_t err = allow_stage(k, device);
  if (err != cudaSuccess) return err;
  const long long threads = static_cast<long long>(B) * g;
  const unsigned grid = static_cast<unsigned>((threads + w.block - 1) / w.block);
  const int stage = w.stage_max / MAX_G * g;
  w.kernel<<<grid, w.block, stage, stream>>>(static_cast<const int8_t*>(profile), static_cast<const int8_t*>(subjT),
                                              static_cast<int32_t*>(carry), static_cast<int32_t*>(out), n_bands, B,
                                              n_segs, seg_cols, gap, g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch a variant on `stream` of `device`; return cudaGetLastError() (0 =
// launched), or cudaErrorInvalidValue for a variant that is not compiled.
// g > 0: K4's wavefront at (height, block) with g bands a pass (depth 1,
// skip NONE); g = 0: K1's band sweep at (height, block) = (64, 64) with the
// (depth, skip) of K5 or K6, n_bands counting K1's 32-row bands.
int sw_wave_lab_launch(const void* profile, const void* subjT, void* carry, void* out, int n_bands, int B,
                       int n_segs, int seg_cols, int gap, int height, int block, int depth, int skip, int g,
                       int device, void* stream) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  if (g > 0) {
    const int k = wave_index(height, block);
    if (k < 0 || g > MAX_G || (g & (g - 1)) || depth != 1 || skip != NONE)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(launch_wave(k, device, s, profile, subjT, carry, out, n_bands, B, n_segs, seg_cols, gap,
                                        g));
  }
  const Kernel kernel = sweep_kernel(depth, skip);
  if (height != SWEEP_H || block != BAND_BLOCK || kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const long long threads = static_cast<long long>(B) * n_segs;
  const unsigned grid = static_cast<unsigned>((threads + BAND_BLOCK - 1) / BAND_BLOCK);
  kernel<<<grid, BAND_BLOCK, SWEEP_STAGE, s>>>(static_cast<const int8_t*>(profile), static_cast<const int8_t*>(subjT),
                                               static_cast<int32_t*>(carry), static_cast<int32_t*>(out), n_bands, B,
                                               n_segs, seg_cols, gap);
  return static_cast<int>(cudaGetLastError());
}

// Blocks an SM (the runtime's occupancy for its registers, threads and
// shared memory) into *blocks: for g > 0, of K4's (height, block) wavefront
// with g bands a pass at its stage of g bands (depth 1, skip NONE); for
// g = 0, of the band sweep's (depth, skip) at (height, block) = (64, 64).
int sw_wave_lab_blocks_per_sm(int height, int block, int depth, int skip, int g, int device, int* blocks) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (g == 0) {
    const Kernel kernel = sweep_kernel(depth, skip);
    if (height != SWEEP_H || block != BAND_BLOCK || kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, BAND_BLOCK, SWEEP_STAGE));
  }
  const int k = wave_index(height, block);
  if (k < 0 || g < 1 || g > MAX_G || (g & (g - 1)) || depth != 1 || skip != NONE)
    return static_cast<int>(cudaErrorInvalidValue);
  err = allow_stage(k, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, WAVES[k].kernel, block, WAVES[k].stage_max / MAX_G * g));
}

const char* sw_wave_lab_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
