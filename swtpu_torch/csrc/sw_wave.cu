// Smith-Waterman database scoring for Hopper (sm_90a): linear or affine
// (Gotoh) gaps, one or Q queries against one transposed bucket of subjects,
// exact int32.
//
// Replaces the TPU kernel swtpu/ops/wave_sw.py::_wave_kernel (:815, launched
// by sw_wave) in its linear modes -- one query, unchained (n_segs = 1) and
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
// What bounds it on this card.  The int32 issue rate sets the floor: about 5
// SASS instructions a linear cell (VIADDMNMX and VIMNMX3 carry two
// operations each), 132 SMs x 64 lanes x 1.98 GHz.  Before this design the
// kernel ran at 13-23% of that floor in every mode (PERF.md), because it
// waited on memory: one thread scored one (lane, segment) and walked every
// 32-row band of the query in turn, re-reading the column's subject byte
// and the previous band's bottom row from device memory and writing its own
// bottom row, at every column of every band; and a narrow bucket (a few
// hundred wide subjects) had a few hundred threads for the whole card.
//
// Design: a band-parallel warp wavefront with an on-chip carry.
//  * A group of G threads of a warp scores one lane (all its chained
//    segments, end to end); a warp holds 32 / G lanes.  Thread b of a group
//    holds band b of the current pass -- 32 query rows -- in registers, and
//    a pass is G bands: 32 * G rows of the query.
//  * The group runs a skewed wavefront: at step t thread b computes column
//    t - b of the lane.  At each step it hands its band's bottom H (and F
//    under affine gaps), the column's residue and the segment's running best
//    to thread b + 1 with one shuffle each, so only the group's first
//    thread loads the subject, and the band-to-band carry never leaves the
//    registers.
//  * Device memory is touched only at a pass boundary: the pass's first band
//    reads its top row from the global carry (for passes after the first,
//    and under the hand-off's has_top_in), and its last band writes its
//    bottom row there (when bands remain, and under put_last).  So a query
//    of up to 32 * G rows needs no global carry at all, and a longer one
//    moves 1 / G of the carry and subject bytes that one band at a time did.
//  * A narrow bucket gets G threads a lane instead of one a (lane, segment):
//    the parallelism its few blocks lacked.
//  * The wavefront runs through a lane's segments end to end: each thread
//    resets its band's state at a segment's first column, so the skew's fill
//    (G - 1 columns) is paid once a pass and not once a segment.  The
//    running best of each segment travels down the skew beside the bottom
//    row, so the pass's last band writes out[lane * n_segs + seg] once (a max
//    with the earlier passes' partial best).
//  * The block stages the pass's G bands of the profile in shared memory,
//    transposed to [band][residue][row] int32 with a padded stride, once for
//    all its warps (they score the same query): a column's 32 scores are 8
//    16-byte loads.  G * 32 * 32 * 4 bytes is dynamic shared memory.
//  * A pass with fewer than G bands idles its extra threads; every thread
//    issues every shuffle, so nothing diverges around one (the shuffles are
//    volatile PTX: ptxas once sank a shuffle into a branch on the lane in
//    another kernel of this package and made it 4x slower).
//  * G is a template parameter, and the wrapper picks the shape (G, H) of
//    each launch (ops/wave_sw.py: wave_shape); the C entry point dispatches
//    to the instantiated shapes (SW_WAVE_SHAPES) and refuses any other.
//    G = 1 is the band sweep (sw_band_kernel, below): a thread per (lane,
//    segment), band after band of H = 32 or 64 rows through the global
//    carry.  The wrapper takes it for single-band launches, and on buckets
//    of many (lane, segment) pairs, where it beat the wavefront on an H100
//    (wave_ab.py; the crossover, measured bucket by bucket, is in PERF.md);
//    why the wavefront loses there is not measured.
//
// Affine mode (template parameter AFFINE): E(r,j) = max(H(r,j-1) - open,
// E(r,j-1) - ext) is row-local and crosses columns, so each row keeps an E
// register beside its H; F(r,j) = max(H(r-1,j) - open, F(r-1,j) - ext) runs
// down the band beside `up` and crosses bands in the shuffle and the carry;
// H = max(0, diag + S, E, F).  The carry slot holds the band's bottom H and
// F interleaved (one 8-byte load and store per column).  E at a segment's
// first column and F above band 0 are NEG, as in swtpu; with H >= 0 every
// later E and F is >= -open, so NEG - ext cannot wrap.
//
// Carry hand-off (template parameter HAND_OFF, and two runtime flags): a
// query's bands can run as a chain of launches, each launch a group of
// bands.  With has_top_in, band 0 reads its top boundary from the carry
// instead of H = 0 (and F = NEG); with put_last, the last band also writes
// its bottom row there.  The carry is then an input and an output: (n_segs *
// seg_cols, B) int32 H, or int2 (H, F) slots in affine mode, row = the
// bucket column.  It is overwritten in place, column j's bottom after column
// j's top is read, so one buffer a bucket serves the whole chain.  A
// hand-off launch scores one query, as in swtpu (the wrapper refuses a
// profile stack).  A launch with either flag runs the HAND_OFF
// instantiation, so the fused modes carry no flag tests (runtime flags cost
// them 7% in an earlier version of this kernel).

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int A = 32;                // profile columns (padded alphabet)
constexpr int BLOCK = 128;           // threads a block of the wavefront: 128 / G lanes
constexpr int WH = 32;               // rows a band of the wavefront
constexpr int BAND_BLOCK = 64;       // threads a block of the band sweep: small blocks spread a bucket
constexpr int NEG = -(1 << 30);      // minus infinity of the affine E and F boundaries
constexpr int NEG_S = -(1 << 28);    // the score of a profile row past the query's end

// One carry slot per column and lane: the band's bottom H, and in affine
// mode its bottom F beside it.
template <bool AFFINE> struct Carry { using Slot = int32_t; };
template <> struct Carry<true> { using Slot = int2; };

// Shared layout of one band: [residue][row] int32, rows padded to stride
// H + 4 (16-byte aligned), and bands 16 bytes apart modulo the 32 banks.
template <int H> struct Stage {
  static constexpr int STRIDE = H + 4;
  static constexpr int BAND = A * STRIDE + 4;
  static constexpr int bytes(int g) { return g * BAND * 4; }
};

// __shfl_up_sync(~0u, v, 1, G) as volatile PTX: every lane issues it where
// it stands in the source.
template <int G>
__device__ __forceinline__ int shfl_up1(int v) {
  int r;
  asm volatile("shfl.sync.up.b32 %0, %1, 1, %2, -1;" : "=r"(r) : "r"(v), "n"((32 - G) << 8));
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
template <bool AFFINE, bool HAND_OFF, int G>
__global__ void __launch_bounds__(BLOCK)
sw_wave_kernel(const int8_t* __restrict__ profile,                   // (Q, n_bands * 32, A)
               const int8_t* __restrict__ subjT,                     // (L2, B)
               typename Carry<AFFINE>::Slot* __restrict__ carry,     // (Q, n_segs * seg_cols, B); unused if
                                                                     // one pass and neither flag is set
               int32_t* __restrict__ out,                            // (Q, B * n_segs)
               int n_bands, int B, int n_segs, int seg_cols, int gap, int ext, bool has_top_in,
               bool put_last) {
  static_assert(G > 1 && 32 % G == 0, "G divides a warp");
  constexpr int H = WH;
  using Slot = typename Carry<AFFINE>::Slot;
  using S = Stage<H>;
  extern __shared__ int4 smem[];
  int32_t* sprof = reinterpret_cast<int32_t*>(smem);
  const int rows = n_bands * 32;
  const int pass_rows = G * H;
  const int n_pass = (rows + pass_rows - 1) / pass_rows;
  const int total_cols = n_segs * seg_cols;
  const size_t query = blockIdx.y;
  profile += query * static_cast<size_t>(rows) * A;
  out += query * static_cast<size_t>(B) * n_segs;
  if (!HAND_OFF && n_pass > 1) carry += query * static_cast<size_t>(total_cols) * B;  // a hand-off has one query
  const int b = threadIdx.x % G;  // this thread's band in the pass
  const int lane = blockIdx.x * (BLOCK / G) + threadIdx.x / G;
  const bool active = lane < B;  // lanes past B compute on lane B - 1's data and store nothing
  const int ln = active ? lane : B - 1;
  const int8_t* col = subjT + ln;
  // Opaque copies keep the column pointers in registers (ptxas otherwise
  // rebuilt the carry pointer from SR_CTAID.Y in every column of an earlier
  // version of this kernel, which made it 1.5x slower).
  unsigned long long cc_addr = reinterpret_cast<unsigned long long>(carry + ln);
  asm volatile("mov.b64 %0, %0;" : "+l"(cc_addr));
  Slot* cc = reinterpret_cast<Slot*>(cc_addr);

  for (int pass = 0; pass < n_pass; ++pass) {
    const int row0 = pass * pass_rows;
    const int prow = min(pass_rows, rows - row0);
    const int nb = prow / H;            // bands in this pass
    __syncthreads();                    // every reader of the previous pass's profile is done
    for (int k = threadIdx.x; k < prow * (A / 4); k += BLOCK) {  // the pass's rows; idle bands stage nothing
      const int row = k / (A / 4), a = (k % (A / 4)) * 4;
      int32_t* dst = sprof + (row / H) * S::BAND + a * S::STRIDE + row % H;
      const char4 v = *reinterpret_cast<const char4*>(profile + static_cast<size_t>(row0 + row) * A + a);
      dst[0] = v.x;
      dst[S::STRIDE] = v.y;
      dst[2 * S::STRIDE] = v.z;
      dst[3 * S::STRIDE] = v.w;
    }
    __syncthreads();
    const int32_t* bprof = sprof + b * S::BAND;
    const bool real = b < nb;
    const bool first = b == 0;
    const bool last = b == nb - 1;
    const bool top_in = first && (pass > 0 || (HAND_OFF && has_top_in));
    const bool put_bottom = active && last && (pass + 1 < n_pass || (HAND_OFF && put_last));
    const bool put_best = active && last;
    const int steps = total_cols + nb - 1;

    int h[H];
    int e[AFFINE ? H : 1];
    int best = 0, top_prev = 0, sc = 0, seg = 0;
    // What this thread hands to thread b + 1: the residue of its last column,
    // its band's bottom H (and F) there and the segment's running best.
    int send_res = 0, send_h = 0, send_f = NEG, send_cb = 0;
    // The first thread's column t + 1 (residue and top) loads while column t computes.
    int a_next = col[0] & (A - 1);
    Slot top_next;
    if constexpr (AFFINE) top_next = top_in ? cc[0] : make_int2(0, NEG);
    else top_next = top_in ? cc[0] : 0;

    for (int t = 0; t < steps; ++t) {
      int r_res = shfl_up1<G>(send_res);
      int r_h = shfl_up1<G>(send_h);
      int r_f = AFFINE ? shfl_up1<G>(send_f) : 0;
      int r_cb = shfl_up1<G>(send_cb);
      if (first) {
        r_res = a_next;
        r_cb = 0;
        if constexpr (AFFINE) {
          r_h = top_next.x;
          r_f = top_next.y;
        } else {
          r_h = top_next;
        }
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
          for (int r = 0; r < H; ++r) {
            h[r] = 0;
            if constexpr (AFFINE) e[r] = NEG;
          }
          best = 0;
          top_prev = 0;
        }
        const int4* s4 = reinterpret_cast<const int4*>(bprof + r_res * S::STRIDE);
        int diag = top_prev, up = r_h, bottom, bottom_f = 0;
        if constexpr (AFFINE) {
          int fup = r_f;
#pragma unroll
          for (int q = 0; q < H / 4; ++q) {
            const int4 s = s4[q];
            cell_affine(h[4 * q + 0], e[4 * q + 0], s.x, diag, up, fup, best, gap, ext);
            cell_affine(h[4 * q + 1], e[4 * q + 1], s.y, diag, up, fup, best, gap, ext);
            cell_affine(h[4 * q + 2], e[4 * q + 2], s.z, diag, up, fup, best, gap, ext);
            cell_affine(h[4 * q + 3], e[4 * q + 3], s.w, diag, up, fup, best, gap, ext);
          }
          bottom = h[H - 1];
          bottom_f = fup;
          if (put_bottom) cc[static_cast<size_t>(c) * B] = make_int2(bottom, bottom_f);
        } else {
#pragma unroll
          for (int q = 0; q < H / 4; ++q) {
            const int4 s = s4[q];
            cell(h[4 * q + 0], s.x, diag, up, best, gap);
            cell(h[4 * q + 1], s.y, diag, up, best, gap);
            cell(h[4 * q + 2], s.z, diag, up, best, gap);
            cell(h[4 * q + 3], s.w, diag, up, best, gap);
          }
          bottom = h[H - 1];
          if (put_bottom) cc[static_cast<size_t>(c) * B] = bottom;
        }
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
        send_h = bottom;
        send_f = bottom_f;
        send_cb = cb;
      }
      send_res = r_res;
    }
  }
}

// The band sweep (shape G = 1): one thread per (query, lane, segment) walks
// the launch's bands of H rows in turn, each band's bottom row handed to the
// next through the global carry (one slot per column of the thread's own
// segment, read as the top boundary, then overwritten in place).  It beat
// the wavefront on buckets of many (lane, segment) pairs (PERF.md).
// Segments are threads, so chaining needs no resets.  Under H = 64 a
// profile with an odd number of 32-row bands ends in a 32-row tail band.
// Its thread computes H rows with the profile past the query's end staged
// as NEG_S: with gap >= 0 no such row can raise the running best (each of
// its values is 0 or a computed value minus a gap), and the thread writes
// its row-31 H (and F) as the band's bottom, so scores and carry are exact
// with no padded profile rows.
template <bool AFFINE, bool HAND_OFF, int H>
__global__ void __launch_bounds__(BAND_BLOCK)
sw_band_kernel(const int8_t* __restrict__ profile, const int8_t* __restrict__ subjT,
               typename Carry<AFFINE>::Slot* __restrict__ carry, int32_t* __restrict__ out, int n_bands, int B,
               int n_segs, int seg_cols, int gap, int ext, bool has_top_in, bool put_last) {
  using Slot = typename Carry<AFFINE>::Slot;
  using S = Stage<H>;
  extern __shared__ int4 smem[];
  int32_t* sprof = reinterpret_cast<int32_t*>(smem);
  const int rows = n_bands * 32;
  const int nb = (rows + H - 1) / H;
  const size_t query = blockIdx.y;
  const size_t slots = static_cast<size_t>(B) * n_segs;
  profile += query * static_cast<size_t>(rows) * A;
  out += query * slots;
  if (!HAND_OFF && nb > 1) carry += query * seg_cols * slots;
  const long long t = static_cast<long long>(blockIdx.x) * BAND_BLOCK + threadIdx.x;
  const bool active = t < static_cast<long long>(B) * n_segs;
  const int seg = active ? static_cast<int>(t / B) : 0;
  const int lane = active ? static_cast<int>(t - static_cast<long long>(seg) * B) : 0;
  const size_t base = static_cast<size_t>(seg) * seg_cols * B + lane;
  const int8_t* col = subjT + base;
  unsigned long long cc_addr = reinterpret_cast<unsigned long long>(carry + base);
  asm volatile("mov.b64 %0, %0;" : "+l"(cc_addr));
  Slot* cc = reinterpret_cast<Slot*>(cc_addr);
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
    const bool has_top = band > 0 || (HAND_OFF && has_top_in);
    const bool put_bottom = band + 1 < nb || (HAND_OFF && put_last);
    const bool tail = H > 32 && rows - band * H < H;
    if constexpr (AFFINE) {
      int h[H], e[H];
#pragma unroll
      for (int r = 0; r < H; ++r) {
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
        const int4* s4 = reinterpret_cast<const int4*>(sprof + a * S::STRIDE);
        int diag = top_prev, up = top.x, fup = top.y, f31 = 0;
#pragma unroll
        for (int q = 0; q < H / 4; ++q) {
          const int4 s = s4[q];
          cell_affine(h[4 * q + 0], e[4 * q + 0], s.x, diag, up, fup, best, gap, ext);
          cell_affine(h[4 * q + 1], e[4 * q + 1], s.y, diag, up, fup, best, gap, ext);
          cell_affine(h[4 * q + 2], e[4 * q + 2], s.z, diag, up, fup, best, gap, ext);
          cell_affine(h[4 * q + 3], e[4 * q + 3], s.w, diag, up, fup, best, gap, ext);
          if (4 * q + 3 == 31) f31 = fup;
        }
        if (put_bottom) cc[static_cast<size_t>(j) * B] = tail ? make_int2(h[31], f31) : make_int2(h[H - 1], fup);
        top_prev = top.x;
      }
    } else {
      int h[H];
#pragma unroll
      for (int r = 0; r < H; ++r) h[r] = 0;
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
        const int4* s4 = reinterpret_cast<const int4*>(sprof + a * S::STRIDE);
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
    }
  }
  if (active) out[static_cast<size_t>(lane) * n_segs + seg] = best;
}

// The (G, H) shapes compiled, each for linear and affine gaps (ops/wave_sw.py
// SHAPES): the wavefront at H = 32, and G = 1, the band sweep (sw_band_kernel).
#define SW_WAVE_SHAPES(X) X(16, 32) X(8, 32) X(4, 32) X(2, 32) X(1, 32) X(1, 64)

constexpr int MAX_DEVICES = 64;  // devices whose shared-memory attribute is remembered as set

template <bool AFFINE, bool HAND_OFF, int G, int H>
cudaError_t launch_shape(int device, int n_queries, cudaStream_t stream, const void* profile, const void* subjT,
                         void* carry, void* out, int n_bands, int B, int n_segs, int seg_cols, int gap, int ext,
                         int has_top_in, int put_last) {
  static_assert(G == 1 || H == WH, "the wavefront's bands are 32 rows");
  // The band sweep: a thread per (lane, segment).  The wavefront: G threads a lane.
  decltype(&sw_band_kernel<AFFINE, HAND_OFF, H>) kernel;
  if constexpr (G == 1) kernel = sw_band_kernel<AFFINE, HAND_OFF, H>;
  else kernel = sw_wave_kernel<AFFINE, HAND_OFF, G>;
  const int block = G == 1 ? BAND_BLOCK : BLOCK;
  const long long threads = G == 1 ? static_cast<long long>(B) * n_segs : static_cast<long long>(B) * G;
  const dim3 grid(static_cast<unsigned>((threads + block - 1) / block), static_cast<unsigned>(n_queries));
  const int smem = Stage<H>::bytes(G);
  // Once a device per instantiation (setting it twice from two threads is harmless).
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (device >= MAX_DEVICES || !smem_set[device].load(std::memory_order_relaxed)) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (device < MAX_DEVICES) smem_set[device].store(true, std::memory_order_relaxed);
  }
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const int8_t*>(profile), static_cast<const int8_t*>(subjT),
      static_cast<typename Carry<AFFINE>::Slot*>(carry), static_cast<int32_t*>(out), n_bands, B, n_segs,
      seg_cols, gap, ext, has_top_in != 0, put_last != 0);
  return cudaGetLastError();
}

template <bool AFFINE>
int launch(const void* profile, const void* subjT, void* carry, void* out, int n_queries, int n_bands, int B,
           int n_segs, int seg_cols, int gap, int ext, int has_top_in, int put_last, int g, int h, int device,
           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool hand_off = has_top_in || put_last;
  const auto s = static_cast<cudaStream_t>(stream);
#define SW_WAVE_CASE(G, H)                                                                                  \
  if (g == G && h == H)                                                                                     \
    return static_cast<int>(hand_off ? launch_shape<AFFINE, true, G, H>(device, n_queries, s, profile, subjT,   \
                                                                         carry, out, n_bands, B, n_segs,    \
                                                                         seg_cols, gap, ext, has_top_in,    \
                                                                         put_last)                          \
                                     : launch_shape<AFFINE, false, G, H>(device, n_queries, s, profile, subjT,  \
                                                                          carry, out, n_bands, B, n_segs,   \
                                                                          seg_cols, gap, ext, 0, 0));
  SW_WAVE_SHAPES(SW_WAVE_CASE)
#undef SW_WAVE_CASE
  return static_cast<int>(cudaErrorInvalidValue);  // a shape this library was not compiled for
}

}  // namespace

extern "C" {

// Launch for `n_queries` queries on `stream` of `device` with G = `g` bands
// a pass of H = `h` rows each; return cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a shape not compiled.  Linear gaps: `carry`
// holds one int32 per slot.  Nonzero `has_top_in` / `put_last` hand the
// carry on (one query).
int sw_wave_launch(const void* profile, const void* subjT, void* carry, void* out, int n_queries,
                   int n_bands, int B, int n_segs, int seg_cols, int gap, int has_top_in, int put_last, int g,
                   int h, int device, void* stream) {
  return launch<false>(profile, subjT, carry, out, n_queries, n_bands, B, n_segs, seg_cols, gap, 0, has_top_in,
                       put_last, g, h, device, stream);
}

// The same with affine gaps (a length-L gap costs gap_open + (L-1) *
// gap_extend): `carry` holds two int32 (H, F) per slot.
int sw_wave_affine_launch(const void* profile, const void* subjT, void* carry, void* out, int n_queries,
                          int n_bands, int B, int n_segs, int seg_cols, int gap_open, int gap_extend,
                          int has_top_in, int put_last, int g, int h, int device, void* stream) {
  return launch<true>(profile, subjT, carry, out, n_queries, n_bands, B, n_segs, seg_cols, gap_open,
                      gap_extend, has_top_in, put_last, g, h, device, stream);
}

const char* sw_wave_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
