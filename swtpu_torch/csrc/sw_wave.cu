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
// Two kernel families compute it, on the same schedules (below): int32
// cells (sw_wave_kernel, sw_band_kernel) and packed int16x2 cells
// (sw_wave16_kernel, sw_band16_kernel; the last part of this file).  The
// wrapper (ops/wave_sw.py) runs the int16x2 kernels for every launch without
// a hand-off whose gaps are at most 16,383, each followed by
// sw_rescore_kernel, which scores in int32 the entries they flagged; the
// int32 kernels run the hand-offs (their carry is an int32 contract with the
// caller) and wider gaps.
//
// What bounds it on this card.  The integer issue rate: 132 SMs x 4 x 32
// lanes x 1.98 GHz.  The int32 kernels do one cell a lane and instruction
// (VIADDMNMX and VIMNMX3 carry two operations each), so they can reach at
// most half of the packed rate of benchmark/swbench/peaks.py; the int16x2
// kernels do two cells a DPX instruction (VIADDMNMX.S16x2, VIMNMX3.S16x2):
// 205-216 SASS instructions a 64-cell linear column of the sweep's loop,
// 171-184 a 32-cell affine one.  Neither
// runs at its issue bound: the sweep has a few warps a scheduler (a bucket
// has tens of thousands of (lane, segment) pairs) and the wavefront of a
// narrow bucket one, so both wait on latencies -- the column's `up` chain,
// the loads of the subject byte and the carry, the shuffles -- that their
// few warps cannot hide (PERF.md gives the measured times and shares).
// Before the wavefront and the sweep, the kernel ran at 13-23% of the int32
// floor (PERF.md), because it waited on memory: one thread scored one
// (lane, segment) and walked every 32-row band of the query in turn,
// re-reading the column's subject byte and the previous band's bottom row
// from device memory and writing its own bottom row, at every column of
// every band; and a narrow bucket (a few hundred wide subjects) had a few
// hundred threads for the whole card.
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

// The int16x2 kernels.  A thread's band of 2P rows is P registers of two
// int16 cells: rows r and r + P, the upper half one column behind the lower,
// so a column's serial `up` chain is P DPX instructions long and each does
// two cells.  The profile is staged as int8 [residue][row]; one PRMT makes a
// pair's two sign-extended scores (the lower half's residue at column c, the
// upper's at c - 1).  In the wavefront the skew is two columns a band, and a
// segment boundary resets the lower half before a step and the upper half
// after it.  The carry between passes or bands is int16 (H, or H and F in
// one 32-bit slot): half the int32 kernels' bytes.  Scores stay exact:
// diag + s is the only add that can wrap (H >= 0, E and F >= -16,384 - ext
// with their -16,384 sentinels), and one step raises H by at most 127 over
// the running best, so while an entry's best stays at or below 32,767 - 127
// = 32,640 (SAT16) none of its values has wrapped.  An entry whose int16
// best passes SAT16 is written as FLAG (-1), which no score can be, and the
// rescore launch that follows on the same stream scores exactly those in
// int32 before anything reads `out`: no host sync, one launch more, and a
// launch with nothing flagged costs one read of `out`.
//
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
// The int16x2 kernels (below): a best above SAT16 may have wrapped, so its
// entry is flagged (FLAG in out) and rescored in int32.  One step raises H
// by at most 127 over the running best, so below that nothing has wrapped.
constexpr int SAT16 = 32767 - 127;
constexpr int FLAG = -1;
constexpr int NEG16 = -16384;                  // minus infinity of E and F in int16
constexpr uint32_t NEG16X2 = 0xC000C000u;      // NEG16 in both halves
constexpr uint32_t FLOOR16X2 = 0x80008000u;    // -32768 in both halves
constexpr int SENT = A;                        // the int16 stage's sentinel residue: -128 on every row
constexpr int RESCORE_G = 16;                  // the rescore's wavefront: 16 bands a pass
constexpr int RESCORE_SLOTS = BLOCK / RESCORE_G;  // entries a rescore block scores at once
constexpr int RESCORE_SPAN = 1024;             // (lane, segment) entries a rescore block scans
constexpr int PREFETCH_STEPS = 8;              // steps ahead the int16x2 wavefront's first thread prefetches

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

// One lane group's run of the int32 wavefront over a launch's passes: the
// body of sw_wave_kernel, and of sw_rescore_kernel for one gathered (lane,
// segment).  `col` is the lane's first subject byte (columns B apart), `cc`
// its first carry slot (columns cc_stride apart), `o` its first output slot
// (one a segment).  gap is the linear penalty, or the affine open penalty
// with ext beside it.
template <bool AFFINE, bool HAND_OFF, int G>
__device__ __forceinline__ void wave_lane(int32_t* sprof, const int8_t* __restrict__ profile, const int8_t* col,
                                          typename Carry<AFFINE>::Slot* cc, size_t cc_stride, int32_t* o, int rows,
                                          int B, int n_segs, int seg_cols, int gap, int ext, bool has_top_in,
                                          bool put_last, bool active) {
  constexpr int H = WH;
  using Slot = typename Carry<AFFINE>::Slot;
  using S = Stage<H>;
  const int pass_rows = G * H;
  const int n_pass = (rows + pass_rows - 1) / pass_rows;
  const int total_cols = n_segs * seg_cols;
  const int b = threadIdx.x % G;  // this thread's band in the pass

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
          a_next = col[static_cast<size_t>(t + 1) * B] & (A - 1);
          if (top_in) top_next = cc[static_cast<size_t>(t + 1) * cc_stride];
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
          if (put_bottom) cc[static_cast<size_t>(c) * cc_stride] = make_int2(bottom, bottom_f);
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
          if (put_bottom) cc[static_cast<size_t>(c) * cc_stride] = bottom;
        }
        top_prev = r_h;
        const int cb = max(best, r_cb);
        if (++sc == seg_cols) {  // the segment's last column: its best over this pass's bands is cb
          if (put_best) o[seg] = pass > 0 ? max(o[seg], cb) : cb;
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
  using Slot = typename Carry<AFFINE>::Slot;
  extern __shared__ int4 smem[];
  const int rows = n_bands * 32;
  const int n_pass = (rows + G * WH - 1) / (G * WH);
  const size_t query = blockIdx.y;
  profile += query * static_cast<size_t>(rows) * A;
  out += query * static_cast<size_t>(B) * n_segs;
  if (!HAND_OFF && n_pass > 1) carry += query * static_cast<size_t>(n_segs) * seg_cols * B;  // a hand-off has one query
  const int lane = blockIdx.x * (BLOCK / G) + threadIdx.x / G;
  const bool active = lane < B;  // lanes past B compute on lane B - 1's data and store nothing
  const int ln = active ? lane : B - 1;
  // Opaque copies keep the column pointers in registers (ptxas otherwise
  // rebuilt the carry pointer from SR_CTAID.Y in every column of an earlier
  // version of this kernel, which made it 1.5x slower).
  unsigned long long cc_addr = reinterpret_cast<unsigned long long>(carry + ln);
  asm volatile("mov.b64 %0, %0;" : "+l"(cc_addr));
  wave_lane<AFFINE, HAND_OFF, G>(reinterpret_cast<int32_t*>(smem), profile, subjT + ln, reinterpret_cast<Slot*>(cc_addr),
                                 B, out + static_cast<size_t>(ln) * n_segs, rows, B, n_segs, seg_cols, gap, ext,
                                 has_top_in, put_last, active);
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

// The exact rescore of the entries the int16x2 kernels flagged, one launch
// after each of theirs on the same stream: block (x, q) scans RESCORE_SPAN
// (lane, segment) entries of query q's output for FLAG and scores the ones
// it finds with the int32 wavefront at G = 16, RESCORE_SLOTS entries at a
// time, each entry its own segment alone (n_segs 1, its seg_cols columns).
// A block that finds none returns after the scan, so a launch with nothing
// flagged costs one read of `out`.  Each block adds its count to
// `rescored`, a running total on the device.  `carry` holds seg_cols x
// RESCORE_SLOTS slots a block, used when the query needs more than one pass.
template <bool AFFINE>
__global__ void __launch_bounds__(BLOCK)
sw_rescore_kernel(const int8_t* __restrict__ profile, const int8_t* __restrict__ subjT,
                  typename Carry<AFFINE>::Slot* __restrict__ carry, int32_t* __restrict__ out,
                  unsigned long long* __restrict__ rescored, int n_bands, int B, int n_segs, int seg_cols, int gap,
                  int ext) {
  using Slot = typename Carry<AFFINE>::Slot;
  __shared__ int found[RESCORE_SPAN];
  __shared__ int n_found;
  extern __shared__ int4 smem[];
  const int rows = n_bands * 32;
  const size_t query = blockIdx.y;
  const long long n = static_cast<long long>(B) * n_segs;
  profile += query * static_cast<size_t>(rows) * A;
  out += query * n;
  const long long lo = static_cast<long long>(blockIdx.x) * RESCORE_SPAN;
  const int span = static_cast<int>(min(static_cast<long long>(RESCORE_SPAN), n - lo));
  if (threadIdx.x == 0) n_found = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < span; i += BLOCK)
    if (out[lo + i] == FLAG) found[atomicAdd(&n_found, 1)] = i;
  __syncthreads();
  const int nf = n_found;
  if (nf == 0) return;
  if (threadIdx.x == 0) atomicAdd(rescored, static_cast<unsigned long long>(nf));
  const int slot = threadIdx.x / RESCORE_G;
  Slot* cc = carry + (query * gridDim.x + blockIdx.x) * static_cast<size_t>(seg_cols) * RESCORE_SLOTS + slot;
  for (int r = 0; r < nf; r += RESCORE_SLOTS) {
    const bool active = r + slot < nf;  // idle slots score the round's first entry and store nothing
    const long long e = lo + found[active ? r + slot : r];
    const int lane = static_cast<int>(e / n_segs), seg = static_cast<int>(e % n_segs);
    wave_lane<AFFINE, false, RESCORE_G>(reinterpret_cast<int32_t*>(smem), profile,
                                        subjT + static_cast<size_t>(seg) * seg_cols * B + lane, cc, RESCORE_SLOTS,
                                        out + e, rows, B, 1, seg_cols, gap, ext, false, false, active);
  }
}

// ---- The int16x2 kernels (their design: at the top of this file) ----------
//
// Packed pair k holds (row k at column c, row P + k at column c - 1); its
// `up` input is (the row above k at c, row P + k - 1 at c - 1), and pair 0's
// is (the band's top at c, row P - 1 at c - 1: the lower half's bottom one
// step earlier).  The profile is staged as int8, [residue][row], and a
// pair's two scores (the lower half's residue at c, the upper's at c - 1)
// come from one PRMT that sign-extends a byte of each.  Column -1 of the
// upper half and column seg_cols of the lower are scored against a sentinel
// residue whose every row is -128, with zero left, diagonal and top
// inputs, so they stay 0 (or below the values before them) and move no
// best; the first is overwritten at the next segment boundary.

template <bool AFFINE> struct Carry16 { using Slot = uint16_t; };  // the band's bottom H
template <> struct Carry16<true> { using Slot = uint32_t; };        // bottom H (low half) and F (high half)

// Shared layout of one band: [residue][row] int8, rows padded to stride
// H + 16 (16-byte aligned), the 32 residues and the sentinel SENT.
template <int H> struct Stage16 {
  static constexpr int STRIDE = H + 16;
  static constexpr int BAND = (A + 1) * STRIDE + 16;
  static constexpr int bytes(int g) { return g * BAND; }
};

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}
__device__ __forceinline__ int lo16(uint32_t v) { return static_cast<int16_t>(v & 0xffffu); }
__device__ __forceinline__ int hi16(uint32_t v) { return static_cast<int>(v) >> 16; }
__device__ __forceinline__ uint32_t splat16(int v) { return (static_cast<uint32_t>(v) & 0xffffu) * 0x10001u; }
// A packed (lower, upper) pair from the low halves of two words.
__device__ __forceinline__ uint32_t lows(uint32_t lo, uint32_t hi) { return prmt(lo, hi, 0x5410u); }
// The high halves of two words as one pair.
__device__ __forceinline__ uint32_t highs(uint32_t lo, uint32_t hi) { return prmt(lo, hi, 0x7632u); }

// Bring a line of device memory into L1 ahead of its load (no register waits on it).
__device__ __forceinline__ void prefetch_l1(const void* p) { asm volatile("prefetch.global.L1 [%0];" :: "l"(p)); }
// One step of a thread's band: its P packed pairs, the lower half's scores
// from `sl` (rows 0..P-1 at its residue) and the upper half's from `su`
// (rows P..2P-1 at its own), and the packed running best.  Each pair is
// max(diag + s, left - gap, up - gap, 0) (linear), or Gotoh's H with its E
// and F (affine).  First every pair's terms that do not depend on `up` --
// they read the previous column's H (diag, left) and E -- then the `up`
// chain, one DPX instruction a pair (two under affine gaps), writing H in
// place: so H keeps its registers from step to step, with no copies, and
// the chain is as short as it can be.  Two running bests halve the chain of
// the best's VIMNMX3.  The relu's third operand is -gap, not a literal 0,
// which ptxas would build in a register for every pair (max(left - gap,
// -gap, 0) is max(left - gap, 0)).  e - ext and fup - ext are adds with a
// max against -32768, which changes nothing: E and F stay >= -16384 - ext.
template <bool AFFINE, int P>
__device__ __forceinline__ void column16(uint32_t (&h)[P], uint32_t (&e)[AFFINE ? P : 1], const int8_t* sl,
                                         const int8_t* su, uint32_t diag, uint32_t up, uint32_t& fup, uint32_t& best,
                                         uint32_t g1, uint32_t g2) {
  static_assert(P % 16 == 0, "16 pairs a 16-byte load");
  uint32_t x[P];
#pragma unroll
  for (int q = 0; q < P / 16; ++q) {
    const int4 l = reinterpret_cast<const int4*>(sl)[q];
    const int4 u = reinterpret_cast<const int4*>(su)[q];
    const uint32_t lw[4] = {static_cast<uint32_t>(l.x), static_cast<uint32_t>(l.y), static_cast<uint32_t>(l.z),
                            static_cast<uint32_t>(l.w)};
    const uint32_t uw[4] = {static_cast<uint32_t>(u.x), static_cast<uint32_t>(u.y), static_cast<uint32_t>(u.z),
                            static_cast<uint32_t>(u.w)};
#pragma unroll
    for (int w = 0; w < 4; ++w) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 16 * q + 4 * w + i;
        // Bytes i of the two words, each with its sign replicated above it.
        const uint32_t s = prmt(lw[w], uw[w], 0xC480u + 0x1111u * i);
        const uint32_t d = k == 0 ? diag : h[k - 1];
        if constexpr (AFFINE) {
          e[k] = __viaddmax_s16x2(h[k], g1, __viaddmax_s16x2(e[k], g2, FLOOR16X2));  // E at this column
          x[k] = __viaddmax_s16x2_relu(d, s, e[k]);
        } else {
          x[k] = __viaddmax_s16x2(d, s, __viaddmax_s16x2_relu(h[k], g1, g1));
        }
      }
    }
  }
  uint32_t best2 = best;
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if constexpr (AFFINE) {
      fup = __viaddmax_s16x2(up, g1, __viaddmax_s16x2(fup, g2, FLOOR16X2));
      h[k] = __vmaxs2(x[k], fup);
    } else {
      h[k] = __viaddmax_s16x2(up, g1, x[k]);
    }
    up = h[k];
    if (k % 4 == 3) {
      if (k % 8 == 3) best = __vimax3_s16x2(best, h[k - 3], h[k - 2]), best = __vimax3_s16x2(best, h[k - 1], h[k]);
      else best2 = __vimax3_s16x2(best2, h[k - 3], h[k - 2]), best2 = __vimax3_s16x2(best2, h[k - 1], h[k]);
    }
  }
  best = __vmaxs2(best, best2);
}

// The warp wavefront on int16x2 cells (sw_wave_kernel's schedule): thread b
// of a group holds band b of a pass, 32 rows as 16 pairs, and at step t
// computes its lower half at column t - 2b and its upper half at t - 2b - 1.
// It hands thread b + 1 the upper half's residue, bottom H (and F) and the
// segment's running best, one shuffle each; thread b + 1's lower half needs
// them one step later, at the same column.  The running best is used one
// step after it arrives, when it covers the receiver's own two columns.  At
// a segment boundary the lower half starts the new segment while the upper
// half ends the old one: the lower half's state resets before the step and
// the upper half's after it, and the old segment's best (the lower half's,
// saved at its reset, with the upper half's and the bands above) goes on
// down the group, to out from the pass's last band.
template <bool AFFINE, int G>
__global__ void __launch_bounds__(BLOCK)
sw_wave16_kernel(const int8_t* __restrict__ profile, const int8_t* __restrict__ subjT,
                 typename Carry16<AFFINE>::Slot* __restrict__ carry, int32_t* __restrict__ out, int n_bands, int B,
                 int n_segs, int seg_cols, int gap, int ext) {
  static_assert(G > 1 && 32 % G == 0, "G divides a warp");
  constexpr int H = WH, P = H / 2;
  using Slot = typename Carry16<AFFINE>::Slot;
  using S = Stage16<H>;
  extern __shared__ int4 smem[];
  int8_t* sprof = reinterpret_cast<int8_t*>(smem);
  const int rows = n_bands * 32;
  const int pass_rows = G * H;
  const int n_pass = (rows + pass_rows - 1) / pass_rows;
  const int total_cols = n_segs * seg_cols;
  const size_t query = blockIdx.y;
  profile += query * static_cast<size_t>(rows) * A;
  out += query * static_cast<size_t>(B) * n_segs;
  if (n_pass > 1) carry += query * static_cast<size_t>(total_cols) * B;
  const int b = threadIdx.x % G;
  const int lane = blockIdx.x * (BLOCK / G) + threadIdx.x / G;
  const bool active = lane < B;  // lanes past B compute on lane B - 1's data and store nothing
  const int ln = active ? lane : B - 1;
  const int8_t* col = subjT + ln;
  unsigned long long cc_addr = reinterpret_cast<unsigned long long>(carry + ln);
  asm volatile("mov.b64 %0, %0;" : "+l"(cc_addr));
  Slot* cc = reinterpret_cast<Slot*>(cc_addr);
  int32_t* o = out + static_cast<size_t>(ln) * n_segs;
  const uint32_t g1 = splat16(-gap), g2 = splat16(-ext);
  for (int k = threadIdx.x; k < G * (H / 4); k += BLOCK)  // the sentinel residue, once
    reinterpret_cast<uint32_t*>(sprof + (k / (H / 4)) * S::BAND + SENT * S::STRIDE)[k % (H / 4)] = 0x80808080u;

  for (int pass = 0; pass < n_pass; ++pass) {
    const int row0 = pass * pass_rows;
    const int prow = min(pass_rows, rows - row0);
    const int nb = prow / H;
    __syncthreads();
    for (int k = threadIdx.x; k < prow * (A / 4); k += BLOCK) {
      const int row = k / (A / 4), a = (k % (A / 4)) * 4;
      int8_t* dst = sprof + (row / H) * S::BAND + a * S::STRIDE + row % H;
      const char4 v = *reinterpret_cast<const char4*>(profile + static_cast<size_t>(row0 + row) * A + a);
      dst[0] = v.x;
      dst[S::STRIDE] = v.y;
      dst[2 * S::STRIDE] = v.z;
      dst[3 * S::STRIDE] = v.w;
    }
    __syncthreads();
    const int8_t* bprof = sprof + b * S::BAND;
    const bool real = b < nb;
    const bool first = b == 0;
    const bool last = b == nb - 1;
    const bool put_bottom = active && last && pass + 1 < n_pass;
    const bool put_best = active && last;
    const bool final_pass = pass + 1 == n_pass;
    const int steps = total_cols + 2 * nb - 1;

    uint32_t h[P];
    uint32_t e[AFFINE ? P : 1];
#pragma unroll
    for (int r = 0; r < P; ++r) {
      h[r] = 0;
      if constexpr (AFFINE) e[r] = NEG16X2;
    }
    uint32_t best = 0, top_prev = 0, hlast = 0, flast = NEG16X2;
    int low_best = 0, cb_late = 0, sc = 0, seg = 0, res_hold = SENT;
    int send_res = SENT, send_h = 0, send_f = NEG16, send_cb = 0;
    // The first thread's column t + 1 (residue and top) loads while column t computes.
    const bool top_in = first && pass > 0;
    int a_next = col[0] & (A - 1);
    Slot top_next = top_in ? cc[0] : static_cast<Slot>(AFFINE ? NEG16X2 & 0xffff0000u : 0u);

    for (int t = 0; t < steps; ++t) {
      int r_res = shfl_up1<G>(send_res);
      int r_h = shfl_up1<G>(send_h);
      int r_f = AFFINE ? shfl_up1<G>(send_f) : 0;
      int r_cb = shfl_up1<G>(send_cb);
      if (first) {
        r_res = a_next;
        r_cb = 0;
        r_h = static_cast<int>(top_next);
        r_f = static_cast<int>(top_next) >> 16;
        if (t + PREFETCH_STEPS < total_cols) {  // the lines of a later step, into L1
          prefetch_l1(col + static_cast<size_t>(t + PREFETCH_STEPS) * B);
          if (top_in) prefetch_l1(cc + static_cast<size_t>(t + PREFETCH_STEPS) * B);
        }
        if (t + 1 < total_cols) {
          a_next = col[static_cast<size_t>(t + 1) * B] & (A - 1);
          if (top_in) top_next = cc[static_cast<size_t>(t + 1) * B];
        } else {
          a_next = SENT;
        }
      }
      const int cb_in = cb_late;  // the bands above, over this step's two columns
      cb_late = r_cb;
      const int res_lo = r_res, res_hi = res_hold;
      res_hold = res_lo;
      const int c = t - 2 * b;  // the lower half's column
      if (real && c >= 0 && c <= total_cols) {
        if (sc == 0) {  // the lower half starts a segment (at total_cols, runs past the last)
          low_best = lo16(best);
#pragma unroll
          for (int r = 0; r < P; ++r) {
            h[r] &= 0xffff0000u;
            if constexpr (AFFINE) e[r] = (e[r] & 0xffff0000u) | (NEG16X2 & 0xffffu);
          }
          best &= 0xffff0000u;
          top_prev &= 0xffff0000u;
        }
        const uint32_t up = lows(static_cast<uint32_t>(r_h), hlast);
        uint32_t fup = AFFINE ? lows(static_cast<uint32_t>(r_f), flast) : 0u;
        column16<AFFINE, P>(h, e, bprof + res_lo * S::STRIDE, bprof + res_hi * S::STRIDE + P, top_prev, up, fup,
                            best, g1, g2);
        top_prev = up;
        hlast = h[P - 1];
        flast = fup;
        if (put_bottom && c > 0) {  // the upper half's bottom row, column c - 1
          if constexpr (AFFINE) cc[static_cast<size_t>(c - 1) * B] = highs(hlast, flast);
          else cc[static_cast<size_t>(c - 1) * B] = static_cast<uint16_t>(hlast >> 16);
        }
        int cb;
        if (sc == 0) {  // the upper half ended segment seg - 1 (at c = 0, scored column -1)
          cb = max(max(low_best, hi16(best)), cb_in);
          if (put_best && c > 0) {
            const int v = pass > 0 ? max(o[seg - 1], cb) : cb;
            o[seg - 1] = final_pass && v > SAT16 ? FLAG : v;
          }
#pragma unroll
          for (int r = 0; r < P; ++r) {
            h[r] &= 0xffffu;
            if constexpr (AFFINE) e[r] = (e[r] & 0xffffu) | (NEG16X2 & 0xffff0000u);
          }
          best &= 0xffffu;
          top_prev &= 0xffffu;
        } else {
          cb = max(max(lo16(best), hi16(best)), cb_in);
        }
        send_h = hi16(hlast);
        send_f = hi16(flast);
        send_cb = cb;
        if (++sc == seg_cols) {
          sc = 0;
          ++seg;
        }
      }
      send_res = res_hi;
    }
  }
}

// The band sweep on int16x2 cells (sw_band_kernel's schedule): a thread per
// (query, lane, segment), bands of H rows as H / 2 pairs, seg_cols + 1 steps
// a band (the upper half ends one column late).  The carry holds int16
// slots.  Under H = 64 a 32-row tail band has its real rows in the lower
// half and writes their bottom, row 31, at the lower half's column.
template <bool AFFINE, int H>
__global__ void __launch_bounds__(BAND_BLOCK)
sw_band16_kernel(const int8_t* __restrict__ profile, const int8_t* __restrict__ subjT,
                 typename Carry16<AFFINE>::Slot* __restrict__ carry, int32_t* __restrict__ out, int n_bands, int B,
                 int n_segs, int seg_cols, int gap, int ext) {
  constexpr int P = H / 2;
  using Slot = typename Carry16<AFFINE>::Slot;
  using S = Stage16<H>;
  extern __shared__ int4 smem[];
  int8_t* sprof = reinterpret_cast<int8_t*>(smem);
  const int rows = n_bands * 32;
  const int nb = (rows + H - 1) / H;
  const size_t query = blockIdx.y;
  const size_t slots = static_cast<size_t>(B) * n_segs;
  profile += query * static_cast<size_t>(rows) * A;
  out += query * slots;
  if (nb > 1) carry += query * seg_cols * slots;
  const long long t = static_cast<long long>(blockIdx.x) * BAND_BLOCK + threadIdx.x;
  const bool active = t < static_cast<long long>(B) * n_segs;
  const int seg = active ? static_cast<int>(t / B) : 0;
  const int lane = active ? static_cast<int>(t - static_cast<long long>(seg) * B) : 0;
  const size_t base = static_cast<size_t>(seg) * seg_cols * B + lane;
  const int8_t* col = subjT + base;
  unsigned long long cc_addr = reinterpret_cast<unsigned long long>(carry + base);
  asm volatile("mov.b64 %0, %0;" : "+l"(cc_addr));
  Slot* cc = reinterpret_cast<Slot*>(cc_addr);
  const uint32_t g1 = splat16(-gap), g2 = splat16(-ext);
  for (int k = threadIdx.x; k < H / 4; k += BAND_BLOCK)  // the sentinel residue, once
    reinterpret_cast<uint32_t*>(sprof + SENT * S::STRIDE)[k] = 0x80808080u;
  uint32_t best = 0;

  for (int band = 0; band < nb; ++band) {
    __syncthreads();
    for (int k = threadIdx.x; k < H * (A / 4); k += BAND_BLOCK) {
      const int r = k / (A / 4), a = (k % (A / 4)) * 4;
      const int grow = band * H + r;
      int8_t* dst = sprof + a * S::STRIDE + r;
      const char4 v = grow < rows ? *reinterpret_cast<const char4*>(profile + static_cast<size_t>(grow) * A + a)
                                  : make_char4(-128, -128, -128, -128);
      dst[0] = v.x;
      dst[S::STRIDE] = v.y;
      dst[2 * S::STRIDE] = v.z;
      dst[3 * S::STRIDE] = v.w;
    }
    __syncthreads();
    if (!active) continue;
    const bool has_top = band > 0;
    const bool put_bottom = band + 1 < nb;
    const bool tail = H > 32 && rows - band * H < H;
    uint32_t h[P];
    uint32_t e[AFFINE ? P : 1];
#pragma unroll
    for (int r = 0; r < P; ++r) {
      h[r] = 0;
      if constexpr (AFFINE) e[r] = NEG16X2;
    }
    uint32_t top_prev = 0, hlast = 0, flast = NEG16X2;
    int res_hold = SENT;
    // Columns j + 1 and j + 2 (residue and top) load while column j
    // computes.  Past the segment, the last column's top stays: no best
    // moves.
    int a_n1 = col[0] & (A - 1);
    int a_n2 = seg_cols > 1 ? col[B] & (A - 1) : SENT;
    uint32_t t_n1 = has_top ? cc[0] : (AFFINE ? NEG16X2 & 0xffff0000u : 0u);
    uint32_t t_n2 = has_top && seg_cols > 1 ? cc[B] : t_n1;
    const int8_t* c_ld = col + 2 * static_cast<size_t>(B);  // column j + 2's subject byte and top
    const Slot* t_ld = cc + 2 * static_cast<size_t>(B);
    Slot* st = cc;  // column j's carry slot
    for (int j = 0; j <= seg_cols; ++j, st += B) {
      const int res_lo = a_n1, res_hi = res_hold;
      res_hold = res_lo;
      const uint32_t top = t_n1;
      a_n1 = a_n2;
      t_n1 = t_n2;
      if (j + 2 < seg_cols) {
        a_n2 = *c_ld & (A - 1);
        if (has_top) t_n2 = *t_ld;
        c_ld += B;
        t_ld += B;
      } else {
        a_n2 = SENT;
      }
      const uint32_t up = lows(top, hlast);
      uint32_t fup = AFFINE ? prmt(top, flast, 0x5432u) : 0u;  // (the top's F, row P - 1's F at j - 1)
      column16<AFFINE, P>(h, e, sprof + res_lo * S::STRIDE, sprof + res_hi * S::STRIDE + P, top_prev, up, fup, best,
                          g1, g2);
      top_prev = up;
      hlast = h[P - 1];
      flast = fup;
      if (put_bottom) {
        if (tail) {
          if (j < seg_cols) {
            if constexpr (AFFINE) *st = lows(hlast, flast);
            else *st = static_cast<uint16_t>(hlast);
          }
        } else if (j > 0) {
          if constexpr (AFFINE) st[-B] = highs(hlast, flast);
          else st[-B] = static_cast<uint16_t>(hlast >> 16);
        }
      }
    }
  }
  if (active) {
    const int v = max(lo16(best), hi16(best));
    out[static_cast<size_t>(lane) * n_segs + seg] = v > SAT16 ? FLAG : v;
  }
}

// The (G, H) shapes compiled, each for linear and affine gaps and for the
// int32 and int16x2 kernels (ops/wave_sw.py SHAPES): the wavefront at H = 32,
// and G = 1, the band sweep.
#define SW_WAVE_SHAPES(X) X(16, 32) X(8, 32) X(4, 32) X(2, 32) X(1, 32) X(1, 64)

constexpr int MAX_DEVICES = 64;  // devices whose shared-memory attribute is remembered as set

// Raise a kernel's dynamic shared memory limit to `smem`, once a device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem, int device, std::atomic<bool> (&set)[MAX_DEVICES]) {
  if (device < MAX_DEVICES && set[device].load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && device < MAX_DEVICES) set[device].store(true, std::memory_order_relaxed);
  return err;
}

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
  const cudaError_t err = allow_smem(kernel, smem, device, smem_set);
  if (err != cudaSuccess) return err;
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const int8_t*>(profile), static_cast<const int8_t*>(subjT),
      static_cast<typename Carry<AFFINE>::Slot*>(carry), static_cast<int32_t*>(out), n_bands, B, n_segs,
      seg_cols, gap, ext, has_top_in != 0, put_last != 0);
  return cudaGetLastError();
}

template <bool AFFINE, int G, int H>
cudaError_t launch_shape16(int n_queries, cudaStream_t stream, const void* profile, const void* subjT, void* carry,
                           void* out, int n_bands, int B, int n_segs, int seg_cols, int gap, int ext) {
  static_assert(G == 1 || H == WH, "the wavefront's bands are 32 rows");
  decltype(&sw_band16_kernel<AFFINE, H>) kernel;
  if constexpr (G == 1) kernel = sw_band16_kernel<AFFINE, H>;
  else kernel = sw_wave16_kernel<AFFINE, G>;
  const int block = G == 1 ? BAND_BLOCK : BLOCK;
  const long long threads = G == 1 ? static_cast<long long>(B) * n_segs : static_cast<long long>(B) * G;
  const dim3 grid(static_cast<unsigned>((threads + block - 1) / block), static_cast<unsigned>(n_queries));
  static_assert(Stage16<H>::bytes(16) <= 48 * 1024, "the int16 stage fits the default shared memory limit");
  kernel<<<grid, block, Stage16<H>::bytes(G), stream>>>(
      static_cast<const int8_t*>(profile), static_cast<const int8_t*>(subjT),
      static_cast<typename Carry16<AFFINE>::Slot*>(carry), static_cast<int32_t*>(out), n_bands, B, n_segs, seg_cols,
      gap, ext);
  return cudaGetLastError();
}

template <bool AFFINE>
cudaError_t launch_rescore(int device, int n_queries, int blocks, cudaStream_t stream, const void* profile,
                           const void* subjT, void* carry, void* out, void* rescored, int n_bands, int B, int n_segs,
                           int seg_cols, int gap, int ext) {
  const int smem = Stage<WH>::bytes(RESCORE_G);
  static std::atomic<bool> smem_set[MAX_DEVICES];
  const cudaError_t err = allow_smem(sw_rescore_kernel<AFFINE>, smem, device, smem_set);
  if (err != cudaSuccess) return err;
  sw_rescore_kernel<AFFINE><<<dim3(blocks, n_queries), BLOCK, smem, stream>>>(
      static_cast<const int8_t*>(profile), static_cast<const int8_t*>(subjT),
      static_cast<typename Carry<AFFINE>::Slot*>(carry), static_cast<int32_t*>(out),
      static_cast<unsigned long long*>(rescored), n_bands, B, n_segs, seg_cols, gap, ext);
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

template <bool AFFINE>
int launch16(const void* profile, const void* subjT, void* carry, void* rcarry, void* out, void* rescored,
             int n_queries, int n_bands, int B, int n_segs, int seg_cols, int gap, int ext, int g, int h,
             int rescore_blocks, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  err = cudaErrorInvalidValue;  // a shape this library was not compiled for
#define SW_WAVE_CASE(G, H)                                                                                   \
  if (g == G && h == H)                                                                                      \
    err = launch_shape16<AFFINE, G, H>(n_queries, s, profile, subjT, carry, out, n_bands, B, n_segs, seg_cols, \
                                       gap, ext);
  SW_WAVE_SHAPES(SW_WAVE_CASE)
#undef SW_WAVE_CASE
  if (err != cudaSuccess || rescore_blocks == 0) return static_cast<int>(err);
  return static_cast<int>(launch_rescore<AFFINE>(device, n_queries, rescore_blocks, s, profile, subjT, rcarry, out,
                                                 rescored, n_bands, B, n_segs, seg_cols, gap, ext));
}

}  // namespace

extern "C" {

// Launch the int32 kernel for `n_queries` queries on `stream` of `device`
// with G = `g` bands a pass of H = `h` rows each; return
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a shape
// not compiled.  Linear gaps: `carry` holds one int32 per slot.  Nonzero
// `has_top_in` / `put_last` hand the carry on (one query).
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

// Launch the int16x2 kernel at (G, H) = (`g`, `h`), then, unless
// `rescore_blocks` is 0, the int32 rescore of what it flagged on
// `rescore_blocks` x `n_queries` blocks (each RESCORE_SPAN entries), which
// adds its count to the uint64 at `rescored`.  `carry`: one int16 slot a
// column and lane (gaps 0..16383); `rcarry`: the rescore's int32 slots.
// Without the rescore, flagged entries read FLAG (-1).
int sw_wave16_launch(const void* profile, const void* subjT, void* carry, void* rcarry, void* out, void* rescored,
                     int n_queries, int n_bands, int B, int n_segs, int seg_cols, int gap, int g, int h,
                     int rescore_blocks, int device, void* stream) {
  return launch16<false>(profile, subjT, carry, rcarry, out, rescored, n_queries, n_bands, B, n_segs, seg_cols, gap,
                         0, g, h, rescore_blocks, device, stream);
}

// The same with affine gaps: `carry` holds (H, F) int16 pairs, `rcarry`
// int32 pairs.
int sw_wave16_affine_launch(const void* profile, const void* subjT, void* carry, void* rcarry, void* out,
                            void* rescored, int n_queries, int n_bands, int B, int n_segs, int seg_cols,
                            int gap_open, int gap_extend, int g, int h, int rescore_blocks, int device,
                            void* stream) {
  return launch16<true>(profile, subjT, carry, rcarry, out, rescored, n_queries, n_bands, B, n_segs, seg_cols,
                        gap_open, gap_extend, g, h, rescore_blocks, device, stream);
}

const char* sw_wave_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
