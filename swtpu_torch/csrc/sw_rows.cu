// Row-parallel Smith-Waterman scoring for Hopper (sm_90a): one query against
// row-major buckets of subjects, linear gaps, exact int32.
//
// Replaces the two row-parallel TPU kernels of swtpu/ops/pallas_sw.py:
//  * K2, _fused_kernel (launched by sw_score_bucket_fused, and through it by
//    the sw_score_bucket_fast16 clamp): a whole (C, B, L) stack of
//    same-shape buckets in one launch (grid axis y = bucket), where swtpu
//    maps the kernel over the stack;
//  * K3, _kernel (launched by sw_score_bucket): one (B, L) bucket, any B,
//    which here is K2's launch at C = 1.
// Both compute the contract of xla_sw.sw_score_bucket -- for every subject
// row b, the Smith-Waterman maximum of the (qpad, 32) int8 profile against
// the row's L residues (pads PAD_SUBJECT = 25) -- and not the TPU schedule:
// the one-hot MXU staging, the Kogge-Stone cummax, the u-space rebasing and
// the VMEM tiles are not carried over.  One __global__ template,
// sw_rows_kernel<G, H>, and one C entry point, sw_rows_launch, serve both.
//
// What bounds it on this card: int32 ALU operations, about 6 a padded cell
// (add, two max, subtract, clamp at 0, running-best max), at 33.45 T ops/s
// (132 SMs x 64 int32 lanes x 1.98 GHz, two operations an instruction:
// VIADDMNMX is an add then a max).  Memory is no limit: a column costs one
// subject byte per 32 cells.  The earlier design -- one thread a subject
// row, walking the query's 32-row bands one after another -- ran at 9-12% of
// that bound on P01008's row-path groups (PERF.md), because
//  * a launch had only B * C threads: a group of 64 to 1,408 rows filled a
//    few SMs with one or two warps each, and
//  * every band re-read the row's bytes and read the previous band's bottom
//    row from device memory and wrote its own, at every column.
//
// Design: a band-parallel warp wavefront with an on-chip carry, after K1's
// (sw_wave.cu), over row-major buckets.
//  * G threads of a warp score one subject row; a warp holds 32 / G rows.
//    Thread g of a group holds band g of the current pass -- 32 query rows
//    -- in registers, and a pass is G bands: 32 * G rows of the query.
//  * The group runs a skewed wavefront: at step t thread g computes column
//    t - g of its row.  At each step it hands its band's bottom H, the
//    column's residue and the running best to thread g + 1 with one shuffle
//    each (volatile PTX, issued by every lane where it stands: ptxas once
//    sank a shuffle into a branch on the lane and made a kernel 4x slower).
//  * Only the group's first thread reads the row: 16 bytes at a time (one
//    uint4 when L is a multiple of 16 and the rows are aligned, else byte by
//    byte into the same registers), one chunk ahead of the columns it
//    computes.
//  * Device memory is touched only at a pass boundary: the pass's first band
//    reads its top row from the global carry, and its last band writes its
//    bottom row there while bands remain.  A query of up to 32 * G rows (at
//    G = 16, 512: P01008's 15 bands) needs no carry at all.
//  * The running best of the row travels down the skew beside the bottom
//    row, so the pass's last band writes out[b] once, a max with the
//    earlier passes' best.
//  * The block stages the pass's G bands of the profile in shared memory,
//    transposed to [band][residue][row] int32 with a padded stride, once for
//    all its warps (they score the same query): a column's 32 scores are 8
//    16-byte loads.  G * 32 * 36 * 4 bytes (74 KB at G = 16) is dynamic
//    shared memory; the attribute is set once a device.
//  * A pass with fewer than G bands idles its extra threads.
//  * G = 1 is the band sweep: a thread a row walks the bands of H = 32 or
//    64 rows in turn, each band's bottom row handed to the next through the
//    global carry (one int32 per column and row, column-major across the
//    rows so a warp's access is one transaction).  It is the earlier design
//    at H = 32.  Profile rows past the query's end are staged as -2^28, so
//    with gap >= 0 a 64-row band over a 32-row tail cannot raise the best
//    (its last band writes no carry).
//  * The wrapper picks (G, H) for each launch (ops/bucket_sw.py:
//    rows_shape): the band sweep at H = 64 for launches of 20,480 rows x C
//    or more, and at H = 32 for a single band, else the wavefront with the
//    fewest power of two G >= the bands, at most 16.  On an H100 the two
//    schedules crossed between 8,193 and 32,768 rows x C on P01008's K2
//    groups, K3 batches and int16 launches (tools/rows_ab.py; PERF.md §6):
//    below, the wavefront took 0.14-0.67x of the H = 64 sweep's time; on
//    the stacks of 32,768 rows and more the sweep took 0.77-0.91x of the
//    wavefront's (why is not measured).  SW_ROWS_SHAPES lists the compiled
//    shapes, and the entry point refuses any other.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int A = 32;             // profile columns (padded alphabet)
constexpr int W = 32;             // query rows a band of the wavefront
constexpr int BLOCK = 128;        // threads a block of the wavefront: 128 / G rows
constexpr int BAND_BLOCK = 64;    // threads a block of the band sweep: small blocks spread a bucket
constexpr int CHUNK = 16;         // subject bytes a thread loads at once
constexpr int NEG_S = -(1 << 28); // the score of a profile row past the query's end

// Shared layout of one band: [residue][row] int32, rows padded to stride
// H + 4 (16-byte aligned), and bands 16 bytes apart modulo the 32 banks.
template <int H> struct Stage {
  static constexpr int STRIDE = H + 4;
  static constexpr int BAND = A * STRIDE + 4;
  static constexpr int bytes(int g) { return g * BAND * 4; }
};

// Passes over a launch's n_bands 32-row bands: G bands of H rows a pass.
template <int G, int H>
__host__ __device__ constexpr int n_passes(int n_bands) {
  return (n_bands * W + G * H - 1) / (G * H);
}

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
// blockIdx in every column (ptxas did that in sw_wave.cu, 1.5x slower).
template <typename T>
__device__ __forceinline__ T* opaque(T* p) {
  unsigned long long a = reinterpret_cast<unsigned long long>(p);
  asm volatile("mov.b64 %0, %0;" : "+l"(a));
  return reinterpret_cast<T*>(a);
}

// The warp wavefront (G > 1) over rows 0 .. B-1 of one bucket.
template <int G>
__device__ __forceinline__ void wave_rows(int32_t* sprof, const int8_t* __restrict__ profile,
                                          const int8_t* __restrict__ subj, int32_t* __restrict__ carry,
                                          int32_t* __restrict__ out, int n_bands, int B, int L, int gap,
                                          bool vec) {
  using S = Stage<W>;
  const int rows = n_bands * W;
  constexpr int pass_rows = G * W;
  const int n_pass = n_passes<G, W>(n_bands);
  const int g = threadIdx.x % G;  // this thread's band in the pass
  const int b = blockIdx.x * (BLOCK / G) + threadIdx.x / G;
  const bool active = b < B;  // rows past B compute on row B - 1's data and store nothing
  const int bb = active ? b : B - 1;
  const int8_t* row = opaque(subj + static_cast<size_t>(bb) * L);
  int32_t* cc = opaque(carry + bb);

  for (int pass = 0; pass < n_pass; ++pass) {
    const int row0 = pass * pass_rows;
    const int nb = min(pass_rows, rows - row0) / W;  // bands in this pass
    __syncthreads();  // every reader of the previous pass's profile is done
    stage<W, BLOCK>(sprof, profile, row0, nb * W, rows);
    __syncthreads();
    const int32_t* bprof = sprof + g * S::BAND;
    const bool real = g < nb;
    const bool first = g == 0;
    const bool last = g == nb - 1;
    const bool top_in = first && pass > 0;
    const bool put_bottom = active && last && pass + 1 < n_pass;
    const int steps = L + nb - 1;

    int h[W];
#pragma unroll
    for (int r = 0; r < W; ++r) h[r] = 0;
    int best = 0, top_prev = 0;
    // What this thread hands to thread g + 1: the residue of its last column,
    // its band's bottom H there and the row's running best.
    int send_res = 0, send_h = 0, send_cb = 0;
    // The first thread's row bytes, a chunk ahead, and column t + 1's top.
    uint4 cur = make_uint4(0u, 0u, 0u, 0u), nxt = cur;
    if (first) nxt = load_chunk(row, 0, L, vec);
    int top_next = top_in ? cc[0] : 0;

    for (int t0 = 0; t0 < steps; t0 += CHUNK) {
      if (first) {
        cur = nxt;
        if (t0 + CHUNK < L) nxt = load_chunk(row, t0 + CHUNK, L, vec);
      }
#pragma unroll 1
      for (int q = 0; q < CHUNK / 4; ++q) {
        const uint32_t word = q == 0 ? cur.x : q == 1 ? cur.y : q == 2 ? cur.z : cur.w;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int t = t0 + 4 * q + k;
          if (t < steps) {  // the same for every lane of the block
            int r_res = shfl_up1<G>(send_res);
            int r_h = shfl_up1<G>(send_h);
            int r_cb = shfl_up1<G>(send_cb);
            if (first) {
              r_res = (word >> (8 * k)) & (A - 1);
              r_h = top_next;
              r_cb = 0;
              if (top_in && t + 1 < L) top_next = cc[static_cast<size_t>(t + 1) * B];
            }
            const int c = t - g;
            if (real && c >= 0 && c < L) {
              const int4* s4 = reinterpret_cast<const int4*>(bprof + r_res * S::STRIDE);
              int diag = top_prev, up = r_h;
#pragma unroll
              for (int p = 0; p < W / 4; ++p) {
                const int4 s = s4[p];
                cell(h[4 * p + 0], s.x, diag, up, best, gap);
                cell(h[4 * p + 1], s.y, diag, up, best, gap);
                cell(h[4 * p + 2], s.z, diag, up, best, gap);
                cell(h[4 * p + 3], s.w, diag, up, best, gap);
              }
              if (put_bottom) cc[static_cast<size_t>(c) * B] = h[W - 1];
              top_prev = r_h;
              const int cb = max(best, r_cb);
              if (last && active && c == L - 1) out[b] = pass > 0 ? max(out[b], cb) : cb;
              send_h = h[W - 1];
              send_cb = cb;
            }
            send_res = r_res;
          }
        }
      }
    }
  }
}

// The band sweep (G = 1): a thread a row, bands of H rows in turn.
template <int H>
__device__ __forceinline__ void band_rows(int32_t* sprof, const int8_t* __restrict__ profile,
                                          const int8_t* __restrict__ subj, int32_t* __restrict__ carry,
                                          int32_t* __restrict__ out, int n_bands, int B, int L, int gap,
                                          bool vec) {
  using S = Stage<H>;
  const int rows = n_bands * W;
  const int nb = n_passes<1, H>(n_bands);
  const int b = blockIdx.x * BAND_BLOCK + threadIdx.x;
  const bool active = b < B;
  const int8_t* row = opaque(subj + static_cast<size_t>(active ? b : 0) * L);
  int32_t* cc = opaque(carry + (active ? b : 0));
  int best = 0;

  for (int band = 0; band < nb; ++band) {
    __syncthreads();  // every reader of the previous band's rows is done
    stage<H, BAND_BLOCK>(sprof, profile, band * H, H, rows);
    __syncthreads();
    if (!active) continue;  // idle threads still reach both barriers
    const bool has_top = band > 0;
    const bool put_bottom = band + 1 < nb;
    int h[H];
#pragma unroll
    for (int r = 0; r < H; ++r) h[r] = 0;
    int top_prev = 0;
    int top_next = has_top ? cc[0] : 0;
    uint4 next = load_chunk(row, 0, L, vec);
    for (int j0 = 0; j0 < L; j0 += CHUNK) {
      const uint4 cur = next;
      if (j0 + CHUNK < L) next = load_chunk(row, j0 + CHUNK, L, vec);
#pragma unroll 1
      for (int q = 0; q < CHUNK / 4; ++q) {
        const uint32_t word = q == 0 ? cur.x : q == 1 ? cur.y : q == 2 ? cur.z : cur.w;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int j = j0 + 4 * q + k;
          if (j < L) {
            const int a = (word >> (8 * k)) & (A - 1);
            const int top = top_next;
            // Column j + 1's top value loads while column j computes.
            if (has_top && j + 1 < L) top_next = cc[static_cast<size_t>(j + 1) * B];
            const int4* s4 = reinterpret_cast<const int4*>(sprof + a * S::STRIDE);
            int diag = top_prev, up = top;
#pragma unroll
            for (int p = 0; p < H / 4; ++p) {
              const int4 s = s4[p];
              cell(h[4 * p + 0], s.x, diag, up, best, gap);
              cell(h[4 * p + 1], s.y, diag, up, best, gap);
              cell(h[4 * p + 2], s.z, diag, up, best, gap);
              cell(h[4 * p + 3], s.w, diag, up, best, gap);
            }
            if (put_bottom) cc[static_cast<size_t>(j) * B] = h[H - 1];
            top_prev = top;
          }
        }
      }
    }
  }
  if (active) out[b] = best;
}

// K2 and K3: a (C, B, L) stack, grid (ceil(B * G / block), C); bucket c's
// carry is the c-th (L, B) slice, used only when the launch takes several
// passes.
template <int G, int H>
__global__ void __launch_bounds__(G == 1 ? BAND_BLOCK : BLOCK)
sw_rows_kernel(const int8_t* __restrict__ profile,  // (n_bands * 32, A)
               const int8_t* __restrict__ stack,    // (C, B, L)
               int32_t* __restrict__ carry,         // (C, L, B); unused if one pass
               int32_t* __restrict__ out,           // (C, B)
               int n_bands, int B, int L, int gap, bool vec) {
  extern __shared__ int4 smem[];
  int32_t* sprof = reinterpret_cast<int32_t*>(smem);
  const size_t c = blockIdx.y;
  const size_t cells = static_cast<size_t>(B) * L;
  int32_t* cc = n_passes<G, H>(n_bands) > 1 ? carry + c * cells : carry;
  if constexpr (G == 1) {
    band_rows<H>(sprof, profile, stack + c * cells, cc, out + c * B, n_bands, B, L, gap, vec);
  } else {
    static_assert(H == W && 32 % G == 0, "the wavefront's bands are 32 rows, and G divides a warp");
    wave_rows<G>(sprof, profile, stack + c * cells, cc, out + c * B, n_bands, B, L, gap, vec);
  }
}

// The (G, H) shapes compiled (ops/bucket_sw.py SHAPES): the wavefront at
// H = 32, and G = 1, the band sweep.
#define SW_ROWS_SHAPES(X) X(16, 32) X(8, 32) X(4, 32) X(2, 32) X(1, 32) X(1, 64)

constexpr int MAX_DEVICES = 64;  // devices whose shared-memory attribute is remembered as set

template <int G, int H>
cudaError_t launch_shape(int device, cudaStream_t stream, const void* profile, const void* stack, void* carry,
                         void* out, int n_chunks, int n_bands, int B, int L, int gap) {
  const auto kernel = sw_rows_kernel<G, H>;
  const int block = G == 1 ? BAND_BLOCK : BLOCK;
  const long long threads = static_cast<long long>(B) * G;
  const dim3 grid(static_cast<unsigned>((threads + block - 1) / block), static_cast<unsigned>(n_chunks));
  const int smem = Stage<H>::bytes(G);
  // Once a device per instantiation (setting it twice from two threads is harmless).
  static std::atomic<bool> smem_set[MAX_DEVICES];
  if (device >= MAX_DEVICES || !smem_set[device].load(std::memory_order_relaxed)) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (device < MAX_DEVICES) smem_set[device].store(true, std::memory_order_relaxed);
  }
  // Every row of every bucket is 16-byte aligned when the stack is and L % 16 == 0.
  const bool vec = L % CHUNK == 0 && reinterpret_cast<uintptr_t>(stack) % CHUNK == 0;
  kernel<<<grid, block, smem, stream>>>(static_cast<const int8_t*>(profile), static_cast<const int8_t*>(stack),
                                        static_cast<int32_t*>(carry), static_cast<int32_t*>(out), n_bands, B, L,
                                        gap, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K2 (and K3, at n_chunks = 1) for a (n_chunks, B, L) stack on `stream` of
// `device`, in passes of G = `g` bands of H = `h` rows; returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a shape
// not compiled.  `profile` is (n_bands * 32, 32) int8; `carry` holds
// n_chunks * B * L int32 when the launch takes more than one pass.
int sw_rows_launch(const void* profile, const void* stack, void* carry, void* out, int n_chunks, int n_bands, int B,
                   int L, int gap, int g, int h, int device, void* stream) {
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
#define SW_ROWS_CASE(G, H)                                                                                       \
  if (g == G && h == H)                                                                                          \
    return static_cast<int>(launch_shape<G, H>(device, s, profile, stack, carry, out, n_chunks, n_bands, B, L, gap));
  SW_ROWS_SHAPES(SW_ROWS_CASE)
#undef SW_ROWS_CASE
  return static_cast<int>(cudaErrorInvalidValue);  // a shape this library was not compiled for
}

const char* sw_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
