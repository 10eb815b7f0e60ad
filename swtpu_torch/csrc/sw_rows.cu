// Row-parallel Smith-Waterman scoring for Hopper (sm_90a): one query against
// row-major buckets of subjects, linear gaps, exact int32.
//
// Replaces the two row-parallel TPU kernels of swtpu/ops/pallas_sw.py:
//  * K2, _fused_kernel (launched by sw_score_bucket_fused, and through it by
//    the sw_score_bucket_fast16 clamp): here sw_rows_fused_kernel, which
//    scores a whole (C, B, L) stack of same-shape buckets in one launch
//    (grid axis y = bucket), where swtpu maps the kernel over the stack;
//  * K3, _kernel (launched by sw_score_bucket): here sw_rows_kernel, one
//    (B, L) bucket, any B.
// Both compute the contract of xla_sw.sw_score_bucket -- for every subject
// row b, the Smith-Waterman maximum of the (qpad, 32) int8 profile against
// the row's L residues (pads PAD_SUBJECT = 25) -- and not the TPU schedule:
// the one-hot MXU staging, the Kogge-Stone cummax, the u-space rebasing
// and the VMEM tiles are not carried over.  They share one __device__
// routine, score_rows.
//
// Design: one thread per subject row, inter-sequence, as in sw_wave.cu.
//  * A thread walks the query in bands of W = 32 rows.  The band's H column
//    lives in 32 registers; the thread sweeps its row's columns left to
//    right and computes H = max(0, diag + S, up - gap, left - gap) down the
//    band, keeping the running best.
//  * The band's bottom row goes to a global carry, one int32 per column and
//    subject, read as the next band's top boundary and overwritten in place.
//    The carry is column-major across subjects (carry[j * B + b]), so each
//    column's carry access by a warp is one coalesced transaction.
//  * The bucket is row-major, so neighbouring threads' subject bytes lie L
//    apart.  A thread loads its row 16 bytes at a time (one uint4 when L is a
//    multiple of 16 and the row is aligned, else byte by byte into the same
//    registers), one chunk ahead of the columns it computes.
//  * The band's 32 profile rows are staged in shared memory, transposed to
//    [residue][row] int32 with a padded stride, so a column's 32 scores are
//    eight 16-byte loads.
//  * A query whose rows are not a multiple of 32 is padded by the wrapper
//    with all-PAD_SCORE rows, which cannot raise a maximum.
//
// What bounds it: int32 ALU operations, about 6 a cell (add, two max,
// subtract, clamp at 0, running-best max; the form below spends 7 so that the
// dependent chain through `up` is two operations long).  An H100 SXM issues
// 16.7 T int32 instructions a second (132 SMs x 64 lanes x 1.98 GHz), each at
// most two operations (VIADDMNMX: an add then a max), so about 5.6 T cells a
// second.  Memory is no limit: a column costs one subject byte
// per 32 cells and 8 carry bytes per band.  Left for later work (ROADMAP.md):
// occupancy (a bucket of a few hundred rows fills a few SMs), deeper
// prefetch, packed int16 pairs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int W = 32;          // query rows per band (register tile)
constexpr int A = 32;          // profile columns (padded alphabet)
constexpr int STRIDE = W + 4;  // shared row stride in int32: 16-byte aligned, spreads banks
constexpr int BLOCK = 64;      // small blocks spread a bucket over more SMs
constexpr int CHUNK = 16;      // subject bytes a thread loads at once

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

// Score subject rows 0 .. B-1 of one bucket (row-major, L bytes a row)
// against the profile; one thread a row.  `carry` holds L * B int32
// (unused when n_bands == 1).  `vec`: rows are 16-byte aligned, L % 16 == 0.
__device__ __forceinline__ void score_rows(int32_t* sprof, const int8_t* __restrict__ profile,
                                           const int8_t* __restrict__ subj, int32_t* __restrict__ carry,
                                           int32_t* __restrict__ out, int n_bands, int B, int L, int gap,
                                           bool vec) {
  const int b = blockIdx.x * BLOCK + threadIdx.x;
  const bool active = b < B;
  // Opaque copies keep the row and carry pointers in registers (left as
  // expressions of blockIdx, ptxas may rebuild them in every column, as it
  // did in sw_wave.cu).
  unsigned long long row_addr = reinterpret_cast<unsigned long long>(subj + static_cast<size_t>(active ? b : 0) * L);
  unsigned long long cc_addr = reinterpret_cast<unsigned long long>(carry + (active ? b : 0));
  asm volatile("mov.b64 %0, %0;" : "+l"(row_addr));
  asm volatile("mov.b64 %0, %0;" : "+l"(cc_addr));
  const int8_t* row = reinterpret_cast<const int8_t*>(row_addr);
  int32_t* cc = reinterpret_cast<int32_t*>(cc_addr);
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
            const int4* s4 = reinterpret_cast<const int4*>(sprof + a * STRIDE);
            int diag = top_prev, up = top;
#pragma unroll
            for (int p = 0; p < W / 4; ++p) {
              const int4 s = s4[p];
              cell(h[4 * p + 0], s.x, diag, up, best, gap);
              cell(h[4 * p + 1], s.y, diag, up, best, gap);
              cell(h[4 * p + 2], s.z, diag, up, best, gap);
              cell(h[4 * p + 3], s.w, diag, up, best, gap);
            }
            if (put_bottom) cc[static_cast<size_t>(j) * B] = h[W - 1];
            top_prev = top;
          }
        }
      }
    }
  }
  if (active) out[b] = best;
}

// K2: a (C, B, L) stack, grid (ceil(B / BLOCK), C); bucket c's carry is the
// c-th L * B slice.
__global__ void __launch_bounds__(BLOCK)
sw_rows_fused_kernel(const int8_t* __restrict__ profile,  // (n_bands * W, A)
                     const int8_t* __restrict__ stack,    // (C, B, L)
                     int32_t* __restrict__ carry,         // (C, L, B), unused if n_bands == 1
                     int32_t* __restrict__ out,           // (C, B)
                     int n_bands, int B, int L, int gap, bool vec) {
  __shared__ __align__(16) int32_t sprof[A * STRIDE];
  const size_t c = blockIdx.y;
  const size_t cells = static_cast<size_t>(B) * L;
  score_rows(sprof, profile, stack + c * cells, n_bands > 1 ? carry + c * cells : carry, out + c * B, n_bands, B,
             L, gap, vec);
}

// K3: one (B, L) bucket, grid ceil(B / BLOCK).
__global__ void __launch_bounds__(BLOCK)
sw_rows_kernel(const int8_t* __restrict__ profile,  // (n_bands * W, A)
               const int8_t* __restrict__ subj,     // (B, L)
               int32_t* __restrict__ carry,         // (L, B), unused if n_bands == 1
               int32_t* __restrict__ out,           // (B,)
               int n_bands, int B, int L, int gap, bool vec) {
  __shared__ __align__(16) int32_t sprof[A * STRIDE];
  score_rows(sprof, profile, subj, carry, out, n_bands, B, L, gap, vec);
}

bool aligned_rows(const void* subj, int L) {
  return L % CHUNK == 0 && reinterpret_cast<uintptr_t>(subj) % CHUNK == 0;
}

}  // namespace

extern "C" {

// K2 for a (n_chunks, B, L) stack on `stream` of `device`; returns
// cudaGetLastError() (0 = launched).  `profile` is (n_bands * 32, 32) int8;
// `carry` holds n_chunks * B * L int32 when n_bands > 1.
int sw_rows_fused_launch(const void* profile, const void* stack, void* carry, void* out, int n_chunks, int n_bands,
                         int B, int L, int gap, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((B + BLOCK - 1) / BLOCK), static_cast<unsigned>(n_chunks));
  sw_rows_fused_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(profile), static_cast<const int8_t*>(stack), static_cast<int32_t*>(carry),
      static_cast<int32_t*>(out), n_bands, B, L, gap, aligned_rows(stack, L));
  return static_cast<int>(cudaGetLastError());
}

// K3 for one (B, L) bucket; `carry` holds B * L int32 when n_bands > 1.
int sw_rows_launch(const void* profile, const void* subj, void* carry, void* out, int n_bands, int B, int L, int gap,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((B + BLOCK - 1) / BLOCK));
  sw_rows_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(profile), static_cast<const int8_t*>(subj), static_cast<int32_t*>(carry),
      static_cast<int32_t*>(out), n_bands, B, L, gap, aligned_rows(subj, L));
  return static_cast<int>(cudaGetLastError());
}

const char* sw_rows_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
