// int8 tensor-core products for Hopper (sm_90a), on mma.sync m16n8k32 s8.
//
// Replaces K7, the int8 MXU probe of tools/roofline.py:65
// (measure_mxu_staging, its pallas_call at :92), and takes over the coarse
// pass that swtpu leaves to XLA's jnp.dot (swtpu/ops/prefilter.py:136, :166
// and :188).  Two entry points share one device routine, mma_s8:
//  * coarse_counts_kernel: the prefilter's shared-bucket counts, (Q, n) int32
//    = sig_qs (Q, dim) int8 times sig_db (n, dim) int8 transposed.  Subjects
//    take the M side of the tile (16 rows a warp), queries the N side (8 a
//    tile, NT tiles a warp, Q padded to a multiple of 8 with zeros in
//    registers, not in memory), and K runs over dim in 64-byte steps (a
//    32-byte step at the end when dim % 64 == 32).  A thread loads 16 bytes of
//    each of its two subject rows and of each of its query rows a step; the
//    two m16n8k32 products of a step take bytes 0-7 and 8-15 of every thread's
//    16, the same permutation of K on both sides, so the dot products are
//    unchanged.  Rows past n load zeros and store nothing.
//    What bounds it: bytes.  At SwissProt scale the signature matrix is
//    559,228 x 1024 B = 572.6 MB, read once for all Q queries of a batch
//    (0.171 ms at 3.35 TB/s); its 2*Q*n*dim int8 operations take a few
//    microseconds of the tensor cores.  The design streams each row once
//    (cache-streaming loads), keeps the few KB of query rows in L1/L2, and
//    puts 8 warps a block with several blocks an SM in flight to cover the
//    memory latency.  wgmma, TMA and a shared-memory ring are later work.
//  * mma_probe_kernel: K7's function.  Independent int8 dots of a (M, 384)
//    and a (384, N), each with a perturbed by a ^ (i + j) (as
//    tools/roofline.py:75), max-reduced over i < iters and j < unroll.  A warp
//    owns a 16 x 32 output tile with its operands in registers; every warp
//    past the M*N/512 tiles repeats one and stores the same values, so a
//    launch of enough warps to fill every SM measures the card's sustained
//    mma.sync int8 MAC rate (against the 989.5 T MAC/s dense peak).
//    What bounds it: operations (tensor-core MACs); it reads a few hundred KB.
//
// Fragment layouts of m16n8k32 .s8 (PTX ISA): lane l, g = l / 4, t = l % 4.
// A (16 x 32, row): a0 = row g, k 4t..4t+3; a1 = row g+8, same k; a2 = row g,
// k 16+4t..; a3 = row g+8, k 16+4t...  B (32 x 8, col): b0 = column g, k
// 4t..4t+3; b1 = column g, k 16+4t...  C: c0, c1 = row g, columns 2t, 2t+1;
// c2, c3 = row g+8, the same columns.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;          // warps a block of coarse_counts_kernel
constexpr int NT = 4;             // 8-query tiles a warp carries: 32 queries a pass
constexpr int PROBE_K = 384;      // K7's depth
constexpr int PROBE_KSTEPS = PROBE_K / 32;
constexpr int PROBE_NT = 4;       // a probe warp's tile: 16 x 32
constexpr int PROBE_WARPS = 4;    // warps a block of mma_probe_kernel

__device__ __forceinline__ void mma_s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t load4(const int8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

__global__ void __launch_bounds__(WARPS * 32)
coarse_counts_kernel(const int8_t* __restrict__ db,  // (n, dim)
                     const int8_t* __restrict__ qs,  // (Q, dim)
                     int32_t* __restrict__ out,      // (Q, n)
                     int n, int Q, int dim) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long m0 = (static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5)) * 16;
  if (m0 >= n) return;  // the whole warp leaves together: no barrier below
  const long long r0 = m0 + g, r1 = m0 + g + 8;
  const bool ok0 = r0 < n, ok1 = r1 < n;
  const int8_t* row0 = db + (ok0 ? r0 : 0) * static_cast<long long>(dim);
  const int8_t* row1 = db + (ok1 ? r1 : 0) * static_cast<long long>(dim);
  const int q0 = blockIdx.y * NT * 8;
  const int ntiles = min(NT, (Q - q0 + 7) / 8);
  const int8_t* qrow[NT];
  bool qok[NT];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int q = q0 + j * 8 + g;
    qok[j] = q < Q;
    qrow[j] = qs + static_cast<long long>(qok[j] ? q : 0) * dim;
  }
  int acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  int k = 0;
#pragma unroll 4
  for (; k + 64 <= dim; k += 64) {
    const int off = k + t * 16;
    const uint4 a0 = ok0 ? __ldcs(reinterpret_cast<const uint4*>(row0 + off)) : zero4;
    const uint4 a1 = ok1 ? __ldcs(reinterpret_cast<const uint4*>(row1 + off)) : zero4;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < ntiles) {
        const uint4 b = qok[j] ? __ldg(reinterpret_cast<const uint4*>(qrow[j] + off)) : zero4;
        mma_s8(acc[j], a0.x, a1.x, a0.y, a1.y, b.x, b.y);  // bytes 0-7 of each thread's 16
        mma_s8(acc[j], a0.z, a1.z, a0.w, a1.w, b.z, b.w);  // bytes 8-15
      }
    }
  }
  if (k < dim) {  // dim % 64 == 32: one 32-byte step, 8 bytes a thread
    const int off = k + t * 8;
    const uint2 zero2 = make_uint2(0u, 0u);
    const uint2 a0 = ok0 ? __ldcs(reinterpret_cast<const uint2*>(row0 + off)) : zero2;
    const uint2 a1 = ok1 ? __ldcs(reinterpret_cast<const uint2*>(row1 + off)) : zero2;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < ntiles) {
        const uint2 b = qok[j] ? __ldg(reinterpret_cast<const uint2*>(qrow[j] + off)) : zero2;
        mma_s8(acc[j], a0.x, a1.x, a0.y, a1.y, b.x, b.y);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < ntiles) {
      const int qa = q0 + j * 8 + t * 2;  // c0/c2 at query qa, c1/c3 at qa + 1
      if (ok0 && qa < Q) out[static_cast<long long>(qa) * n + r0] = acc[j][0];
      if (ok0 && qa + 1 < Q) out[static_cast<long long>(qa + 1) * n + r0] = acc[j][1];
      if (ok1 && qa < Q) out[static_cast<long long>(qa) * n + r1] = acc[j][2];
      if (ok1 && qa + 1 < Q) out[static_cast<long long>(qa + 1) * n + r1] = acc[j][3];
    }
  }
}

__global__ void __launch_bounds__(PROBE_WARPS * 32)
mma_probe_kernel(const int8_t* __restrict__ a,   // (M, PROBE_K) row-major
                 const int8_t* __restrict__ bt,  // (N, PROBE_K): b transposed
                 int32_t* __restrict__ out,      // (M, N)
                 int M, int N, int iters, int unroll) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles_n = N / (PROBE_NT * 8);
  const int tile = (blockIdx.x * PROBE_WARPS + (threadIdx.x >> 5)) % ((M / 16) * tiles_n);
  const int m0 = (tile / tiles_n) * 16, n0 = (tile % tiles_n) * PROBE_NT * 8;
  uint32_t fa[PROBE_KSTEPS][4];
  uint32_t fb[PROBE_KSTEPS][PROBE_NT][2];
#pragma unroll
  for (int ks = 0; ks < PROBE_KSTEPS; ++ks) {
    const int8_t* p0 = a + (m0 + g) * PROBE_K + ks * 32 + t * 4;
    const int8_t* p1 = p0 + 8 * PROBE_K;
    fa[ks][0] = load4(p0);
    fa[ks][1] = load4(p1);
    fa[ks][2] = load4(p0 + 16);
    fa[ks][3] = load4(p1 + 16);
#pragma unroll
    for (int j = 0; j < PROBE_NT; ++j) {
      const int8_t* c = bt + (n0 + j * 8 + g) * PROBE_K + ks * 32 + t * 4;
      fb[ks][j][0] = load4(c);
      fb[ks][j][1] = load4(c + 16);
    }
  }
  int best[PROBE_NT][4];
#pragma unroll
  for (int j = 0; j < PROBE_NT; ++j) best[j][0] = best[j][1] = best[j][2] = best[j][3] = 0;
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll 1
    for (int j = 0; j < unroll; ++j) {
      const uint32_t x = static_cast<uint32_t>((i + j) & 0xff) * 0x01010101u;  // int8(i + j) in every byte
      int acc[PROBE_NT][4];
#pragma unroll
      for (int c = 0; c < PROBE_NT; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0;
#pragma unroll
      for (int ks = 0; ks < PROBE_KSTEPS; ++ks) {
        const uint32_t x0 = fa[ks][0] ^ x, x1 = fa[ks][1] ^ x, x2 = fa[ks][2] ^ x, x3 = fa[ks][3] ^ x;
#pragma unroll
        for (int c = 0; c < PROBE_NT; ++c) mma_s8(acc[c], x0, x1, x2, x3, fb[ks][c][0], fb[ks][c][1]);
      }
#pragma unroll
      for (int c = 0; c < PROBE_NT; ++c) {
#pragma unroll
        for (int r = 0; r < 4; ++r) best[c][r] = max(best[c][r], acc[c][r]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < PROBE_NT; ++c) {
    const int col = n0 + c * 8 + t * 2;
    int32_t* o0 = out + (m0 + g) * N + col;
    int32_t* o1 = o0 + 8 * N;
    o0[0] = best[c][0];
    o0[1] = best[c][1];
    o1[0] = best[c][2];
    o1[1] = best[c][3];
  }
}

}  // namespace

extern "C" {

// Shared-bucket counts: out (Q, n) int32 = qs (Q, dim) . db (n, dim)^T on
// `stream` of `device`; dim % 32 == 0, both bases 16-byte aligned (every row
// then is).  Returns cudaGetLastError() (0 = launched).
int int8_mma_coarse_counts_launch(const void* db, const void* qs, void* out, int n, int Q, int dim, int device,
                                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long mtiles = (static_cast<long long>(n) + 15) / 16;
  const dim3 grid(static_cast<unsigned>((mtiles + WARPS - 1) / WARPS), static_cast<unsigned>((Q + NT * 8 - 1) / (NT * 8)));
  coarse_counts_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(db), static_cast<const int8_t*>(qs), static_cast<int32_t*>(out), n, Q, dim);
  return static_cast<int>(cudaGetLastError());
}

// Warps of a probe launch that fills every SM of `device` at the kernel's
// occupancy, and at least one a (16 x 32) tile of an (M, N) output.
int int8_mma_probe_warps(int M, int N, int device, int* warps) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, mma_probe_kernel, PROBE_WARPS * 32, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (M / 16) * (N / (PROBE_NT * 8));
  const int blocks = std::max(sms * per_sm, (tiles + PROBE_WARPS - 1) / PROBE_WARPS);
  *warps = blocks * PROBE_WARPS;
  return 0;
}

// K7's probe on `warps` warps (a multiple of 4): a (M, 384), bt (N, 384)
// int8 with M % 16 == 0 and N % 32 == 0; out (M, N) int32.
int int8_mma_probe_launch(const void* a, const void* bt, void* out, int M, int N, int iters, int unroll, int warps,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  mma_probe_kernel<<<warps / PROBE_WARPS, PROBE_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(bt), static_cast<int32_t*>(out), M, N, iters, unroll);
  return static_cast<int>(cudaGetLastError());
}

const char* int8_mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
