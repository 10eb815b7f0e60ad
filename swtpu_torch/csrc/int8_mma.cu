// int8 tensor-core products for Hopper (sm_90a), on mma.sync m16n8k32 s8.
//
// Replaces K7, the int8 MXU probe of tools/roofline.py:65
// (measure_mxu_staging, its pallas_call at :92), and takes over the coarse
// pass that swtpu leaves to XLA's jnp.dot (swtpu/ops/prefilter.py:136, :166
// and :188).  Two kernels share one device routine, mma_s8:
//  * coarse_counts_kernel: the prefilter's shared-bucket counts, (Q, n) int32
//    = sig_qs (Q, dim) int8 times sig_db (n, dim) int8 transposed.
//    What bounds it: bytes.  At SwissProt scale the signature matrix is
//    559,228 x 1024 B = 572.6 MB, read once for all Q queries of a batch
//    (0.171 ms at 3.35 TB/s); its 2*Q*n*dim int8 operations take a few
//    microseconds of the tensor cores.  So the whole design is about keeping
//    enough bytes in flight with no instructions spent on moving them:
//    - A persistent grid: one block an SM (its shared memory allows no
//      more) walks 128-row subject tiles with a static stride, for one
//      group of 32 queries (grid axis y).  The wrapper lays out the grid
//      (ops/int8_mma.py: coarse_grid) and the launcher refuses one that
//      does not fit these tiles.
//    - A producer warp keeps a ring of STAGES stages of TMA loads in
//      flight.  A stage is a 128-row x 128-byte box of the signatures and
//      the 32-query x 128-byte box of the same K range (from L2: the
//      queries are a few KB), both from 2-D tensor maps with 128-byte
//      swizzle, so the fragment reads below hit 8 distinct 16-byte bank
//      groups.  TMA fills rows past n, queries past Q and bytes past dim
//      with zeros, so any n, any Q and dim % 128 in {32, 64, 96} need no
//      masks: a zero adds nothing to a dot product.  Each stage completes
//      on an mbarrier; the consumers release it on a second one.
//    - Eight consumer warps, 16 subject rows each, read their fragments
//      with ldmatrix (A: one x4 a 32-byte K step; B: one x4 two K steps of
//      8 queries) and run mma.sync m16n8k32 with subjects on M and queries
//      on N, skipping the 8-query tiles past Q.
//    - The (32, 128) int32 output tile goes through shared memory, so each
//      store is a whole 16-byte piece of one query row (4-byte pieces when
//      n % 4 != 0), and the next tile's loads run meanwhile.
//    The tensor maps are encoded on the host with cuTensorMapEncodeTiled,
//    taken from the runtime's driver entry point: the library links no
//    libcuda.  They hold the operands' addresses, so every launch encodes
//    its own; the shared-memory attribute is set once a device.
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
#include <atomic>
#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from cudaGetDriverEntryPoint
#include <cuda_runtime.h>

namespace {

constexpr int CONSUMERS = 8;                      // consumer warps of coarse_counts_kernel, 16 rows each
constexpr int COARSE_THREADS = (CONSUMERS + 1) * 32;  // and one producer warp
constexpr int TILE_M = CONSUMERS * 16;            // subject rows a tile: 128
constexpr int KCHUNK = 128;                       // bytes of K a stage (the 128-byte swizzle's span)
constexpr int QTILE = 32;                         // queries a block: four 8-query mma tiles
constexpr int NT = QTILE / 8;
constexpr int A_BYTES = TILE_M * KCHUNK;          // 16 KB of signatures a stage
constexpr int STAGE_BYTES = A_BYTES + QTILE * KCHUNK;  // and 4 KB of queries
constexpr int STAGES = 8;
constexpr int EP_STRIDE = TILE_M + 4;             // int32 a query row of the output tile: 16-byte rows, no bank conflicts
constexpr int COARSE_SMEM = 1024 + STAGES * STAGE_BYTES + QTILE * EP_STRIDE * 4 + 2 * STAGES * 8;
static_assert(COARSE_SMEM <= 227 * 1024 && 2 * COARSE_SMEM > 228 * 1024, "one block an SM, as coarse_grid assumes");
constexpr int MAX_DEVICES = 64;                   // devices whose shared-memory attribute is remembered as set
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One 2-D TMA box at (x = byte in the row, y = row) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Shared address of 16-byte chunk `chunk` of row `row` of a box stored with
// the 128-byte swizzle (rows of 128 bytes, chunk c of row r at c ^ (r % 8)).
__device__ __forceinline__ uint32_t swizzled(uint32_t box, int row, int chunk) {
  return box + row * KCHUNK + ((chunk ^ (row & 7)) << 4);
}

__global__ void __launch_bounds__(COARSE_THREADS, 1)
coarse_counts_kernel(const __grid_constant__ CUtensorMap db_map,  // (n, dim) int8, box 128 x 128
                     const __grid_constant__ CUtensorMap q_map,   // (Q, dim) int8, box 32 x 128
                     int32_t* __restrict__ out,                   // (Q, n)
                     int n, int Q, int dim) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t{1023});
  int32_t* ep = reinterpret_cast<int32_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(ep + QTILE * EP_STRIDE);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  __syncthreads();
  const int tiles = (n + TILE_M - 1) / TILE_M;
  const int kchunks = (dim + KCHUNK - 1) / KCHUNK;
  const int q0 = blockIdx.y * QTILE;
  const int nq = min(QTILE, Q - q0);
  const int ntiles = (nq + 7) / 8;

  if (warp == CONSUMERS) {  // the producer: one lane issues every load
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        for (int kc = 0; kc < kchunks; ++kc) {
          mbar_wait(&empty[stage], phase ^ 1);  // the first pass through the ring finds every stage free
          mbar_expect_tx(&full[stage], STAGE_BYTES);
          uint8_t* dst = ring + stage * STAGE_BYTES;
          tma_load(dst, &db_map, kc * KCHUNK, tile * TILE_M, &full[stage]);
          tma_load(dst + A_BYTES, &q_map, kc * KCHUNK, q0, &full[stage]);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ldmatrix x4 addresses: lanes 8i..8i+7 give the rows of matrix i.
  const int mi = lane >> 3, mr = lane & 7;
  const int a_row = warp * 16 + mr + (mi & 1) * 8;  // A: matrices (rows 0-7, 8-15) x (K bytes 0-15, 16-31)
  const int g = lane >> 2, t = lane & 3;
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    for (int kc = 0; kc < kchunks; ++kc) {
      mbar_wait(&full[stage], phase);
      const uint32_t a_box = smem_u32(ring + stage * STAGE_BYTES), b_box = a_box + A_BYTES;
#pragma unroll
      for (int s = 0; s < KCHUNK / 32; s += 2) {  // two 32-byte K steps
        uint32_t a0[4], a1[4];
        ldmatrix_x4(a0, swizzled(a_box, a_row, 2 * s + (mi >> 1)));
        ldmatrix_x4(a1, swizzled(a_box, a_row, 2 * s + 2 + (mi >> 1)));
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j < ntiles) {
            // B: matrices (K step s, s + 1) x (K bytes 0-15, 16-31) of queries 8j..8j+7
            uint32_t b[4];
            ldmatrix_x4(b, swizzled(b_box, j * 8 + mr, 2 * s + mi));
            mma_s8(acc[j], a0[0], a0[1], a0[2], a0[3], b[0], b[1]);
            mma_s8(acc[j], a1[0], a1[1], a1[2], a1[3], b[2], b[3]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    // Epilogue: the tile through shared memory, then whole rows of each query.
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS * 32) : "memory");  // the last tile's stores have read ep
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < ntiles) {
        int32_t* e0 = ep + (j * 8 + 2 * t) * EP_STRIDE + warp * 16 + g;
        e0[0] = acc[j][0];
        e0[EP_STRIDE] = acc[j][1];
        e0[8] = acc[j][2];
        e0[EP_STRIDE + 8] = acc[j][3];
      }
    }
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS * 32) : "memory");
    const long long m0 = static_cast<long long>(tile) * TILE_M;
    const bool vec = (n & 3) == 0;
    for (int k = threadIdx.x; k < nq * (TILE_M / 4); k += CONSUMERS * 32) {
      const int q = k / (TILE_M / 4), r = (k % (TILE_M / 4)) * 4;
      const long long row = m0 + r;
      const int4 v = *reinterpret_cast<const int4*>(ep + q * EP_STRIDE + r);
      int32_t* o = out + static_cast<long long>(q0 + q) * n + row;
      if (vec && row + 3 < n) {
        *reinterpret_cast<int4*>(o) = v;
      } else {
        if (row < n) o[0] = v.x;
        if (row + 1 < n) o[1] = v.y;
        if (row + 2 < n) o[2] = v.z;
        if (row + 3 < n) o[3] = v.w;
      }
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

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no libcuda link).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 2-D map of a (rows, dim) int8 matrix, boxes of box_rows x 128 bytes with
// the 128-byte swizzle; out-of-range elements read as zero.
bool tensor_map(EncodeTiled encode, CUtensorMap* map, const void* base, int rows, int dim, int box_rows) {
  const cuuint64_t size[2] = {static_cast<cuuint64_t>(dim), static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(dim)};
  const cuuint32_t box[2] = {KCHUNK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), size, stride, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// Shared-bucket counts: out (Q, n) int32 = qs (Q, dim) . db (n, dim)^T on
// `stream` of `device`, on a (grid_x, grid_y) grid: grid_y = ceil(Q / 32)
// query groups, 1 <= grid_x <= ceil(n / 128) blocks each walking subject
// tiles (the wrapper's coarse_grid); dim % 32 == 0 (every row stride a
// multiple of 16 bytes, as TMA needs), both bases 16-byte aligned.  Returns
// cudaGetLastError() (0 = launched), or the error that stopped it.
int int8_mma_coarse_counts_launch(const void* db, const void* qs, void* out, int n, int Q, int dim, int grid_x,
                                  int grid_y, int device, void* stream) {
  if (grid_y != (Q + QTILE - 1) / QTILE || grid_x < 1 || grid_x > (n + TILE_M - 1) / TILE_M)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap db_map, q_map;
  if (!tensor_map(encode, &db_map, db, n, dim, TILE_M) || !tensor_map(encode, &q_map, qs, Q, dim, QTILE))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<bool> smem_set[MAX_DEVICES];  // setting it twice from two threads is harmless
  if (device >= MAX_DEVICES || !smem_set[device].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(coarse_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, COARSE_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (device < MAX_DEVICES) smem_set[device].store(true, std::memory_order_relaxed);
  }
  const dim3 grid(static_cast<unsigned>(grid_x), static_cast<unsigned>(grid_y));
  coarse_counts_kernel<<<grid, COARSE_THREADS, COARSE_SMEM, static_cast<cudaStream_t>(stream)>>>(
      db_map, q_map, static_cast<int32_t*>(out), n, Q, dim);
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
