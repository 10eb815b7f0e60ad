// Packed int16 against int32 elementwise ops, and their sustained rates, for
// Hopper (sm_90a).
//
// Replaces K9, tools/probe_i16.py:32 (run, its pallas_call at :36, with the
// kernels k_max :15, k_dp_row :19, k_add :48, k_sub :52, k_select :56).  On
// the TPU that probe only asked whether Mosaic compiled each op on int16 and
// int32 (16, 512) tiles.  Here each op runs, for both types, and computes
// exactly what the JAX function computes:
//   max     max(a, b)
//   add     a + b, wrapping
//   sub     a - b, wrapping
//   select  b where a < b, else a (a compare, then a select)
//   dp_row  the DP-row step: d = a shifted right one column (fill -2),
//           t = max(max(b, d + b), a - 2), then three Kogge-Stone steps
//           t = max(t, t shifted right 1, 2, 4 columns (fill -32768))
// int16 runs as packed pairs, two columns a 32-bit word: __vmaxs2, __vadd2,
// __vsub2, __vcmplts2 with a mask select.  A shift by an odd number of
// columns takes the high half of one word and the low half of the next
// (__byte_perm).  A block owns one row, a thread one word; dp_row stages
// the row in shared memory between its four shift steps.
//
// The tile is a few kilobytes, so its time is one launch.  The rate mode
// times each op in a dependent chain: acc = op(acc, y) over a (32, cols) tile
// of words, iters * UNROLL links, 32 independent chains a thread, on enough
// blocks to fill every SM (each block computes the same tile).  Besides the
// tile's ops it runs the SW cell's fused ops: addmax, max(acc + y, x) (int32:
// __viaddmax_s32, a VIADDMNMX; int16x2: the DPX __viaddmax_s16x2), and max3,
// max(acc, y, x) (__vimax3_s32, __vimax3_s16x2).  The int32 addmax chain is
// also K8, tools/roofline.py:101 (measure_vpu_chain, its pallas_call at
// :119): the chain of the DP recurrence that measures the int32 rate every
// int32 bound divides by (ops/vpu_chain.py launches it).  An empty asm statement after every link keeps the
// compiler from folding links (UNROLL adds into one multiply-add, repeated
// maxes into one); it emits no instruction.  chip_smoke.py reads the SASS of
// each chain's loop body.
//
// What bounds it: int32-pipe instructions, 132 SMs x 64 lanes x 1.98 GHz =
// 16.7 T a second.  A packed int16 instruction does two lanes' work, so
// int16x2 can reach twice int32's element operations a second if the packed
// ops issue at the int32 rate: that is the question B5's packed-int16 plan
// asks.  The tile reads and writes 32-96 KB once.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Op { MAX = 0, ADD = 1, SUB = 2, SELECT = 3, DP_ROW = 4, ADDMAX = 5, MAX3 = 6 };

constexpr int ROWS = 32;       // the chain tile's rows: chains a thread
constexpr int UNROLL = 8;      // links of one chain a loop body
constexpr int MAX_COLS = 512;  // threads a chain block: one column of words a thread

// One int32 a word.  Arithmetic on uint32_t wraps; max and compare are signed.
struct I32 {
  static constexpr int E = 1;  // elements a word
  __device__ static uint32_t max(uint32_t a, uint32_t b) {
    return static_cast<uint32_t>(::max(static_cast<int>(a), static_cast<int>(b)));
  }
  __device__ static uint32_t add(uint32_t a, uint32_t b) { return a + b; }
  __device__ static uint32_t sub(uint32_t a, uint32_t b) { return a - b; }
  __device__ static uint32_t select(uint32_t a, uint32_t b) {
    return static_cast<int>(a) < static_cast<int>(b) ? b : a;
  }
  __device__ static uint32_t addmax(uint32_t a, uint32_t b, uint32_t c) {
    return static_cast<uint32_t>(__viaddmax_s32(static_cast<int>(a), static_cast<int>(b), static_cast<int>(c)));
  }
  __device__ static uint32_t max3(uint32_t a, uint32_t b, uint32_t c) {
    return static_cast<uint32_t>(__vimax3_s32(static_cast<int>(a), static_cast<int>(b), static_cast<int>(c)));
  }
  __device__ static uint32_t splat(int v) { return static_cast<uint32_t>(v); }
};

// Two int16 a word, column 2w in the low half (the int16 array's own layout).
struct I16x2 {
  static constexpr int E = 2;
  __device__ static uint32_t max(uint32_t a, uint32_t b) { return __vmaxs2(a, b); }
  __device__ static uint32_t add(uint32_t a, uint32_t b) { return __vadd2(a, b); }
  __device__ static uint32_t sub(uint32_t a, uint32_t b) { return __vsub2(a, b); }
  __device__ static uint32_t select(uint32_t a, uint32_t b) {
    const uint32_t lt = __vcmplts2(a, b);  // 0xffff in each half where a < b
    return (b & lt) | (a & ~lt);
  }
  __device__ static uint32_t addmax(uint32_t a, uint32_t b, uint32_t c) { return __viaddmax_s16x2(a, b, c); }
  __device__ static uint32_t max3(uint32_t a, uint32_t b, uint32_t c) { return __vimax3_s16x2(a, b, c); }
  __device__ static uint32_t splat(int v) { return (static_cast<uint32_t>(v) & 0xffffu) * 0x10001u; }
};

// The word of element columns (E*w - k, E*w + 1 - k): the row shifted right
// by k columns, `fill` where the column is before the row's start.
template <class T>
__device__ uint32_t shifted(const uint32_t* row, int w, int k, uint32_t fill) {
  if (T::E == 1 || k % 2 == 0) {
    const int src = w - k / T::E;
    return src >= 0 ? row[src] : fill;
  }
  const int lo = w - (k + 1) / 2, hi = w - (k - 1) / 2;  // high half of word lo, low half of word hi
  return __byte_perm(lo >= 0 ? row[lo] : fill, hi >= 0 ? row[hi] : fill, 0x5432);
}

template <class T>
__global__ void i16_tile_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, int words, int op) {
  extern __shared__ uint32_t row[];  // one row's words (dp_row)
  const int w = threadIdx.x;         // blockDim.x == words
  const size_t at = static_cast<size_t>(blockIdx.x) * words + w;
  const uint32_t av = a[at], bv = b[at];
  uint32_t r = 0;
  switch (op) {
    case MAX: r = T::max(av, bv); break;
    case ADD: r = T::add(av, bv); break;
    case SUB: r = T::sub(av, bv); break;
    case SELECT: r = T::select(av, bv); break;
    case DP_ROW: {  // op is the same for the whole block, so every thread reaches every barrier
      row[w] = av;
      __syncthreads();
      const uint32_t d = shifted<T>(row, w, 1, T::splat(-2));
      r = T::max(T::max(bv, T::add(d, bv)), T::sub(av, T::splat(2)));
      for (int k = 1; k <= 4; k *= 2) {
        __syncthreads();  // every reader of the previous step is done
        row[w] = r;
        __syncthreads();
        r = T::max(r, shifted<T>(row, w, k, T::splat(-32768)));
      }
      break;
    }
  }
  out[at] = r;
}

template <class T, int OP>
__device__ __forceinline__ uint32_t link(uint32_t acc, uint32_t y, uint32_t x) {
  if constexpr (OP == MAX) return T::max(acc, y);
  if constexpr (OP == ADD) return T::add(acc, y);
  if constexpr (OP == SUB) return T::sub(acc, y);
  if constexpr (OP == SELECT) return T::select(acc, y);
  if constexpr (OP == ADDMAX) return T::addmax(acc, y, x);
  return T::max3(acc, y, x);
}

template <class T, int OP>
__global__ void __launch_bounds__(MAX_COLS)
i16_chain_kernel(const uint32_t* __restrict__ x,  // (ROWS, cols) words
                 const uint32_t* __restrict__ y,  // (ROWS, cols)
                 uint32_t* __restrict__ out,      // (ROWS, cols)
                 int cols, int iters) {
  const int c = threadIdx.x;  // blockDim.x == cols
  uint32_t xr[ROWS], yr[ROWS], acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    xr[r] = x[r * cols + c];
    yr[r] = y[r * cols + c];
    acc[r] = xr[r];
  }
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        acc[r] = link<T, OP>(acc[r], yr[r], xr[r]);
        asm("" : "+r"(acc[r]));  // opaque to the optimizer: no links fold
      }
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) out[r * cols + c] = acc[r];
}

using ChainKernel = void (*)(const uint32_t*, const uint32_t*, uint32_t*, int, int);

template <class T>
ChainKernel chain_kernel(int op) {
  switch (op) {
    case MAX: return i16_chain_kernel<T, MAX>;
    case ADD: return i16_chain_kernel<T, ADD>;
    case SUB: return i16_chain_kernel<T, SUB>;
    case SELECT: return i16_chain_kernel<T, SELECT>;
    case ADDMAX: return i16_chain_kernel<T, ADDMAX>;
    case MAX3: return i16_chain_kernel<T, MAX3>;
    default: return nullptr;
  }
}

ChainKernel chain_kernel(int op, int packed) {
  return packed ? chain_kernel<I16x2>(op) : chain_kernel<I32>(op);
}

}  // namespace

extern "C" {

// One op on a (rows, words) tile of 32-bit words: int32 elements, or with
// `packed` int16 pairs.  words <= 1024.
int i16_tile_launch(const void* a, const void* b, void* out, int rows, int words, int op, int packed, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (op < MAX || op > DP_ROW || words < 1 || words > 1024 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = op == DP_ROW ? words * sizeof(uint32_t) : 0;
  auto kernel = packed ? i16_tile_kernel<I16x2> : i16_tile_kernel<I32>;
  kernel<<<rows, words, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b), static_cast<uint32_t*>(out), words, op);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of `cols` threads of the (op, packed) chain that fill every SM of
// `device` at the kernel's occupancy.
int i16_chain_full_blocks(int cols, int op, int packed, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ChainKernel kernel = chain_kernel(op, packed);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, cols, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = std::max(1, sms * per_sm);
  return 0;
}

// iters * UNROLL links of the (op, packed) chain on a (32, cols) tile of
// words, cols <= 512, in `blocks` blocks that all store the same out.
int i16_chain_launch(const void* x, const void* y, void* out, int cols, int iters, int blocks, int op, int packed,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const ChainKernel kernel = chain_kernel(op, packed);
  if (kernel == nullptr || cols < 1 || cols > MAX_COLS) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks, cols, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y), static_cast<uint32_t*>(out), cols, iters);
  return static_cast<int>(cudaGetLastError());
}

const char* i16_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
