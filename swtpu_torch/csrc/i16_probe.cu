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
// (__byte_perm).
//
// The tile kernel.  Its tile is a few tens of kilobytes, so its device time
// is about a microsecond (torch.profiler: the same as the library's
// elementwise kernel) and its cost is the host's route to the launch
// (PERF.md, K9's split: the wrapper took three times the library call's
// host time).  So the op and the type are template parameters (5 x 2
// instantiations, no switch in the kernel), a thread moves 16 bytes (4
// words) of each operand, and the grid is sized to the tile, not a block a
// row.  dp_row needs no barrier and no shared memory: output column c
// depends only on a's columns c - 8 .. c and b's c - 7 .. c (the shift by
// one, then windows of 2, 4 and 8), so a thread loads its quad and the 8
// columns before it (8 words of int32, 4 of int16 pairs; its neighbours'
// loads, from L1), computes every step on that window in registers and
// keeps its own 4 words.  The row's start takes each step's fill.  The
// wrapper's route around the launch is in ops/i16_probe.py.
//
// The rate mode
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
#include <chrono>
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

constexpr int TILE_BLOCK = 256;  // threads a tile block

template <class T, int OP>
__device__ __forceinline__ uint32_t elementwise(uint32_t a, uint32_t b) {
  if constexpr (OP == MAX) return T::max(a, b);
  if constexpr (OP == ADD) return T::add(a, b);
  if constexpr (OP == SUB) return T::sub(a, b);
  return T::select(a, b);
}

// Word i of a window of N words of a row, shifted right by K columns; the
// window's word 0 is row word w0 (below 0 before the row's start).
// `fill` where a source column lies before the row's start.  A source
// outside the window also gives `fill`: no own word's result reads one.
template <class T, int K, int N>
__device__ __forceinline__ uint32_t window_shift(const uint32_t (&t)[N], int i, int w0, uint32_t fill) {
  if (T::E == 1 || K % 2 == 0) {
    const int src = i - K / T::E;
    return src >= 0 && w0 + src >= 0 ? t[src < 0 ? 0 : src] : fill;
  }
  const int lo = i - (K + 1) / 2, hi = i - (K - 1) / 2;  // high half of word lo, low half of word hi
  const uint32_t lv = lo >= 0 && w0 + lo >= 0 ? t[lo < 0 ? 0 : lo] : fill;
  const uint32_t hv = hi >= 0 && w0 + hi >= 0 ? t[hi < 0 ? 0 : hi] : fill;
  return __byte_perm(lv, hv, 0x5432);
}

// t = max(t, t shifted right K columns), in place: from the last word down,
// so every read sees the previous step's word.
template <class T, int K, int N>
__device__ __forceinline__ void max_shift(uint32_t (&t)[N], int w0) {
#pragma unroll
  for (int i = N - 1; i >= 0; --i) t[i] = T::max(t[i], window_shift<T, K>(t, i, w0, T::splat(-32768)));
}

// A thread's 4 words of one op on the flat tile of n words.  The operands
// are 16-byte aligned (the entry point checks), so a whole quad is one
// uint4 load of each and one store; the tile's last n % 4 words go word by
// word.
template <class T, int OP>
__device__ __forceinline__ void elementwise_quad(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                                 uint32_t* __restrict__ out, long long n) {
  const long long w = 4 * (static_cast<long long>(blockIdx.x) * TILE_BLOCK + threadIdx.x);
  if (w + 4 <= n) {
    const uint4 x = *reinterpret_cast<const uint4*>(a + w), y = *reinterpret_cast<const uint4*>(b + w);
    *reinterpret_cast<uint4*>(out + w) = make_uint4(elementwise<T, OP>(x.x, y.x), elementwise<T, OP>(x.y, y.y),
                                                    elementwise<T, OP>(x.z, y.z), elementwise<T, OP>(x.w, y.w));
  } else {
    for (long long k = w; k < n; ++k) out[k] = elementwise<T, OP>(a[k], b[k]);
  }
}

// dp_row on a thread's 4 words of a row of `words` words (quad j of row
// `row`), from the window of P words before them.
template <class T>
__device__ __forceinline__ void dp_row_quad(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                            uint32_t* __restrict__ out, int rows, int words) {
  constexpr int P = 8 / T::E;  // the 8 columns before the quad
  constexpr int N = P + 4;
  const int quads = (words + 3) / 4;
  const long long t = static_cast<long long>(blockIdx.x) * TILE_BLOCK + threadIdx.x;
  if (t >= static_cast<long long>(rows) * quads) return;
  const int row = static_cast<int>(t / quads);
  const int w0 = 4 * static_cast<int>(t - static_cast<long long>(row) * quads) - P;
  const size_t base = static_cast<size_t>(row) * words;
  uint32_t av[N], bv[N];
  if (words % 4 == 0) {  // every row starts 16-byte aligned: quad loads
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      uint4 x = make_uint4(0, 0, 0, 0), y = x;
      if (w0 + 4 * q >= 0) {
        x = *reinterpret_cast<const uint4*>(a + base + w0 + 4 * q);
        y = *reinterpret_cast<const uint4*>(b + base + w0 + 4 * q);
      }
      av[4 * q] = x.x, av[4 * q + 1] = x.y, av[4 * q + 2] = x.z, av[4 * q + 3] = x.w;
      bv[4 * q] = y.x, bv[4 * q + 1] = y.y, bv[4 * q + 2] = y.z, bv[4 * q + 3] = y.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const bool in = w0 + i >= 0 && w0 + i < words;
      av[i] = in ? a[base + w0 + i] : 0u;
      bv[i] = in ? b[base + w0 + i] : 0u;
    }
  }
  uint32_t tv[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const uint32_t d = window_shift<T, 1>(av, i, w0, T::splat(-2));
    tv[i] = T::max(T::max(bv[i], T::add(d, bv[i])), T::sub(av[i], T::splat(2)));
  }
  max_shift<T, 1>(tv, w0);
  max_shift<T, 2>(tv, w0);
  max_shift<T, 4>(tv, w0);
  const int own = w0 + P;
  if (words % 4 == 0) {
    *reinterpret_cast<uint4*>(out + base + own) = make_uint4(tv[P], tv[P + 1], tv[P + 2], tv[P + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (own + k < words) out[base + own + k] = tv[P + k];
    }
  }
}

template <class T, int OP>
__global__ void __launch_bounds__(TILE_BLOCK)
i16_tile_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                int rows, int words) {
  if constexpr (OP == DP_ROW) dp_row_quad<T>(a, b, out, rows, words);
  else elementwise_quad<T, OP>(a, b, out, static_cast<long long>(rows) * words);
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

using TileKernel = void (*)(const uint32_t*, const uint32_t*, uint32_t*, int, int);

// [packed][op]: the ten instantiations.
const TileKernel TILE_KERNELS[2][5] = {
    {i16_tile_kernel<I32, MAX>, i16_tile_kernel<I32, ADD>, i16_tile_kernel<I32, SUB>, i16_tile_kernel<I32, SELECT>,
     i16_tile_kernel<I32, DP_ROW>},
    {i16_tile_kernel<I16x2, MAX>, i16_tile_kernel<I16x2, ADD>, i16_tile_kernel<I16x2, SUB>,
     i16_tile_kernel<I16x2, SELECT>, i16_tile_kernel<I16x2, DP_ROW>},
};

// A thread a quad of the flat tile, or under dp_row a quad of a row.
void launch_tile(const void* a, const void* b, void* out, int rows, int words, int op, int packed,
                 cudaStream_t stream) {
  const long long threads = op == DP_ROW ? static_cast<long long>(rows) * ((words + 3) / 4)
                                         : (static_cast<long long>(rows) * words + 3) / 4;
  TILE_KERNELS[packed != 0][op]<<<static_cast<unsigned>((threads + TILE_BLOCK - 1) / TILE_BLOCK), TILE_BLOCK, 0,
                                  stream>>>(static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b),
                                            static_cast<uint32_t*>(out), rows, words);
}

// cudaSetDevice only when `device` is not the thread's current device.
cudaError_t use_device(int device) {
  int current = -1;
  const cudaError_t err = cudaGetDevice(&current);
  return err != cudaSuccess || current == device ? err : cudaSetDevice(device);
}

}  // namespace

extern "C" {

// One op on a (rows, words) tile of 32-bit words: int32 elements, or with
// `packed` int16 pairs.  a, b and out are 16-byte aligned.
int i16_tile_launch(const void* a, const void* b, void* out, int rows, int words, int op, int packed, int device,
                    void* stream) {
  const cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (op < MAX || op > DP_ROW || words < 1 || rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(out)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  launch_tile(a, b, out, rows, words, op, packed, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// ctypes' own cost of a call with i16_tile_launch's arguments: it does nothing.
int i16_route_noop(const void*, const void*, void*, int, int, int, int, int, void*) { return 0; }

// Host microseconds a call of the C pieces of i16_tile_launch, each timed
// alone over `reps` calls: us[0] cudaGetDevice, us[1] cudaSetDevice of the
// current device, us[2] the tile kernel's launch alone, us[3]
// cudaGetLastError.  The launches queue on `stream`; the caller synchronises.
int i16_tile_route_us(const void* a, const void* b, void* out, int rows, int words, int op, int packed, int device,
                      void* stream, int reps, double* us) {
  using clock = std::chrono::steady_clock;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (op < MAX || op > DP_ROW || words < 1 || rows < 1 || reps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto per_call = [reps](clock::time_point t0) {
    return std::chrono::duration<double, std::micro>(clock::now() - t0).count() / reps;
  };
  int cur = -1;
  auto t0 = clock::now();
  for (int k = 0; k < reps; ++k) err = cudaGetDevice(&cur);
  us[0] = per_call(t0);
  t0 = clock::now();
  for (int k = 0; k < reps; ++k) err = cudaSetDevice(device);
  us[1] = per_call(t0);
  t0 = clock::now();
  for (int k = 0; k < reps; ++k) launch_tile(a, b, out, rows, words, op, packed, static_cast<cudaStream_t>(stream));
  us[2] = per_call(t0);
  t0 = clock::now();
  for (int k = 0; k < reps; ++k) err = cudaGetLastError();
  us[3] = per_call(t0);
  return static_cast<int>(err);
}

// Blocks of `cols` threads of the (op, packed) chain that fill every SM of
// `device` at the kernel's occupancy.
int i16_chain_full_blocks(int cols, int op, int packed, int device, int* blocks) {
  cudaError_t err = use_device(device);
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
  const cudaError_t err = use_device(device);
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
