// The dependent int32 add/max chain of the DP recurrence, as a rate probe,
// for Hopper (sm_90a).
//
// Replaces K8, tools/roofline.py:101 (measure_vpu_chain, its pallas_call at
// :119): acc = max(acc + y, x) over a (32, cols) int32 tile, iters * UNROLL
// links from acc = x, counted as 2 operations a link as :125 counts them.
// Here a block holds the whole tile, one column a thread: 32 independent
// chains a thread, each link an add and a max.  Every block of a launch
// computes the same tile and stores the same values, so a launch of enough
// blocks to fill every SM measures the card's sustained rate of the chain
// the wavefront and row kernels run (H = max(diag + s, ...), running best =
// max(best, H)).  The iteration loop is kept rolled and the UNROLL links of a
// body unrolled, so the SASS of the loop body (chip_smoke.py's build line)
// shows whether ptxas compiles a link to one VIADDMNMX or to an IADD3 plus a
// VIMNMX: 32 * UNROLL links a body.
// What bounds it: int32 instructions, 132 SMs x 64 lanes x 1.98 GHz = 16.7 T
// a second; a link fused into one VIADDMNMX is two operations of one, so the
// peak is 33.5 T operations a second (chip_smoke.py's INT32_OPS_PER_S).  It
// reads and writes 64 KB a block once.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 32;    // the tile's rows: chains a thread
constexpr int UNROLL = 8;   // links of one chain a loop body
constexpr int MAX_COLS = 512;  // x, y and acc take 96 of a thread's 128 registers at 512 threads

__global__ void __launch_bounds__(MAX_COLS)
vpu_chain_kernel(const int32_t* __restrict__ x,  // (ROWS, cols)
                 const int32_t* __restrict__ y,  // (ROWS, cols)
                 int32_t* __restrict__ out,      // (ROWS, cols)
                 int cols, int iters) {
  const int c = threadIdx.x;  // blockDim.x == cols
  int xr[ROWS], yr[ROWS], acc[ROWS];
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
      for (int r = 0; r < ROWS; ++r) acc[r] = max(acc[r] + yr[r], xr[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) out[r * cols + c] = acc[r];
}

}  // namespace

extern "C" {

// Blocks of `cols` threads that fill every SM of `device` at the kernel's occupancy.
int vpu_chain_full_blocks(int cols, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, vpu_chain_kernel, cols, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = std::max(1, sms * per_sm);
  return 0;
}

// iters * UNROLL links of the chain on a (32, cols) tile, cols <= 512, in
// `blocks` blocks that all store the same out.
int vpu_chain_launch(const void* x, const void* y, void* out, int cols, int iters, int blocks, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  vpu_chain_kernel<<<blocks, cols, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(y), static_cast<int32_t*>(out), cols, iters);
  return static_cast<int>(cudaGetLastError());
}

const char* vpu_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
