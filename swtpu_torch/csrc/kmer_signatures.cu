// The prefilter's k-mer signatures, built on the card (ops/prefilter.py:
// database_signatures_cuda).
//
// kmer_signatures_kernel writes the (n, DIM) int8 presence signatures and
// the (n,) int32 popcounts of a database whose residues and int64 offsets
// are already on the card, byte for byte what the native host pass
// sw_build_signatures (csrc/sw_native.cpp) writes: every 3-mer window inside
// a record hashed into one presence byte of its record's row,
// hash = ((acc >> 20) ^ acc) & (DIM - 1), acc = r[p] * mix[0] + r[p + 1] *
// mix[1] + r[p + 2] * mix[2] on uint32 wrap-around, residues read as
// unsigned bytes.  A k-mer never spans two records; a record shorter than 3
// (or with an end before its start) gives a row of zeros.
//
// What bounds it: bytes.  A database of n records and R residues costs R
// bytes read (each residue three times, from L1), 8 (n + 1) bytes of
// offsets, n * DIM bytes of signatures and 4n bytes of popcounts written;
// at a UniRef50 quarter (16 M records, 5.6 G residues, DIM 1,024) that is
// 22 GB, ~6.6 ms at 3.35 TB/s.  So:
//  - a warp builds one record's row at a time in its own DIM bytes of
//    shared memory: it zeroes them (16-byte stores), its lanes hash the
//    windows p = lane, lane + 32, ... (coalesced byte loads) and store 1 at
//    each bucket (racing lanes store the same value), then each lane writes
//    its 16-byte pieces of the row to global memory with streaming stores
//    (the index is written once and read by another kernel) and counts their
//    set bytes (__popc of a word of 0/1 bytes), a warp sum for the popcount;
//  - a persistent grid of 8-warp blocks, as many as the SMs hold, walks the
//    records with a static stride.
// Record and byte indices are 64-bit: the index passes 2^32 bytes at 4.2 M
// records.  DIM and the k-mer length are ops/prefilter.py's DIM and K.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;  // warps a block, one record each at a time
constexpr int THREADS = WARPS * 32;
constexpr int DIM = 1024;  // presence bytes a row (ops/prefilter.py: DIM)
constexpr int PIECES = DIM / 16;  // 16-byte pieces of a row

__global__ void __launch_bounds__(THREADS)
kmer_signatures_kernel(const uint8_t* __restrict__ residues, const int64_t* __restrict__ offsets, long long n,
                       uint32_t m0, uint32_t m1, uint32_t m2, int8_t* __restrict__ sig,
                       int32_t* __restrict__ pop) {
  __shared__ uint4 rows[WARPS * PIECES];  // a row of DIM bytes a warp, 8 KB
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint4* row = rows + warp * PIECES;
  uint8_t* bytes = reinterpret_cast<uint8_t*>(row);
  const long long stride = static_cast<long long>(gridDim.x) * WARPS;
  for (long long rec = static_cast<long long>(blockIdx.x) * WARPS + warp; rec < n; rec += stride) {
    for (int c = lane; c < PIECES; c += 32) row[c] = make_uint4(0, 0, 0, 0);
    __syncwarp();
    const long long beg = offsets[rec];
    const long long len = offsets[rec + 1] - beg;
    const uint8_t* seq = residues + beg;
    for (long long p = lane; p + 3 <= len; p += 32) {
      const uint32_t acc = __ldg(seq + p) * m0 + __ldg(seq + p + 1) * m1 + __ldg(seq + p + 2) * m2;
      bytes[((acc >> 20) ^ acc) & (DIM - 1)] = 1;
    }
    __syncwarp();
    int count = 0;
    uint4* out = reinterpret_cast<uint4*>(sig + rec * DIM);
    for (int c = lane; c < PIECES; c += 32) {
      const uint4 v = row[c];
      count += __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
      __stcs(out + c, v);
    }
    count = __reduce_add_sync(0xffffffffu, count);
    if (lane == 0) pop[rec] = count;
    __syncwarp();  // every lane has read the row before the next record zeroes it
  }
}

}  // namespace

extern "C" {

// Signatures and popcounts of n records on `stream` of `device`: residues
// (int8), offsets (n + 1 int64), sig (n, DIM) int8 with a 16-byte aligned
// base, pop (n,) int32.  Returns
// cudaGetLastError() (0 = launched), or the error that stopped it.
int kmer_signatures_launch(const void* residues, const void* offsets, long long n, unsigned m0,
                           unsigned m1, unsigned m2, void* sig, void* pop, int device, void* stream) {
  if (n < 0 || reinterpret_cast<uintptr_t>(sig) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kmer_signatures_kernel, THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long wanted = (n + WARPS - 1) / WARPS;
  const long long full = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = static_cast<unsigned>(wanted < full ? wanted : full);
  kmer_signatures_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(residues), static_cast<const int64_t*>(offsets), n, m0, m1, m2,
      static_cast<int8_t*>(sig), static_cast<int32_t*>(pop));
  return static_cast<int>(cudaGetLastError());
}

const char* kmer_signatures_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
