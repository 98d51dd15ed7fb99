// Adjacent-inversion counts of u32 columns (Hopper).
//
// Two kernels, one per TPU kernel of tpu_radix_sort/ops/checksort.py:
//   disorder_kernel       replaces `_disorder_kernel` (launched by
//       `_disorder_pallas`): counts the i < n - 1 with x[i] > x[i + 1],
//       unsigned.
//   disorder_cols_kernel  replaces `_disorder_kernel2` (launched by
//       `_disorder_pallas2`): the same count over an (hi, lo) column pair,
//       the view of 64-bit keys, where i is an inversion iff
//       hi[i] > hi[i + 1] || (hi[i] == hi[i + 1] && lo[i] > lo[i + 1]).
// The TPU versions carry the previous block's last element across a
// sequential grid; blocks of a CUDA grid run in no order, so each thread
// reads its neighbour i + 1 straight from device memory (an L1/L2 hit),
// across block boundaries too, and no carry exists. A grid-stride loop, a
// warp-shuffle block reduction, and one atomicAdd per block into a u32 that
// the caller zeroes. The column-pair kernel keeps four iterations of its
// loop in flight per thread, so that more loads wait on memory at once.
//
// Bound on this card: one read of 4 * n bytes per column at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Sum `count` over the block and add it to *out with one atomicAdd.
__device__ __forceinline__ void block_add(unsigned count, unsigned* out) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(0xffffffffu, count, o);
  __shared__ unsigned warp_counts[32];
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_counts[warp] = count;
  __syncthreads();
  if (warp == 0) {
    count = lane < (blockDim.x >> 5) ? warp_counts[lane] : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) count += __shfl_down_sync(0xffffffffu, count, o);
    if (lane == 0 && count) atomicAdd(out, count);
  }
}

__global__ void disorder_kernel(const unsigned* __restrict__ x, unsigned long long n,
                                unsigned* __restrict__ out) {
  unsigned count = 0;
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       i + 1 < n; i += stride)
    count += x[i] > x[i + 1];
  block_add(count, out);
}

__device__ __forceinline__ unsigned pair_gt(const unsigned* __restrict__ hi,
                                            const unsigned* __restrict__ lo,
                                            unsigned long long i) {
  const unsigned h0 = hi[i], h1 = hi[i + 1];
  return h0 > h1 || (h0 == h1 && lo[i] > lo[i + 1]);
}

__global__ void disorder_cols_kernel(const unsigned* __restrict__ hi,
                                     const unsigned* __restrict__ lo,
                                     unsigned long long n, unsigned* __restrict__ out) {
  unsigned count = 0;
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (; i + 3 * stride + 1 < n; i += 4 * stride)
    count += pair_gt(hi, lo, i) + pair_gt(hi, lo, i + stride) +
             pair_gt(hi, lo, i + 2 * stride) + pair_gt(hi, lo, i + 3 * stride);
  for (; i + 1 < n; i += stride) count += pair_gt(hi, lo, i);
  block_add(count, out);
}

constexpr unsigned kThreads = 256;

// One thread per element up to 16 blocks per SM; grid-stride beyond.
unsigned grid_blocks(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  return blocks < 1 ? 1u : (unsigned)blocks;
}

}  // namespace

extern "C" {

// x: n u32 on the device; out: one zeroed u32 that receives the count.
int trs_disorder_count(const void* x, long long n, void* out, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  disorder_kernel<<<grid_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned*)x, (unsigned long long)n, (unsigned*)out);
  return cudaGetLastError();
}

// hi, lo: n u32 each on the device; out: one zeroed u32 that receives the
// count of lexicographic inversions of the (hi, lo) pairs.
int trs_disorder_count_cols(const void* hi, const void* lo, long long n, void* out,
                            void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  disorder_cols_kernel<<<grid_blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned*)hi, (const unsigned*)lo, (unsigned long long)n, (unsigned*)out);
  return cudaGetLastError();
}

const char* trs_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
