// Adjacent-inversion count of a u32 array (Hopper).
//
// Replaces the TPU kernel `_disorder_kernel` of
// tpu_radix_sort/ops/checksort.py (launched by `_disorder_pallas`): counts
// the i < n - 1 with x[i] > x[i + 1], unsigned. The TPU version carries the
// previous block's last element across a sequential grid; blocks of a CUDA
// grid run in no order, so each thread reads its neighbour x[i + 1] straight
// from device memory (an L1/L2 hit) and no carry exists. A grid-stride loop,
// a warp-shuffle block reduction, and one atomicAdd per block into a u32
// that the caller zeroes.
//
// Bound on this card: one read of 4 * n bytes at 3.35 TB/s.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void disorder_kernel(const unsigned* __restrict__ x, unsigned long long n,
                                unsigned* __restrict__ out) {
  unsigned count = 0;
  const unsigned long long stride = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
       i + 1 < n; i += stride)
    count += x[i] > x[i + 1];
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

}  // namespace

extern "C" {

// x: n u32 on the device; out: one zeroed u32 that receives the count.
int trs_disorder_count(const void* x, long long n, void* out, void* stream) {
  if (n < 0) return cudaErrorInvalidValue;
  const unsigned threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks per SM, grid-stride beyond
  if (blocks < 1) blocks = 1;
  disorder_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned*)x, (unsigned long long)n, (unsigned*)out);
  return cudaGetLastError();
}

const char* trs_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
