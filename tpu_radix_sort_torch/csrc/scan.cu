// Prefix scan of a u32 array with wraparound (Hopper).
//
// Replaces the TPU kernel `_scan_kernel` of tpu_radix_sort/ops/scan.py
// (launched by `scan_padded`): the exclusive or inclusive prefix sum of a
// u32 array in element order, all arithmetic in `unsigned`, so sums wrap
// exactly as u32 does. The TPU version carries a running sum across a
// sequential grid in SMEM; CUDA blocks run in no order, so this is
// reduce-then-scan over tiles of `tile` elements, each tile one block:
//   pass 0  scan_reduce_kernel  writes each tile's sum;
//           (the caller scans the tile sums with these same passes,
//           recursing while they span more than one tile)
//   pass 1  scan_tiles_kernel   scans each tile in rounds of 256 elements
//                               (a warp-shuffle scan, then the warp totals
//                               through shared memory) and adds the tile's
//                               offset, the exclusive scan of the tile sums.
// The caller zeroes nothing and allocates the tile sums and offsets.
//
// Bound on this card: one read and one write of 4 * n bytes at 3.35 TB/s;
// pass 0 reads the input a second time. A single-pass decoupled look-back
// scan would drop that read and is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kThreads = 256;
constexpr unsigned kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned long long tile_end(unsigned long long base,
                                                       unsigned long long tile,
                                                       unsigned long long n) {
  return base + tile < n ? base + tile : n;
}

__global__ void scan_reduce_kernel(const unsigned* __restrict__ x, unsigned long long n,
                                   unsigned long long tile, unsigned* __restrict__ sums) {
  const unsigned long long base = (unsigned long long)blockIdx.x * tile;
  const unsigned long long end = tile_end(base, tile, n);
  unsigned s = 0;
  for (unsigned long long i = base + threadIdx.x; i < end; i += kThreads) s += x[i];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFull, s, o);
  __shared__ unsigned warp_sums[kWarps];
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned total = 0;
#pragma unroll
    for (unsigned w = 0; w < kWarps; ++w) total += warp_sums[w];
    sums[blockIdx.x] = total;
  }
}

__global__ void scan_tiles_kernel(const unsigned* __restrict__ x, unsigned long long n,
                                  unsigned long long tile,
                                  const unsigned* __restrict__ offs, int inclusive,
                                  unsigned* __restrict__ out) {
  // Warp totals of a round, double-buffered: round r writes buffer r & 1,
  // so one __syncthreads() per round suffices (a thread can write buffer p
  // again only after the next round's barrier, which every reader of p has
  // passed).
  __shared__ unsigned warp_tot[2][kWarps];
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned long long base = (unsigned long long)blockIdx.x * tile;
  const unsigned long long end = tile_end(base, tile, n);
  unsigned carry = offs ? offs[blockIdx.x] : 0u;
  unsigned p = 0;
  for (unsigned long long i0 = base; i0 < end; i0 += kThreads, p ^= 1) {
    const unsigned long long i = i0 + threadIdx.x;
    const unsigned v = i < end ? x[i] : 0u;
    unsigned inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(kFull, inc, o);
      if (lane >= (unsigned)o) inc += t;
    }
    if (lane == 31) warp_tot[p][warp] = inc;
    __syncthreads();
    unsigned before = 0, total = 0;
#pragma unroll
    for (unsigned w = 0; w < kWarps; ++w) {
      const unsigned t = warp_tot[p][w];
      before += w < warp ? t : 0u;
      total += t;
    }
    if (i < end) out[i] = carry + before + (inclusive ? inc : inc - v);
    carry += total;
  }
}

}  // namespace

extern "C" {

// pass 0: dst[b] = sum of tile b of x (nblocks = ceil(n / tile) entries).
// pass 1: dst = scan of x within each tile, plus offs[b] for tile b when
//         offs is not NULL. tile is a positive multiple of 256.
int trs_scan_pass(int pass, const void* x, long long n, long long tile, void* dst,
                  const void* offs, int inclusive, void* stream) {
  if (n < 1 || tile < (long long)kThreads || tile % kThreads != 0)
    return cudaErrorInvalidValue;
  const long long blocks = (n + tile - 1) / tile;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (pass == 0) {
    scan_reduce_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned*)x, (unsigned long long)n, (unsigned long long)tile, (unsigned*)dst);
  } else if (pass == 1) {
    scan_tiles_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const unsigned*)x, (unsigned long long)n, (unsigned long long)tile,
        (const unsigned*)offs, inclusive, (unsigned*)dst);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* trs_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
