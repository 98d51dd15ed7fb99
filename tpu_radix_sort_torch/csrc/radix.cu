// One pass of the 4-way LSD radix sort: digit histogram and stable reorder
// (Hopper).
//
// Replaces two TPU kernels of tpu_radix_sort/ops/radix.py:
//   digit_histogram_kernel  `_hist_kernel` (launched by `digit_histogram`):
//       for each tile b of `tile` keys, the count of each 2-bit digit
//       (key >> bit) & 3, written digit-major as hist[r * nblocks + b].
//       Elements past n in the ragged last tile are not counted (the TPU
//       version pads with all-ones sentinels instead, which only adds to
//       the last entry, hist[3][nblocks - 1]: no offset depends on it).
//   reorder_kernel          `_reorder_kernel` (launched by `_reorder_pass`):
//       the stable 4-way split. Element i of tile b with digit r goes to
//       offs[r * nblocks + b] + (the number of earlier elements of tile b
//       with digit r), offs being the exclusive scan of the digit-major
//       histogram; all n_arr columns move with the key (column 0).
// The TPU reorder compacts each block's digit runs with log-stride shifts
// in VMEM and writes them with read-merge-write window DMAs, which relies on
// the sequential grid. Here each element is scattered straight to its place,
// the reference's own reorder (RadixSortReorder.ts:97-101). The block walks
// its tile in rounds of blockDim elements: per warp, one __ballot_sync per
// digit and __popc of the lanes below give the rank inside the warp, the
// warp counts pass through shared memory, and a running count per digit
// carries the rank across rounds. Both kernels must be given the same tile.
//
// Bound on this card: the histogram reads 4 * n bytes; the reorder reads
// and writes n_arr * 4 * n bytes, at 3.35 TB/s. The scatter writes four
// runs per warp and round, so its stores are only partly coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kMaxThreads = 256;
constexpr unsigned kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ unsigned pick(const unsigned (&a)[4], unsigned r) {
  return r == 0 ? a[0] : r == 1 ? a[1] : r == 2 ? a[2] : a[3];
}

__global__ void digit_histogram_kernel(const unsigned* __restrict__ x, unsigned n,
                                       unsigned bit, unsigned tile, unsigned nblocks,
                                       unsigned* __restrict__ hist) {
  const unsigned base = blockIdx.x * tile;
  const unsigned end = n - base < tile ? n : base + tile;
  unsigned c[4] = {0u, 0u, 0u, 0u};
  for (unsigned i = base + threadIdx.x; i < end; i += blockDim.x) {
    const unsigned d = (x[i] >> bit) & 3u;
#pragma unroll
    for (unsigned r = 0; r < 4; ++r) c[r] += d == r;
  }
#pragma unroll
  for (unsigned r = 0; r < 4; ++r)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) c[r] += __shfl_down_sync(kFull, c[r], o);
  __shared__ unsigned part[kMaxWarps][4];
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (unsigned r = 0; r < 4; ++r) part[warp][r] = c[r];
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    unsigned s = 0;
    for (unsigned w = 0; w < (blockDim.x >> 5); ++w) s += part[w][threadIdx.x];
    hist[threadIdx.x * nblocks + blockIdx.x] = s;
  }
}

__global__ void reorder_kernel(const unsigned* __restrict__ src, unsigned* __restrict__ dst,
                               unsigned n, int n_arr, unsigned bit, unsigned tile,
                               unsigned nblocks, const unsigned* __restrict__ offs) {
  // Warp counts of a round, double-buffered so that one __syncthreads()
  // per round suffices: round r writes buffer r & 1, and a thread writes
  // that buffer again only after the next round's barrier, which every
  // reader of it has passed.
  __shared__ __align__(16) unsigned counts[2][kMaxWarps][4];
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned nwarps = blockDim.x >> 5;
  const unsigned lanes_below = (1u << lane) - 1u;
  const unsigned base = blockIdx.x * tile;
  const unsigned end = n - base < tile ? n : base + tile;
  // next output position of this tile's run of each digit
  unsigned next[4];
#pragma unroll
  for (unsigned r = 0; r < 4; ++r) next[r] = offs[r * nblocks + blockIdx.x];
  unsigned p = 0;
  for (unsigned i0 = base; i0 < end; i0 += blockDim.x, p ^= 1) {
    const unsigned i = i0 + threadIdx.x;
    const bool valid = i < end;
    const unsigned key = valid ? src[i] : 0u;
    const unsigned d = valid ? (key >> bit) & 3u : 4u;  // 4: no digit
    unsigned rank = 0;
#pragma unroll
    for (unsigned r = 0; r < 4; ++r) {
      const unsigned ballot = __ballot_sync(kFull, d == r);
      if (lane == 0) counts[p][warp][r] = __popc(ballot);
      if (d == r) rank = __popc(ballot & lanes_below);
    }
    __syncthreads();
    unsigned total[4] = {0u, 0u, 0u, 0u};
    for (unsigned w = 0; w < nwarps; ++w) {
      const uint4 c = *reinterpret_cast<const uint4*>(counts[p][w]);
      if (w < warp) {
        rank += d == 0 ? c.x : d == 1 ? c.y : d == 2 ? c.z : d == 3 ? c.w : 0u;
      }
      total[0] += c.x;
      total[1] += c.y;
      total[2] += c.z;
      total[3] += c.w;
    }
    if (valid) {
      const unsigned pos = pick(next, d) + rank;
      dst[pos] = key;
      for (int c = 1; c < n_arr; ++c) dst[(size_t)c * n + pos] = src[(size_t)c * n + i];
    }
#pragma unroll
    for (unsigned r = 0; r < 4; ++r) next[r] += total[r];
  }
}

cudaError_t check_tile(long long n, long long tile, int bit) {
  // tile: a power of two in [32, 2^16]; n < 2^31; bit in [0, 30]
  if (n < 1 || n >= (1LL << 31) || tile < 32 || tile > (1LL << 16) ||
      (tile & (tile - 1)) != 0 || bit < 0 || bit > 30)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// x: n u32 keys; hist: 4 * ceil(n / tile) u32, written digit-major.
int trs_digit_histogram(const void* x, long long n, int bit, long long tile, void* hist,
                        void* stream) {
  cudaError_t err = check_tile(n, tile, bit);
  if (err != cudaSuccess) return err;
  const unsigned nblocks = (unsigned)((n + tile - 1) / tile);
  const unsigned threads = tile < kMaxThreads ? (unsigned)tile : kMaxThreads;
  digit_histogram_kernel<<<nblocks, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned*)x, (unsigned)n, (unsigned)bit, (unsigned)tile, nblocks,
      (unsigned*)hist);
  return cudaGetLastError();
}

// src, dst: (n_arr, n) u32 with n_arr in 1..6 (the widest 64-bit key path),
// row-major, not overlapping; offs: the exclusive scan of the digit-major
// histogram of src's column 0 at `bit` with the same tile, 4 * ceil(n / tile)
// u32.
int trs_reorder(const void* src, void* dst, long long n, int n_arr, int bit, long long tile,
                const void* offs, void* stream) {
  cudaError_t err = check_tile(n, tile, bit);
  if (err != cudaSuccess) return err;
  if (n_arr < 1 || n_arr > 6) return cudaErrorInvalidValue;
  const unsigned nblocks = (unsigned)((n + tile - 1) / tile);
  const unsigned threads = tile < kMaxThreads ? (unsigned)tile : kMaxThreads;
  reorder_kernel<<<nblocks, threads, 0, (cudaStream_t)stream>>>(
      (const unsigned*)src, (unsigned*)dst, (unsigned)n, n_arr, (unsigned)bit,
      (unsigned)tile, nblocks, (const unsigned*)offs);
  return cudaGetLastError();
}

const char* trs_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
