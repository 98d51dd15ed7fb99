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
// Both kernels must be given the same tile.
//
// Bound on this card: the histogram reads 4 * n bytes; the reorder reads
// and writes n_arr * 4 * n bytes, at 3.35 TB/s. The reorder's design keeps
// a whole chunk of every column in flight and writes whole runs, as the TPU
// kernel does by compacting each block's digit runs in VMEM first:
// - a block owns one tile and walks it in chunks of kItems = 16 elements a
//   thread (4,096 with 256 threads, one chunk per default tile; a smaller
//   tile is one chunk with fewer threads, reorder_plan). Every column of a
//   chunk is copied into shared memory with cp.async (16 bytes a copy where
//   aligned), all copies issued before the block waits for any;
// - the chunk is ranked at once from the key column. Thread t holds 16
//   consecutive elements and counts their digits; an exclusive scan of the
//   counts over the warp's lanes (shuffles) and one digit-major scan of the
//   warps' totals (every warp computes it from shared memory after one
//   barrier) give each element its position in the chunk's digit-sorted
//   order, stable in element order. No ballot or popc per element;
// - each column is then written to shared memory at those positions and
//   read back in order: thread t takes slots t, t + threads, ..., and slot s
//   of run r goes to out[offs[r, b] + (earlier chunks' run r) + s - start[r]].
//   A warp's store is 32 consecutive words, cut at most at a run boundary.
//   The shuffle of column c goes into the area column c - 1 came in, so one
//   barrier per column suffices. Both shared layouts are swizzled so that
//   the copy-in, the per-thread reads, the in-order reads and the scatter
//   of all-equal keys (one digit run) meet no bank conflicts.
// 64 registers a thread (4 blocks an SM), no spills; shared memory (n_arr
// + 1) * 16 KB a block. Counts are 32-bit where they reach a tile's 2^16.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kMaxThreads = 256;
constexpr unsigned kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// reorder: elements a thread holds per chunk, and the largest chunk
constexpr unsigned kItems = 16;
constexpr unsigned kWarpSpan = 32 * kItems;
constexpr unsigned kMaxChunk = kMaxThreads * kItems;

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

__device__ __forceinline__ void cp_async4(unsigned* sh, const unsigned* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(sh)), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async16(unsigned* sh, const unsigned* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(sh)), "l"(g) : "memory");
}

// Shared-memory layouts of a chunk column (both permutations of its words):
// - as copied in, 16-byte granule g at granule g ^ ((g >> 3) & 7), so that
//   a warp reading 16 consecutive words a lane (four 16-byte loads) hits
//   every bank once per quarter-warp;
// - as shuffled, word p at row p >> 5, column (p ^ (p >> 5)) & 31, so that
//   a warp reading 32 consecutive slots, or writing one digit run from a
//   multiple of 32 on, 16 slots a lane apart, hits every bank once.
__device__ __forceinline__ unsigned granule_at(unsigned g) { return g ^ ((g >> 3) & 7u); }
__device__ __forceinline__ unsigned slot_at(unsigned p) {
  return (p & ~31u) | ((p ^ (p >> 5)) & 31u);
}

// Starts the copy of `len` words from col into sh in the copied-in layout:
// whole granules where col is 16-byte aligned and len a multiple of 4, else
// word by word.
__device__ __forceinline__ void copy_chunk(unsigned* sh, const unsigned* col, unsigned len) {
  if (((uintptr_t)col & 15) == 0 && (len & 3) == 0) {
    for (unsigned g = threadIdx.x; g < len / 4; g += blockDim.x)
      cp_async16(sh + 4 * granule_at(g), col + 4 * g);
  } else {
    for (unsigned i = threadIdx.x; i < len; i += blockDim.x)
      cp_async4(sh + 4 * granule_at(i >> 2) + (i & 3u), col + i);
  }
}

// This thread's kItems consecutive words of a chunk column, from `first`;
// 0 for a granule that starts at or past `len` (a ragged or small tile).
__device__ __forceinline__ void load_items(const unsigned* sh, unsigned first, unsigned len,
                                           unsigned (&v)[kItems]) {
#pragma unroll
  for (unsigned q = 0; q < kItems / 4; ++q) {
    const unsigned g = first / 4 + q;
    const uint4 x = first + 4 * q < len
                        ? *reinterpret_cast<const uint4*>(sh + 4 * granule_at(g))
                        : make_uint4(0u, 0u, 0u, 0u);
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

// The 16-bit field r of a (lo, hi) pair holding four: fields 0, 1 in lo.
__device__ __forceinline__ unsigned field(unsigned lo, unsigned hi, unsigned r) {
  return ((r & 2u ? hi : lo) >> (16 * (r & 1u))) & 0xffffu;
}

// Dynamic shared memory: n_arr + 1 areas of `chunk` words. Column c of a
// chunk arrives in area c; it is shuffled into the area of column c - 1
// (column 0 into area n_arr), whose words were all read before the
// previous column's barrier. Thread t of warp w holds chunk elements
// 512 w + 16 l + k, k < kItems (l its lane): element order is (warp, lane,
// item), so a thread's count of each digit, one exclusive scan over the
// warp's lanes and one over the block's warps give every rank.
__global__ void __launch_bounds__(kMaxThreads, 4)
reorder_kernel(const unsigned* __restrict__ src, unsigned* __restrict__ dst, unsigned n,
               int n_arr, unsigned bit, unsigned tile, unsigned chunk, unsigned nblocks,
               const unsigned* __restrict__ offs) {
  extern __shared__ __align__(16) unsigned smem[];
  __shared__ unsigned warp_counts[4 * kMaxWarps];  // digit-major [4][nwarps]
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned nwarps = blockDim.x >> 5;
  const unsigned first = warp * kWarpSpan + lane * kItems;  // this thread's first element
  const unsigned base = blockIdx.x * tile;
  const unsigned end = n - base < tile ? n : base + tile;
  // output position of the next element of each digit run of this tile
  unsigned next[4];
#pragma unroll
  for (unsigned r = 0; r < 4; ++r) next[r] = offs[r * nblocks + blockIdx.x];
  for (unsigned c0 = base; c0 < end; c0 += chunk) {
    const unsigned len = end - c0 < chunk ? end - c0 : chunk;
    if (c0 != base) __syncthreads();  // the last chunk's stores have read smem
    for (int c = 0; c < n_arr; ++c) copy_chunk(smem + c * chunk, src + (size_t)c * n + c0, len);
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();

    // this thread's digits (2 bits each) and its count of each (8 bits each)
    unsigned digits = 0, counts = 0;
    {
      unsigned v[kItems];
      load_items(smem, first, len, v);
#pragma unroll
      for (unsigned k = 0; k < kItems; ++k) {
        const unsigned d = (v[k] >> bit) & 3u;
        digits |= d << (2 * k);
        if (first + k < len) counts += 1u << (8 * d);
      }
    }
    // exclusive scan over the warp's lanes, 16-bit fields (lo: digits 0, 1)
    const unsigned lo = __byte_perm(counts, 0, 0x4140), hi = __byte_perm(counts, 0, 0x4342);
    unsigned inc_lo = lo, inc_hi = hi;
#pragma unroll
    for (unsigned o = 1; o < 32; o <<= 1) {
      const unsigned t_lo = __shfl_up_sync(kFull, inc_lo, o);
      const unsigned t_hi = __shfl_up_sync(kFull, inc_hi, o);
      if (lane >= o) {
        inc_lo += t_lo;
        inc_hi += t_hi;
      }
    }
    if (lane == 31) {
#pragma unroll
      for (unsigned r = 0; r < 4; ++r) warp_counts[r * nwarps + warp] = field(inc_lo, inc_hi, r);
    }
    __syncthreads();
    // the digit-major exclusive scan of the warp counts: entry r * nwarps + w
    // is where warp w's digit-r elements start in the chunk's sorted order
    const unsigned cnt = lane < 4 * nwarps ? warp_counts[lane] : 0u;
    unsigned incl = cnt;
#pragma unroll
    for (unsigned o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const unsigned excl = incl - cnt;
    unsigned start[4], mine[4], delta[4];
#pragma unroll
    for (unsigned r = 0; r < 4; ++r) {
      start[r] = __shfl_sync(kFull, excl, r * nwarps);
      mine[r] = __shfl_sync(kFull, excl, r * nwarps + warp);
    }
    // the chunk position of this thread's next element of each digit, 16
    // bits each (below 2^13: no carry between fields)
    unsigned long long at = (unsigned long long)((mine[2] | mine[3] << 16) + inc_hi - hi) << 32 |
                            ((mine[0] | mine[1] << 16) + inc_lo - lo);
    unsigned pos[kItems];
#pragma unroll
    for (unsigned k = 0; k < kItems; ++k) {
      const unsigned sh16 = 16 * ((digits >> (2 * k)) & 3u);
      pos[k] = slot_at((unsigned)(at >> sh16) & 0xffffu);
      at += 1ull << sh16;
    }
#pragma unroll
    for (unsigned r = 0; r < 4; ++r) {
      // slot s of run r goes to delta[r] + s; the next chunk's runs follow
      delta[r] = next[r] - start[r];
      next[r] += (r < 3 ? start[r + 1] : len) - start[r];
    }

    for (int c = 0; c < n_arr; ++c) {
      unsigned* sh = smem + (c == 0 ? n_arr : c - 1) * chunk;
      unsigned v[kItems];
      load_items(smem + c * chunk, first, len, v);
#pragma unroll
      for (unsigned k = 0; k < kItems; ++k)
        if (first + k < len) sh[pos[k]] = v[k];
      __syncthreads();
      unsigned* out = dst + (size_t)c * n;
#pragma unroll
      for (unsigned k = 0; k < kItems; ++k) {
        const unsigned s = threadIdx.x + k * blockDim.x;
        if (s < len) {
          const unsigned r = (s >= start[1]) + (s >= start[2]) + (s >= start[3]);
          out[pick(delta, r) + s] = sh[slot_at(s)];
        }
      }
    }
  }
}

// Threads, chunk and dynamic shared memory of a reorder block: kItems
// elements a thread, 32 to kMaxThreads threads; a tile of fewer than 512
// elements leaves part of its one warp's items empty.
void reorder_plan(long long tile, int n_arr, unsigned* threads, unsigned* chunk,
                  unsigned* smem_bytes) {
  long long t = tile / kItems;
  t = t < 32 ? 32 : t > kMaxThreads ? kMaxThreads : t;
  *threads = (unsigned)t;
  *chunk = (unsigned)(tile < t * kItems ? tile : t * kItems);
  *smem_bytes = (unsigned)(n_arr + 1) * *chunk * 4u;
}
// the widest plan fits an SM's 227 KB of shared memory a block
static_assert((6 + 1) * kMaxChunk * 4 + sizeof(unsigned) * 4 * kMaxWarps <= 232448,
              "reorder_kernel's shared memory");

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
  unsigned threads, chunk, smem_bytes;
  reorder_plan(tile, n_arr, &threads, &chunk, &smem_bytes);
  if (smem_bytes + sizeof(unsigned) * 4 * kMaxWarps > 48 * 1024) {  // with warp_counts
    err = cudaFuncSetAttribute(reorder_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes);
    if (err != cudaSuccess) return err;
  }
  reorder_kernel<<<nblocks, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const unsigned*)src, (unsigned*)dst, (unsigned)n, n_arr, (unsigned)bit,
      (unsigned)tile, chunk, nblocks, (const unsigned*)offs);
  return cudaGetLastError();
}

const char* trs_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
