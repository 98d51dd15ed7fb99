// Scan probes P4-P7 and the running-max probe P8 (Hopper).
//
// Replaces the Pallas kernels of benchmarks/explore_scan.py and one of
// benchmarks/explore_keys16.py. Every value is a u32 (P4-P7) or int32 (P8)
// in an int32 tensor; u32 sums wrap mod 2^32.
//
//   P6 `_copy_kernel` (:30, launched :131): a copy, the floor of the others.
//     A persistent grid, one block an SM, each taking every 132nd chunk of
//     at most 8 KB: one thread moves them with TMA bulk transfers (global
//     -> shared memory -> global) through a ring of kCopyStages stages, so
//     no register holds data and no wave of blocks leaves SMs idle at its
//     tail.
//   P4 `_blocksum_kernel` (:77, launched :92): the sum of each probe block
//     of block_elems = block_rows * 128 elements. A probe block is split into
//     chunks of 16,384 elements, one CUDA block each, whose sums meet by
//     atomicAdd in the zeroed output; so a probe block of 2^18 elements
//     (block_rows 2048: 64 of them at 2^24) is 16 CUDA blocks, and the card
//     runs 1,024 blocks at 2^24 whatever block_rows is.
//   P5 `_addback_kernel` (:82, launched :107): the exclusive scan within
//     each probe block plus its offset. One CUDA block a probe block, which
//     walks the block in tiles of kTile elements and carries the running
//     sum in registers from tile to tile (the probe's block is the unit of
//     the add-back, so block_rows 1024 and 2048 run 128 and 64 blocks at
//     2^24, fewer than the 132 SMs).
//   P7 `_scan_kernel_and` (:56, launched :145): the exclusive scan of the
//     whole array in one pass, its carry chained from tile to tile. Blocks
//     run in thread-block clusters of kCluster; a cluster takes its place
//     in the chain from a ticket (atomicAdd), each block scans its tile of
//     kTile elements in registers, and the tile totals meet in the leading
//     block's shared memory (distributed shared memory, cluster barriers).
//     Only the leader links through L2: it waits for the previous
//     cluster's inclusive prefix (a relaxed load of a 64-bit flag word:
//     value in the high half) and publishes its own (a relaxed store),
//     then hands each block its prefix. No look-back, unlike K4
//     (csrc/scan.cu): the chain passes through every cluster one after
//     another, so its time is bounded by the number of clusters times the
//     latency of one link, not only by the bytes.
//   P8 `_cummax_kernel` (benchmarks/explore_keys16.py:45, `cummax_1d` :80):
//     the inclusive running max of int32 with identity 0, so the result is
//     max(0, cummax(x)): the same chained body as P7, instantiated with max.
//
// Bound on this card: P4 reads 4 bytes an element, the others read and
// write 8, at 3.35 TB/s (2^24 elements: 0.0200 ms and 0.0401 ms). The
// chained scans P7 and P8 are further bounded by their chain: 64 links at
// 2^24 with tiles of 32,768 in clusters of 8.
//
// Pointers of P4, P5 and P6 are 16-byte aligned (the wrapper checks); the
// chained scans take any alignment and n. The caller zeroes P4's sums and
// the chained scans' flags and ticket on the launch's stream.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---- P6: a copy through TMA bulk transfers ---------------------------------
constexpr unsigned kCopyChunkBytes = 8192;  // the largest chunk: 2,048 elements
constexpr unsigned kCopyStages = 24;        // the ring of chunks in shared memory
constexpr unsigned kCopyLag = 8;            // stores in flight before their stages refill
constexpr unsigned kCopySmemBytes = kCopyStages * kCopyChunkBytes;
static_assert(kCopyLag >= 1 && kCopyLag < kCopyStages, "a chunk is loaded before it is waited on");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned phase) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(phase) : "memory");
  } while (!done);
}

// Block b copies chunks b, b + grid, b + 2 * grid, ... of `chunk` bytes
// (the host makes every block's count of chunks equal, to within the last
// chunk of the array, which may be shorter: a shorter transfer). Chunks are
// dealt out in turn, not as one share a block: the blocks then read and
// write neighbouring addresses at any moment, which measured faster on the
// H100 than shares of 1/132 of the array each. Thread 0 alone: it loads up
// to kCopyStages chunks ahead, each into its stage with an mbarrier
// counting the stage's bytes in; stores each chunk as soon as it is in;
// and refills the stage of the chunk kCopyLag before once that chunk's
// store has read it (`wait_group.read`). Both transfers carry an L2
// evict-first policy: nothing is read twice. Every size and address is a
// multiple of 16, as the bulk copy needs.
__global__ void __launch_bounds__(32)
grid_copy_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ out,
                 unsigned long long total, unsigned chunk) {
  extern __shared__ __align__(128) unsigned char stage[];
  __shared__ __align__(8) unsigned long long full[kCopyStages];
  if (threadIdx.x != 0) return;
  const unsigned long long lo = (unsigned long long)blockIdx.x * chunk;
  const unsigned long long step = (unsigned long long)gridDim.x * chunk;
  const unsigned long long chunks = lo < total ? (total - lo + step - 1) / step : 0;
  for (unsigned s = 0; s < kCopyStages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(full + s)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  auto bytes_of = [&](unsigned long long k) {
    const unsigned long long left = total - lo - k * step;
    return (unsigned)(left < chunk ? left : chunk);
  };
  auto load = [&](unsigned long long k) {
    const unsigned s = (unsigned)(k % kCopyStages), bar = smem_addr(full + s);
    const unsigned bytes = bytes_of(k);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
        " [%0], [%1], %2, [%3], %4;"
        ::"r"(smem_addr(stage + s * kCopyChunkBytes)), "l"(x + lo + k * step), "r"(bytes),
        "r"(bar), "l"(policy) : "memory");
  };
  for (unsigned long long k = 0; k < chunks && k < kCopyStages; ++k) load(k);
  for (unsigned long long k = 0; k < chunks; ++k) {
    const unsigned s = (unsigned)(k % kCopyStages);
    mbar_wait(smem_addr(full + s), (unsigned)(k / kCopyStages) & 1);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;"
                 ::"l"(out + lo + k * step), "r"(smem_addr(stage + s * kCopyChunkBytes)),
                 "r"(bytes_of(k)), "l"(policy) : "memory");
    asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    if (k >= kCopyLag && k - kCopyLag + kCopyStages < chunks) {
      asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(kCopyLag) : "memory");
      load(k - kCopyLag + kCopyStages);
    }
  }
  // the stores read shared memory until they complete: the block waits
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// ---- P4: chunks of 16-byte vectors -----------------------------------------
constexpr unsigned kChunkThreads = 256;
constexpr unsigned kVecs = 16;  // vectors a thread
constexpr unsigned kChunkVecs = kChunkThreads * kVecs;  // a chunk: 16,384 elements

// CUDA block c sums chunk (c % parts) of probe block (c / parts).
__global__ void __launch_bounds__(kChunkThreads)
blocksum_kernel(const uint4* __restrict__ x, unsigned long long block_vecs, unsigned parts,
                unsigned* __restrict__ sums) {
  __shared__ unsigned warp_sum[kChunkThreads / 32];
  const unsigned b = blockIdx.x / parts, part = blockIdx.x % parts;
  const unsigned long long lo = b * block_vecs + (unsigned long long)part * kChunkVecs;
  const unsigned long long hi = (b + 1ull) * block_vecs;
  uint4 v[kVecs];
#pragma unroll
  for (unsigned k = 0; k < kVecs; ++k) {
    const unsigned long long i = lo + threadIdx.x + k * kChunkThreads;
    v[k] = i < hi ? x[i] : make_uint4(0u, 0u, 0u, 0u);
  }
  unsigned s = 0;
#pragma unroll
  for (unsigned k = 0; k < kVecs; ++k) s += v[k].x + v[k].y + v[k].z + v[k].w;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned t = 0;
#pragma unroll
    for (unsigned w = 0; w < kChunkThreads / 32; ++w) t += warp_sum[w];
    atomicAdd(sums + b, t);
  }
}

// ---- P5, P7, P8: a tile of kTile elements scanned in registers --------------
constexpr unsigned kScanThreads = 512;
constexpr unsigned kScanWarps = kScanThreads / 32;
constexpr unsigned kGroups = 16;  // a thread: 16 groups of 4 items
constexpr unsigned kStride = 4 * kScanThreads;
constexpr unsigned kTile = kGroups * kStride;  // 32,768 elements

struct AddU32 {
  using T = unsigned;
  static __device__ __forceinline__ T op(T a, T b) { return a + b; }
};

struct MaxI32 {
  using T = int;
  static __device__ __forceinline__ T op(T a, T b) { return a > b ? a : b; }
};

// Both operators take 0 as their identity: for AddU32 it is one; for MaxI32
// it gives the probe's max(0, cummax(x)), which every extra 0 leaves as it is.
//
// Scans the tile of kTile elements from lo (those at hi and beyond read as
// 0), calls prefix_of(tile total) in every thread, which returns the tile's
// prefix, and writes the inclusive (or exclusive) scan combined with that
// prefix for the elements below hi. Group g of this thread holds elements
// lo + g * kStride + 4 * threadIdx.x + 0..3, so a warp's 16-byte loads and
// stores cover 512 consecutive bytes. The groups are scanned side by side
// across the warp; warp 0 then turns the warp totals in shared memory into
// each (group, warp)'s exclusive prefix within the tile. One function, so
// that its arrays stay in registers.
template <class Op, bool kInclusive, class PrefixOf>
__device__ __forceinline__ void scan_tile(const typename Op::T* __restrict__ x,
                                          typename Op::T* __restrict__ out,
                                          unsigned long long lo, unsigned long long hi, bool vec,
                                          typename Op::T (*warp_tot)[kScanWarps + 1],
                                          PrefixOf prefix_of) {
  using T = typename Op::T;
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned long long first = lo + 4ull * threadIdx.x;
  T v[kGroups][4];  // the inclusive scan within each group of 4 items
  if (vec) {
#pragma unroll
    for (unsigned g = 0; g < kGroups; ++g) {
      const uint4 w = *reinterpret_cast<const uint4*>(x + first + g * kStride);
      v[g][0] = (T)w.x; v[g][1] = (T)w.y; v[g][2] = (T)w.z; v[g][3] = (T)w.w;
    }
  } else {
#pragma unroll
    for (unsigned g = 0; g < kGroups; ++g)
#pragma unroll
      for (unsigned e = 0; e < 4; ++e) {
        const unsigned long long i = first + g * kStride + e;
        v[g][e] = i < hi ? x[i] : T(0);
      }
  }
  T inc[kGroups];
#pragma unroll
  for (unsigned g = 0; g < kGroups; ++g) {
#pragma unroll
    for (unsigned e = 1; e < 4; ++e) v[g][e] = Op::op(v[g][e - 1], v[g][e]);
    inc[g] = v[g][3];
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (unsigned g = 0; g < kGroups; ++g) {
      const T u = __shfl_up_sync(kFull, inc[g], o);
      if (lane >= (unsigned)o) inc[g] = Op::op(u, inc[g]);
    }
  }
  if (lane == 31) {
#pragma unroll
    for (unsigned g = 0; g < kGroups; ++g) warp_tot[g][warp] = inc[g];
  }
  // start: first the exclusive prefix within the warp, so that inc dies here
  T start[kGroups];
#pragma unroll
  for (unsigned g = 0; g < kGroups; ++g) {
    const T u = __shfl_up_sync(kFull, inc[g], 1);
    start[g] = lane ? u : T(0);
  }
  __shared__ T s_total;
  __syncthreads();
  if (warp == 0) {
    // lane g < kGroups: group g's total, the groups' exclusive scan, then
    // the exclusive prefix of each warp's part of group g, in place
    T sum = 0;
    if (lane < kGroups) {
#pragma unroll
      for (unsigned w = 0; w < kScanWarps; ++w) sum = Op::op(sum, warp_tot[lane][w]);
    }
#pragma unroll
    for (int o = 1; o < (int)kGroups; o <<= 1) {
      const T u = __shfl_up_sync(kFull, sum, o);
      if (lane >= (unsigned)o) sum = Op::op(u, sum);
    }
    const T total = __shfl_sync(kFull, sum, kGroups - 1);
    T pre = __shfl_up_sync(kFull, sum, 1);
    if (lane < kGroups) {
      pre = lane ? pre : T(0);
#pragma unroll
      for (unsigned w = 0; w < kScanWarps; ++w) {
        const T u = warp_tot[lane][w];
        warp_tot[lane][w] = pre;
        pre = Op::op(pre, u);
      }
    }
    if (lane == 0) s_total = total;
  }
  __syncthreads();
#pragma unroll
  for (unsigned g = 0; g < kGroups; ++g) start[g] = Op::op(warp_tot[g][warp], start[g]);
  const T prefix = prefix_of(s_total);
#pragma unroll
  for (unsigned g = 0; g < kGroups; ++g) {
    const T base = Op::op(prefix, start[g]);
    T r[4];
#pragma unroll
    for (unsigned e = 0; e < 4; ++e)
      r[e] = kInclusive ? Op::op(base, v[g][e]) : (e ? Op::op(base, v[g][e ? e - 1 : 0]) : base);
    if (vec) {
      *reinterpret_cast<uint4*>(out + first + g * kStride) =
          make_uint4((unsigned)r[0], (unsigned)r[1], (unsigned)r[2], (unsigned)r[3]);
    } else {
#pragma unroll
      for (unsigned e = 0; e < 4; ++e) {
        const unsigned long long i = first + g * kStride + e;
        if (i < hi) out[i] = r[e];
      }
    }
  }
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
  return ((((uintptr_t)a) | ((uintptr_t)b)) & 15) == 0;
}

// One block a probe block: its tiles in turn, the running sum carried in
// registers from offs[b].
__global__ void __launch_bounds__(kScanThreads)
addback_kernel(const unsigned* __restrict__ offs, const unsigned* __restrict__ x,
               unsigned long long block_elems, unsigned* __restrict__ out) {
  __shared__ unsigned warp_tot[kGroups][kScanWarps + 1];  // + 1: no bank conflicts
  const unsigned long long lo_b = blockIdx.x * block_elems, hi_b = lo_b + block_elems;
  unsigned carry = offs[blockIdx.x];
  for (unsigned long long lo = lo_b; lo < hi_b; lo += kTile) {
    scan_tile<AddU32, false>(x, out, lo, hi_b, lo + kTile <= hi_b, warp_tot,
                             [&](unsigned total) {
                               const unsigned prefix = carry;
                               carry += total;
                               return prefix;
                             });
    __syncthreads();  // warp_tot is written again by the next tile
  }
}

// ---- P7, P8: the chain, carried cluster by cluster --------------------------
constexpr unsigned kCluster = 8;  // blocks a cluster; one link of the chain a cluster

// The link is relaxed, with no fence and no L1 invalidation on it: a
// cluster's flag and inclusive prefix share one aligned 64-bit word,
// written by one store and read by one load, and a single aligned 64-bit
// access is single-copy atomic, so a reader sees the word whole or not at
// all; and no other datum is published through the flag (each block
// writes its own tile of `out`, which no other block reads), so nothing
// has to be ordered before or after it.
__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// flags[c]: 0 until cluster c publishes, then (inclusive prefix << 32) | 1.
// Cluster c (its place from the ticket, so that a cluster waits only on
// clusters that already run) holds tiles c * kCluster + rank. Hazards:
// - The grid is a whole number of clusters: the last cluster's blocks past
//   the array (lo >= n) hold no elements, read nothing, write nothing, and
//   still pass every cluster barrier with the identity 0 as their total.
// - Shared memory of another block is touched only between the first
//   cluster barrier (every block of the cluster has started) and the last
//   (no block exits while a partner may still read or write its shared
//   memory).
// - The 16-byte path needs both pointers 16-byte aligned and a whole tile;
//   any other tile (the last partial one, a view that starts at an odd
//   element) takes the scalar path.
// - Launched only as clusters of kCluster (cudaLaunchKernelEx, after
//   cudaOccupancyMaxActiveClusters shows one can be resident); a launch of
//   any other shape traps rather than run unchained.
template <class Op, bool kInclusive>
__global__ void __launch_bounds__(kScanThreads)
chained_scan_kernel(const typename Op::T* __restrict__ x, unsigned long long n,
                    typename Op::T* __restrict__ out, unsigned long long* __restrict__ flags,
                    unsigned long long* __restrict__ ticket) {
  using T = typename Op::T;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  __shared__ T warp_tot[kGroups][kScanWarps + 1];  // + 1: no bank conflicts
  __shared__ unsigned long long s_cluster;  // the leader's: the cluster's place in the chain
  __shared__ T s_tile_total[kCluster];      // the leader's: each block's tile total
  __shared__ T s_prefix;                    // this block's prefix, put here by the leader
  if (threadIdx.x == 0) {
    if (cluster.num_blocks() != kCluster) __trap();
    if (rank == 0) s_cluster = atomicAdd(ticket, 1ull);
  }
  cluster.sync();  // every block runs, and the leader's ticket is in
  const unsigned long long c = *cluster.map_shared_rank(&s_cluster, 0);
  const unsigned long long lo = (c * kCluster + rank) * kTile;
  const unsigned long long hi = lo + kTile < n ? lo + kTile : n;
  const bool vec = aligned16(x, out) && lo + kTile <= n;
  scan_tile<Op, kInclusive>(x, out, lo, hi, vec, warp_tot, [&](T total) {
    if (threadIdx.x == 0) *cluster.map_shared_rank(&s_tile_total[rank], 0) = total;
    cluster.sync();  // the tile totals are in the leader
    if (rank == 0 && threadIdx.x < 32) {
      // lane r < kCluster: the inclusive scan of the tile totals to block r
      const unsigned lane = threadIdx.x;
      T inc = lane < kCluster ? s_tile_total[lane] : T(0);
#pragma unroll
      for (int o = 1; o < (int)kCluster; o <<= 1) {
        const T u = __shfl_up_sync(kFull, inc, o);
        if (lane >= (unsigned)o) inc = Op::op(u, inc);
      }
      const T cluster_total = __shfl_sync(kFull, inc, kCluster - 1);
      const T before = __shfl_up_sync(kFull, inc, 1);
      T prefix = 0;
      if (lane == 0) {
        if (c > 0) {
          unsigned long long d;
          do {
            d = load_relaxed(flags + c - 1);
          } while (d == 0);
          prefix = (T)(unsigned)(d >> 32);
        }
        store_relaxed(flags + c,
                      ((unsigned long long)(unsigned)Op::op(prefix, cluster_total) << 32) | 1ull);
      }
      prefix = __shfl_sync(kFull, prefix, 0);
      if (lane < kCluster)
        *cluster.map_shared_rank(&s_prefix, lane) = lane ? Op::op(prefix, before) : prefix;
    }
    cluster.sync();  // each block's prefix is in its shared memory
    return s_prefix;
  });
  cluster.sync();  // no block leaves while a partner may touch its shared memory
}

cudaLaunchConfig_t chain_config(unsigned blocks, cudaStream_t stream,
                                cudaLaunchAttribute* cluster_dim) {
  cluster_dim->id = cudaLaunchAttributeClusterDimension;
  cluster_dim->val.clusterDim.x = kCluster;
  cluster_dim->val.clusterDim.y = 1;
  cluster_dim->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kScanThreads);
  cfg.stream = stream;
  cfg.attrs = cluster_dim;
  cfg.numAttrs = 1;
  return cfg;
}

// The clusters of kCluster blocks of the chained scan that the current
// device can hold at once (0: none, and no chained scan can run).
template <class Op, bool kInclusive>
int chain_max_active(int* active) {
  auto kernel = chained_scan_kernel<Op, kInclusive>;
  if (kCluster > 8) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute cluster_dim;
  const cudaLaunchConfig_t cfg = chain_config(kCluster, 0, &cluster_dim);
  return cudaOccupancyMaxActiveClusters(active, kernel, &cfg);
}

template <class Op, bool kInclusive>
int launch_chained(const void* x, long long n, void* out, void* scratch, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const long long tiles = (n + kTile - 1) / kTile;
  const long long clusters = (tiles + kCluster - 1) / kCluster;
  if (clusters * kCluster > 0x7fffffffLL) return cudaErrorInvalidValue;
  // whether a cluster can be resident: asked once a process (the port
  // runs on one device)
  static int active = -1;
  if (active < 0) {
    const int err = chain_max_active<Op, kInclusive>(&active);
    if (err != cudaSuccess) {
      active = -1;
      return err;
    }
  }
  if (active < 1) return cudaErrorLaunchOutOfResources;
  unsigned long long* flags = (unsigned long long*)scratch;
  using T = typename Op::T;
  cudaLaunchAttribute cluster_dim;
  const cudaLaunchConfig_t cfg = chain_config(
      (unsigned)(clusters * kCluster), (cudaStream_t)stream, &cluster_dim);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, chained_scan_kernel<Op, kInclusive>,
                                             (const T*)x, (unsigned long long)n, (T*)out,
                                             flags, flags + clusters);
  const cudaError_t last = cudaGetLastError();  // read, and cleared for the next launch
  return err != cudaSuccess ? err : last;
}

}  // namespace

extern "C" {

// out = x, n elements (a multiple of 4); x, out 16-byte aligned.
int trs_grid_copy(const void* x, void* out, long long n, void* stream) {
  if (n < 4 || n % 4) return cudaErrorInvalidValue;
  int dev, sms;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  static bool smem_set = false;
  if (err == cudaSuccess && !smem_set) {
    err = cudaFuncSetAttribute(grid_copy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kCopySmemBytes);
    smem_set = err == cudaSuccess;
  }
  if (err != cudaSuccess) return err;
  // a block an SM, each with an equal count of chunks of at most
  // kCopyChunkBytes, every chunk a whole number of 128-byte lines
  const unsigned long long total = 4ull * n, grid = (unsigned long long)sms;
  const unsigned long long per = (total + grid * kCopyChunkBytes - 1) / (grid * kCopyChunkBytes);
  const unsigned long long chunk = (total + grid * per * 128 - 1) / (grid * per * 128) * 128;
  const unsigned long long chunks = (total + chunk - 1) / chunk;
  grid_copy_kernel<<<(unsigned)(chunks < grid ? chunks : grid), 32, kCopySmemBytes,
                     (cudaStream_t)stream>>>((const unsigned char*)x, (unsigned char*)out, total,
                                             (unsigned)chunk);
  return cudaGetLastError();
}

// sums[b] += the u32 sum of x[b * block_elems : (b + 1) * block_elems], for
// the n / block_elems probe blocks; block_elems a multiple of 4 dividing n;
// x 16-byte aligned; sums zeroed by the caller.
int trs_blocksum(const void* x, long long n, long long block_elems, void* sums, void* stream) {
  if (n < 1 || block_elems < 4 || block_elems % 4 || n % block_elems)
    return cudaErrorInvalidValue;
  const long long parts = (block_elems / 4 + kChunkVecs - 1) / kChunkVecs;
  const long long blocks = n / block_elems * parts;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  blocksum_kernel<<<(unsigned)blocks, kChunkThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (unsigned long long)(block_elems / 4), (unsigned)parts, (unsigned*)sums);
  return cudaGetLastError();
}

// out[i] = offs[b] + the exclusive u32 scan of probe block b up to i, for i
// in block b; block_elems a multiple of 4 dividing n; x, out 16-byte aligned.
int trs_addback(const void* offs, const void* x, long long n, long long block_elems, void* out,
                void* stream) {
  if (n < 1 || block_elems < 4 || block_elems % 4 || n % block_elems)
    return cudaErrorInvalidValue;
  const long long blocks = n / block_elems;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  addback_kernel<<<(unsigned)blocks, kScanThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned*)offs, (const unsigned*)x, (unsigned long long)block_elems,
      (unsigned*)out);
  return cudaGetLastError();
}

// out = the exclusive u32 scan of x[0:n]. scratch: one flag a cluster,
// ceil(ceil(n / kTile) / kCluster), and one ticket, 64 bits each, zeroed on
// `stream`.
int trs_chained_scan(const void* x, long long n, void* out, void* scratch, void* stream) {
  return launch_chained<AddU32, false>(x, n, out, scratch, stream);
}

// out = max(0, the inclusive running max of the int32 x[0:n]); scratch as
// for trs_chained_scan.
int trs_cummax(const void* x, long long n, void* out, void* scratch, void* stream) {
  return launch_chained<MaxI32, true>(x, n, out, scratch, stream);
}

// *cluster = the blocks of a chained scan's cluster; *active = the clusters
// that the current device can hold at once.
int trs_chain_clusters(int* cluster, int* active) {
  *cluster = (int)kCluster;
  return chain_max_active<AddU32, false>(active);
}

const char* trs_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
