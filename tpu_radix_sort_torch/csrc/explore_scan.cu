// Scan probes P4-P7 and the running-max probe P8 (Hopper).
//
// Replaces the Pallas kernels of benchmarks/explore_scan.py and one of
// benchmarks/explore_keys16.py. Every value is a u32 (P4-P7) or int32 (P8)
// in an int32 tensor; u32 sums wrap mod 2^32.
//
//   P6 `_copy_kernel` (:30, launched :131): a copy, the floor of the others.
//     Chunks of 16,384 elements, one block each, 16 loads of 16 bytes a
//     thread in flight before the stores.
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
//     whole array in one pass, its carry chained from tile to tile. A block
//     takes its tile id from a ticket (atomicAdd), scans its tile of kTile
//     elements in registers, waits for its predecessor's inclusive prefix
//     (an acquire load of a 64-bit flag word: value in the high half), and
//     publishes its own (a release store) before it writes its tile. No
//     look-back, unlike K4 (csrc/scan.cu): the chain passes through every
//     tile one after another, so its time is bounded by the number of
//     tiles times the latency of one link, not by the bytes.
//   P8 `_cummax_kernel` (benchmarks/explore_keys16.py:45, `cummax_1d` :80):
//     the inclusive running max of int32 with identity 0, so the result is
//     max(0, cummax(x)): the same chained body as P7, instantiated with max.
//
// Bound on this card: P4 reads 4 bytes an element, the others read and
// write 8, at 3.35 TB/s (2^24 elements: 0.0200 ms and 0.0401 ms). The
// chained scans P7 and P8 are further bounded by their chain: 512 links at
// 2^24 with tiles of 32,768.
//
// Pointers of P4, P5 and P6 are 16-byte aligned (the wrapper checks); the
// chained scans take any alignment and n. The caller zeroes P4's sums and
// the chained scans' flags and ticket on the launch's stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---- P6, P4: chunks of 16-byte vectors -------------------------------------
constexpr unsigned kChunkThreads = 256;
constexpr unsigned kVecs = 16;  // vectors a thread
constexpr unsigned kChunkVecs = kChunkThreads * kVecs;  // a chunk: 16,384 elements

__global__ void __launch_bounds__(kChunkThreads)
grid_copy_kernel(const uint4* __restrict__ x, uint4* __restrict__ out, unsigned long long nvec) {
  const unsigned long long base = (unsigned long long)blockIdx.x * kChunkVecs + threadIdx.x;
  uint4 v[kVecs];
#pragma unroll
  for (unsigned k = 0; k < kVecs; ++k) {
    const unsigned long long i = base + k * kChunkThreads;
    if (i < nvec) v[k] = x[i];
  }
#pragma unroll
  for (unsigned k = 0; k < kVecs; ++k) {
    const unsigned long long i = base + k * kChunkThreads;
    if (i < nvec) out[i] = v[k];
  }
}

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

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// flags[t]: 0 until tile t publishes, then (inclusive prefix << 32) | 1,
// written by one store, so the value is never seen without its flag.
template <class Op, bool kInclusive>
__global__ void __launch_bounds__(kScanThreads)
chained_scan_kernel(const typename Op::T* __restrict__ x, unsigned long long n,
                    typename Op::T* __restrict__ out, unsigned long long* __restrict__ flags,
                    unsigned long long* __restrict__ ticket) {
  using T = typename Op::T;
  __shared__ T warp_tot[kGroups][kScanWarps + 1];  // + 1: no bank conflicts
  __shared__ unsigned long long s_tile;
  __shared__ T s_prefix;
  if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1ull);
  __syncthreads();
  const unsigned long long tile = s_tile;
  const unsigned long long lo = tile * kTile, hi = lo + kTile < n ? lo + kTile : n;
  const bool vec = aligned16(x, out) && lo + kTile <= n;
  scan_tile<Op, kInclusive>(x, out, lo, hi, vec, warp_tot, [&](T total) {
    if (threadIdx.x == 0) {
      T prefix = 0;
      if (tile > 0) {
        unsigned long long d;
        do {
          d = load_acquire(flags + tile - 1);
        } while (d == 0);
        prefix = (T)(unsigned)(d >> 32);
      }
      store_release(flags + tile,
                    ((unsigned long long)(unsigned)Op::op(prefix, total) << 32) | 1ull);
      s_prefix = prefix;
    }
    __syncthreads();
    return s_prefix;
  });
}

template <class Op, bool kInclusive>
int launch_chained(const void* x, long long n, void* out, void* scratch, void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  unsigned long long* flags = (unsigned long long*)scratch;
  using T = typename Op::T;
  chained_scan_kernel<Op, kInclusive><<<(unsigned)tiles, kScanThreads, 0, (cudaStream_t)stream>>>(
      (const T*)x, (unsigned long long)n, (T*)out, flags, flags + tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = x, n elements (a multiple of 4); x, out 16-byte aligned.
int trs_grid_copy(const void* x, void* out, long long n, void* stream) {
  if (n < 4 || n % 4) return cudaErrorInvalidValue;
  const long long blocks = (n / 4 + kChunkVecs - 1) / kChunkVecs;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  grid_copy_kernel<<<(unsigned)blocks, kChunkThreads, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (uint4*)out, (unsigned long long)(n / 4));
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

// out = the exclusive u32 scan of x[0:n]. scratch: ceil(n / 32768) flags and
// one ticket, 64 bits each, zeroed on `stream`.
int trs_chained_scan(const void* x, long long n, void* out, void* scratch, void* stream) {
  return launch_chained<AddU32, false>(x, n, out, scratch, stream);
}

// out = max(0, the inclusive running max of the int32 x[0:n]); scratch as
// for trs_chained_scan.
int trs_cummax(const void* x, long long n, void* out, void* scratch, void* stream) {
  return launch_chained<MaxI32, true>(x, n, out, scratch, stream);
}

const char* trs_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
