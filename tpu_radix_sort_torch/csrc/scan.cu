// Prefix scan of a u32 array with wraparound (Hopper): one launch, one read.
//
// Replaces the TPU kernel `_scan_kernel` of tpu_radix_sort/ops/scan.py
// (launched by `scan_padded`): the exclusive or inclusive prefix sum of a
// u32 array in element order, all arithmetic in `unsigned`, so sums wrap
// exactly as u32 does. The TPU version carries a running sum across a
// sequential grid in SMEM; CUDA blocks run in no order, so this is a
// single-pass scan with decoupled look-back (Merrill and Garland, 2016):
//
//   - A block takes its tile id from a ticket counter (atomicAdd), not from
//     blockIdx.x, so it only ever waits on tiles whose blocks already run.
//   - It loads its tile of kTile elements once: 16 groups of 4 items per
//     thread, each group one 16-byte vector when the pointers are 16-byte
//     aligned and the tile is whole (a warp reads 512 consecutive bytes per
//     load), else scalar loads. It scans each group's items in registers,
//     the groups' thread sums by warp shuffles (16 scans side by side)
//     and the warp totals through shared memory.
//   - It publishes its tile's sum as one 64-bit descriptor, state in the low
//     bits and the sum in the high word, written by one store after a fence
//     (state and sum can never be seen apart). Tile 0 publishes an inclusive
//     prefix at once; any other tile its aggregate, then warp 0 looks back
//     over 32 predecessors at a time (ballot on their states, shuffle-sum of
//     their values) until it meets an inclusive prefix, and publishes its
//     own inclusive prefix.
//   - Every thread adds the tile's exclusive prefix and writes its items.
//
// Bound on this card: one read and one write of 4 * n bytes at 3.35 TB/s
// (8 bytes per element); the descriptors add 8 bytes per 16,384 elements.
// The caller zeroes the descriptors and the ticket (nblocks + 1 words of 64
// bits) on the launch's stream; the kernel allocates nothing.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kThreads = 256;
constexpr unsigned kWarps = kThreads / 32;
constexpr unsigned kGroups = 16;  // per thread: 16 groups of 4 items
constexpr unsigned kTile = kThreads * kGroups * 4;
constexpr unsigned kFull = 0xffffffffu;

// Descriptor states (low 32 bits of a tile's word; its sum is the high word).
constexpr unsigned kNone = 0, kAggregate = 1, kPrefix = 2;

__device__ __forceinline__ void publish(unsigned long long* d, unsigned state, unsigned v) {
  __threadfence();
  *(volatile unsigned long long*)d = ((unsigned long long)v << 32) | state;
}

__device__ __forceinline__ unsigned long long peek(const unsigned long long* d) {
  return *(const volatile unsigned long long*)d;
}

// Warp 0: the exclusive prefix of `tile` (> 0), from its predecessors'
// descriptors. Lane l reads tile (pos - l); the window slides back by 32
// until some lane meets an inclusive prefix.
__device__ unsigned look_back(const unsigned long long* desc, long long tile, unsigned lane) {
  unsigned prefix = 0;
  long long pos = tile - 1;
  while (true) {
    const long long t = pos - (long long)lane;
    unsigned long long d;
    unsigned state;
    do {
      d = t >= 0 ? peek(desc + t) : (unsigned long long)kPrefix;  // before tile 0: prefix 0
      state = (unsigned)d;
    } while (__any_sync(kFull, state == kNone));
    const unsigned done = __ballot_sync(kFull, state == kPrefix);
    // sum lanes 0..first prefix lane (all 32 lanes when none is a prefix)
    const unsigned last = done ? __ffs(done) - 1 : 31;
    unsigned v = lane <= last ? (unsigned)(d >> 32) : 0u;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    prefix += v;
    if (done) return prefix;
    pos -= 32;
  }
}

__global__ void __launch_bounds__(kThreads)
scan_kernel(const unsigned* __restrict__ x, unsigned long long n, int inclusive,
            unsigned* __restrict__ out, unsigned long long* __restrict__ desc,
            unsigned long long* __restrict__ ticket) {
  __shared__ unsigned s_tile;
  __shared__ unsigned warp_tot[kGroups][kWarps];
  __shared__ unsigned s_prefix;
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = (unsigned)atomicAdd(ticket, 1ull);
  __syncthreads();
  const unsigned long long tile = s_tile;
  // group g of this thread: elements first + g * kThreads * 4 + 0..3, so a
  // warp's 16-byte loads and stores cover 512 consecutive bytes
  const unsigned long long first = tile * kTile + 4ull * threadIdx.x;
  constexpr unsigned kStride = 4 * kThreads;

  unsigned v[kGroups][4];
  const bool vec = ((((uintptr_t)x) | ((uintptr_t)out)) & 15) == 0 && (tile + 1) * kTile <= n;
  if (vec) {
#pragma unroll
    for (unsigned g = 0; g < kGroups; ++g) {
      const uint4 w = *reinterpret_cast<const uint4*>(x + first + g * kStride);
      v[g][0] = w.x; v[g][1] = w.y; v[g][2] = w.z; v[g][3] = w.w;
    }
  } else {
#pragma unroll
    for (unsigned g = 0; g < kGroups; ++g)
#pragma unroll
      for (unsigned e = 0; e < 4; ++e) {
        const unsigned long long i = first + g * kStride + e;
        v[g][e] = i < n ? x[i] : 0u;
      }
  }
  // inclusive scan of each group's 4 items, then of the groups' thread sums
  // across the warp (the 16 scans side by side)
  unsigned inc[kGroups];
#pragma unroll
  for (unsigned g = 0; g < kGroups; ++g) {
#pragma unroll
    for (unsigned e = 1; e < 4; ++e) v[g][e] += v[g][e - 1];
    inc[g] = v[g][3];
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
#pragma unroll
    for (unsigned g = 0; g < kGroups; ++g) {
      const unsigned t = __shfl_up_sync(kFull, inc[g], o);
      if (lane >= (unsigned)o) inc[g] += t;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (unsigned g = 0; g < kGroups; ++g) warp_tot[g][warp] = inc[g];
  }
  __syncthreads();
  // where each group of this thread starts within the tile, and the total
  unsigned start[kGroups], total = 0;
#pragma unroll
  for (unsigned g = 0; g < kGroups; ++g) {
    unsigned before = 0, group = 0;
#pragma unroll
    for (unsigned w = 0; w < kWarps; ++w) {
      const unsigned t = warp_tot[g][w];
      before += w < warp ? t : 0u;
      group += t;
    }
    start[g] = total + before + inc[g] - v[g][3];
    total += group;
  }

  if (warp == 0) {
    unsigned prefix = 0;
    if (tile == 0) {
      if (lane == 0) publish(desc, kPrefix, total);
    } else {
      if (lane == 0) publish(desc + tile, kAggregate, total);
      prefix = look_back(desc, (long long)tile, lane);
      if (lane == 0) publish(desc + tile, kPrefix, prefix + total);
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  const unsigned prefix = s_prefix;
#pragma unroll
  for (unsigned g = 0; g < kGroups; ++g) {
    // v[g][e] is the inclusive scan within the group; exclusive shifts by one
    unsigned r[4];
#pragma unroll
    for (unsigned e = 0; e < 4; ++e)
      r[e] = prefix + start[g] + (inclusive ? v[g][e] : (e ? v[g][e - 1] : 0u));
    if (vec) {
      *reinterpret_cast<uint4*>(out + first + g * kStride) = make_uint4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (unsigned e = 0; e < 4; ++e) {
        const unsigned long long i = first + g * kStride + e;
        if (i < n) out[i] = r[e];
      }
    }
  }
}

}  // namespace

extern "C" {

// dst = the exclusive (or inclusive) scan of x[0:n]. scratch: ceil(n / 16384)
// tile descriptors and one ticket, 64 bits each, zeroed on `stream`.
int trs_scan(const void* x, long long n, void* dst, int inclusive, void* scratch,
             void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const long long blocks = (n + kTile - 1) / kTile;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  unsigned long long* desc = (unsigned long long*)scratch;
  scan_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const unsigned*)x, (unsigned long long)n, inclusive, (unsigned*)dst, desc,
      desc + blocks);
  return cudaGetLastError();
}

const char* trs_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
