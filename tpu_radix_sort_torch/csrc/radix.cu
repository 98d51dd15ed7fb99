// One pass of the LSD radix sort: digit histogram and stable reorder
// (Hopper), for digits of w = 2, 4, 6 or 8 bits.
//
// Replaces two TPU kernels of tpu_radix_sort/ops/radix.py, which sort 2 bits
// a pass (the WebGPU reference's 4-way split):
//   digit_histogram_kernel  `_hist_kernel` (launched by `digit_histogram`):
//       for each tile b of `tile` keys, the count of each w-bit digit
//       (key >> bit) & (2^w - 1), written digit-major as hist[r * nblocks + b].
//       Elements past n in the ragged last tile are not counted (the TPU
//       version pads with all-ones sentinels instead, which only adds to
//       the last entry, hist[2^w - 1][nblocks - 1]: no offset depends on it).
//   reorder_kernel          `_reorder_kernel` (launched by `_reorder_pass`):
//       the stable 2^w-way split. Element i of tile b with digit r goes to
//       offs[r * nblocks + b] + (the number of earlier elements of tile b
//       with digit r), offs being the exclusive scan of the digit-major
//       histogram; all n_arr columns move with the key (column 0).
// Both kernels must be given the same tile and width. K5 has one body for
// every width; K6 has two, chosen by the width (reorder_kernel).
//
// The width (ops/radix.py `digit_widths`): a sort without the order check
// runs passes of 8 bits, the last of bit_count mod 8 bits (2, 4 or 6) where
// that is not 0, so a u32 key takes 4 passes where 2-bit digits take 16.
// With check_order the engine keeps the reference's 2-bit passes, and its
// check before every second one. A 2^w x nblocks table and its offsets live
// in device memory, so at w > 2 the engine's default tile grows with n until
// the table holds at most 2^18 entries (1 MiB at 2^26 keys: tile 2^16).
//
// Bound on this card: the histogram reads 4 * n bytes; the reorder reads
// and writes n_arr * 4 * n bytes, at 3.35 TB/s.
// - The histogram: each warp counts into its own 2^w bins in shared memory
//   with atomics, except that the lanes sharing lane 0's digit are counted
//   by one ballot and one add: a hot digit (all 32 lanes equal) costs one
//   atomic, not 32 on one bin.
// - The reorder moves chunks of kItems = 16 elements a thread (4,096 with
//   256 threads). Every column of a chunk is copied into shared memory with
//   cp.async (16 bytes a copy where aligned), all copies issued before the
//   block waits for any; the chunk is ranked from the key column; each
//   column is then written to shared memory at its elements' ranks and
//   read back in order: thread t takes slots t, t + threads, ..., and slot
//   s of digit run r goes to the run's output position + s - its start. A
//   warp's store is 32 consecutive words, cut at each run boundary. The
//   shuffle of column c goes into the area column c - 1 came in, so one
//   barrier per column suffices.
// - w = 2 (reorder4; 32 to 256 threads, one chunk per default tile): a
//   block owns a tile and walks it chunk by chunk, each run's output
//   position carried from chunk to chunk; thread t holds 16 consecutive
//   elements and counts their digits; an exclusive scan of the counts over
//   the warp's lanes (shuffles) and one digit-major scan of the warps'
//   totals give each element its rank, stable in element order. Both shared
//   layouts are swizzled so that the copy-in, the per-thread reads, the
//   in-order reads and the scatter of all-equal keys (one digit run) meet no
//   bank conflicts.
// - w > 2 (reorder_wide; 256 threads): a block owns one chunk, and a tile
//   of C = tile / 4,096 chunks is a thread-block cluster, whose blocks read
//   each other's digit totals (distributed shared memory). So the C pieces
//   of a digit run that a tile writes, 64 bytes each at 8 bits, are written
//   together and meet in L2; a block walking a whole tile alone left them
//   apart and ran its 2-column pass 1.9x slower. Lane l of warp v holds
//   elements 512 v + 32 k + l, k < 16; item by item, the lanes that share
//   its digit (peers_of: one ballot a digit bit; __match_any_sync measured
//   slower) give each element its rank among them and, to the lowest of
//   them alone, the group's count to add to the warp's 2^w-bin count: one
//   update a peer group. Thread r then scans digit r's counts over the 8
//   warps, and a block scan of the digit totals gives the runs' starts;
//   both are digit-major, so ranks are stable in element order. The plain
//   layout serves: the lanes read consecutive words, and all-equal keys
//   scatter to consecutive slots.
// 64 registers a thread (4 blocks an SM), no spills; shared memory (n_arr
// + 1) * 16 KB a block (w > 2: the counts share the spare area, and 4 B a
// digit hold the runs' positions). Counts are 32-bit where they reach a
// tile's 2^16.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kMaxThreads = 256;
constexpr unsigned kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// reorder: elements a thread holds per chunk, and the largest chunk
constexpr unsigned kItems = 16;
constexpr unsigned kWarpSpan = 32 * kItems;
constexpr unsigned kMaxChunk = kMaxThreads * kItems;
// w > 2: the widest digit; the words of the warps' 16-bit counts, the block
// scan's warp totals and the chunk's digit totals in the spare area; the
// largest cluster (a tile of 16 chunks)
constexpr unsigned kMaxBits = 8;
constexpr unsigned kCountWords =
    kMaxWarps * (1u << kMaxBits) / 2 + kMaxWarps + (1u << kMaxBits);
constexpr unsigned kMaxCluster = 16;
// histogram: the most threads a block
constexpr unsigned kHistThreads = 512;

__device__ __forceinline__ unsigned pick(const unsigned (&a)[4], unsigned r) {
  return r == 0 ? a[0] : r == 1 ? a[1] : r == 2 ? a[2] : a[3];
}

// The lanes of the warp whose digit equals this lane's: one ballot a bit of
// the W + 1 (the digit R = 2^W marks a lane with no element), each lane
// keeping the lanes that agree with it. W + 1 ballots whatever the digits,
// where __match_any_sync, measured on this card, takes longer the more
// distinct digits a warp holds.
template <unsigned W>
__device__ __forceinline__ unsigned peers_of(unsigned d) {
  unsigned m = kFull;
#pragma unroll
  for (unsigned b = 0; b <= W; ++b) {
    const unsigned ones = __ballot_sync(kFull, (d >> b) & 1u);
    m &= (d >> b) & 1u ? ones : ~ones;
  }
  return m;
}

template <unsigned W>
__global__ void digit_histogram_kernel(const unsigned* __restrict__ x, unsigned n,
                                       unsigned bit, unsigned tile, unsigned nblocks,
                                       unsigned* __restrict__ hist) {
  const unsigned base = blockIdx.x * tile;
  const unsigned end = n - base < tile ? n : base + tile;
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // per-warp sub-histograms in shared memory, counted with atomics; the
  // lanes that share lane 0's digit are counted by one ballot and one add,
  // so a hot digit (the entropy cell's 0 in 3 of 4 keys, or all-equal
  // keys) does not serialise a warp's atomics on one bin
  constexpr unsigned R = 1u << W;
  __shared__ unsigned sub[kHistThreads / 32][R];
  const unsigned nwarps = blockDim.x >> 5;
  for (unsigned i = threadIdx.x; i < nwarps * R; i += blockDim.x) (&sub[0][0])[i] = 0;
  __syncthreads();
  unsigned* mine = sub[warp];
  // rounds are warp-uniform (every lane runs each ballot); a lane past end
  // takes the digit R, which no bin counts
  for (unsigned i0 = base + 32 * warp; i0 < end; i0 += 4 * blockDim.x) {
    unsigned d[4];
#pragma unroll
    for (unsigned q = 0; q < 4; ++q) {
      const unsigned i = i0 + q * blockDim.x + lane;
      d[q] = i < end ? (x[i] >> bit) & (R - 1) : R;
    }
#pragma unroll
    for (unsigned q = 0; q < 4; ++q) {
      const unsigned lead = __shfl_sync(kFull, d[q], 0);
      const unsigned same = __ballot_sync(kFull, d[q] == lead);
      if (d[q] != lead) {
        if (d[q] < R) atomicAdd(mine + d[q], 1u);
      } else if (lane == 0 && lead < R) {
        atomicAdd(mine + lead, (unsigned)__popc(same));
      }
    }
  }
  __syncthreads();
  for (unsigned r = threadIdx.x; r < R; r += blockDim.x) {
    unsigned s = 0;
    for (unsigned w = 0; w < nwarps; ++w) s += sub[w][r];
    hist[r * nblocks + blockIdx.x] = s;
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

// Shared-memory layouts of a w = 2 chunk column (both permutations of its
// words):
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

// Starts the copy of `len` words from col into sh, granule g at granule
// granule_at(g) if kSwizzled, else at g: whole granules where col is
// 16-byte aligned and len a multiple of 4, else word by word.
template <bool kSwizzled>
__device__ __forceinline__ void copy_chunk(unsigned* sh, const unsigned* col, unsigned len) {
  auto at = [](unsigned g) { return kSwizzled ? granule_at(g) : g; };
  if (((uintptr_t)col & 15) == 0 && (len & 3) == 0) {
    for (unsigned g = threadIdx.x; g < len / 4; g += blockDim.x)
      cp_async16(sh + 4 * at(g), col + 4 * g);
  } else {
    for (unsigned i = threadIdx.x; i < len; i += blockDim.x)
      cp_async4(sh + 4 * at(i >> 2) + (i & 3u), col + i);
  }
}

// This thread's kItems consecutive words of a w = 2 chunk column, from
// `first`; 0 for a granule that starts at or past `len` (a ragged or small
// tile).
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

// The 4-way split (w = 2). Dynamic shared memory: n_arr + 1 areas of
// `chunk` words. Column c of a chunk arrives in area c; it is shuffled into
// the area of column c - 1 (column 0 into area n_arr), whose words were all
// read before the previous column's barrier. Thread t of warp w holds chunk
// elements 512 w + 16 l + k, k < kItems (l its lane): element order is
// (warp, lane, item), so a thread's count of each digit, one exclusive scan
// over the warp's lanes and one over the block's warps give every rank.
__device__ __forceinline__ void reorder4(unsigned* smem, const unsigned* __restrict__ src,
                                         unsigned* __restrict__ dst, unsigned n, int n_arr,
                                         unsigned bit, unsigned tile, unsigned chunk,
                                         unsigned nblocks, const unsigned* __restrict__ offs) {
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
    for (int c = 0; c < n_arr; ++c)
      copy_chunk<true>(smem + c * chunk, src + (size_t)c * n + c0, len);
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

// The 2^W-way split (W = 4, 6, 8): a block of 256 threads ranks and moves
// one chunk, and a tile of C chunks is one thread-block cluster of C blocks
// (block q of cluster b holds chunk q of tile b), so the chunks that
// finish a digit run of the output together run together: the 64-byte
// pieces a chunk writes of each run meet in L2 those of its neighbours.
// Dynamic shared memory: n_arr areas of `chunk` words, then the spare area
// X of max(chunk, kCountWords) words. Column c arrives in area c in the
// plain layout; lane l of warp v holds chunk elements 512 v + 32 k + l,
// k < kItems, so element order is (warp, item, lane) and a warp ranks its
// items one at a time. While the chunk is ranked, X holds the warps' 16-bit
// digit counts ([8][2^W], at most 512 a warp), which the scan turns into
// each warp's first position of each digit, and the chunk's digit totals,
// which the blocks of the cluster read from each other (distributed shared
// memory) to place their runs after those of the tile's earlier chunks;
// once every block has read them, column 0 is shuffled into X and column
// c > 0 into area c - 1. run[r] holds the output position of slot 0 of
// digit run r: slot s of run r goes to run[r] + s.
template <unsigned W>
__device__ __forceinline__ void reorder_wide(unsigned* smem, const unsigned* __restrict__ src,
                                             unsigned* __restrict__ dst, unsigned n, int n_arr,
                                             unsigned bit, unsigned chunk, unsigned nblocks,
                                             const unsigned* __restrict__ offs) {
  constexpr unsigned R = 1u << W;
  __shared__ unsigned run[R];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned q = cluster.block_rank();
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;  // the lanes below this one
  unsigned* x = smem + n_arr * chunk;
  unsigned short* counts = reinterpret_cast<unsigned short*>(x);  // [kMaxWarps][R]
  unsigned* wsum = x + kMaxWarps * R / 2;                         // [kMaxWarps]
  unsigned* total = wsum + kMaxWarps;                             // [R]
  unsigned short* mine = counts + warp * R;
  // this block's chunk; a cluster's last blocks may lie past n (len 0)
  const unsigned c0 = blockIdx.x * chunk;
  const unsigned len = c0 >= n ? 0u : n - c0 < chunk ? n - c0 : chunk;
  for (int c = 0; c < n_arr; ++c)
    copy_chunk<false>(smem + c * chunk, src + (size_t)c * n + c0, len);
  for (unsigned i = lane; i < R / 2; i += 32) reinterpret_cast<unsigned*>(mine)[i] = 0u;
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // rank: item by item, each element's peers in the warp; an element past
  // len takes the digit R, which no count holds. wr[k]: this lane's item k
  // as (its rank among the warp's elements of its digit) << 16 | digit
  unsigned wr[kItems];
#pragma unroll
  for (unsigned k = 0; k < kItems; ++k) {
    const unsigned e = warp * kWarpSpan + 32 * k + lane;
    const unsigned d = e < len ? (smem[e] >> bit) & (R - 1) : R;
    const unsigned peers = peers_of<W>(d);
    const unsigned before = d < R ? mine[d] : 0u;
    __syncwarp();
    if (d < R && lane == __ffs(peers) - 1) mine[d] = (unsigned short)(before + __popc(peers));
    __syncwarp();
    wr[k] = (before + __popc(peers & lt)) << 16 | d;
  }
  __syncthreads();

  // thread r < R: digit r's counts over the warps, their digit-major scan
  // and the block scan of the digit totals (threads >= R add 0)
  const unsigned r = threadIdx.x;
  unsigned start;
  {
    unsigned tot = 0;
#pragma unroll
    for (unsigned v = 0; v < kMaxWarps; ++v) tot += r < R ? counts[v * R + r] : 0u;
    unsigned incl = tot;
#pragma unroll
    for (unsigned o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) wsum[warp] = incl;
    __syncthreads();
    start = incl - tot;
    for (unsigned v = 0; v < warp; ++v) start += wsum[v];
    if (r < R) {
      unsigned at = start;
#pragma unroll
      for (unsigned v = 0; v < kMaxWarps; ++v) {
        const unsigned c = counts[v * R + r];
        counts[v * R + r] = (unsigned short)at;
        at += c;
      }
      total[r] = tot;
    }
  }
  // every block of the cluster has its totals out: digit r's run of this
  // chunk follows those of the tile's chunks 0..q-1
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (r < R) {
    unsigned before = 0;
    for (unsigned p = 0; p < q; ++p) before += *cluster.map_shared_rank(total + r, (int)p);
    run[r] = offs[r * nblocks + blockIdx.x / (unsigned)cluster.num_blocks()] + before - start;
  }
  // this lane's items' chunk positions, two 16-bit fields a word
  unsigned pos[kItems / 2];
#pragma unroll
  for (unsigned k = 0; k < kItems; k += 2) {
    const unsigned d0 = wr[k] & 0xffffu, d1 = wr[k + 1] & 0xffffu;
    const unsigned p0 = d0 < R ? mine[d0] + (wr[k] >> 16) : 0u;
    const unsigned p1 = d1 < R ? mine[d1] + (wr[k + 1] >> 16) : 0u;
    pos[k / 2] = p0 | p1 << 16;
  }
  // every block has read the totals and every count is read: X takes column 0
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");

  for (int c = 0; c < n_arr; ++c) {
    unsigned* sh = c == 0 ? x : smem + (c - 1) * chunk;
    const unsigned* in = smem + c * chunk;
#pragma unroll
    for (unsigned k = 0; k < kItems; ++k) {
      const unsigned e = warp * kWarpSpan + 32 * k + lane;
      if (e < len) sh[(pos[k / 2] >> (16 * (k & 1))) & 0xffffu] = in[e];
    }
    __syncthreads();
    // slot s's digit from the shuffled keys, which stay in X to the end
    unsigned* out = dst + (size_t)c * n;
#pragma unroll
    for (unsigned k = 0; k < kItems; ++k) {
      const unsigned s = threadIdx.x + k * kMaxThreads;
      if (s < len) out[run[(x[s] >> bit) & (R - 1)] + s] = sh[s];
    }
  }
}

template <unsigned W>
__global__ void __launch_bounds__(kMaxThreads, 4)
reorder_kernel(const unsigned* __restrict__ src, unsigned* __restrict__ dst, unsigned n,
               int n_arr, unsigned bit, unsigned tile, unsigned chunk, unsigned nblocks,
               const unsigned* __restrict__ offs) {
  extern __shared__ __align__(16) unsigned smem[];
  // reorder_wide<2> at the 2-bit passes' tile of 4,096 (a cluster of one
  // block) ran 18-33% slower than reorder4 on an H100 (80GB HBM3, 700 W),
  // pass 0 at 2^26 with 1-6 columns: 0.312-0.313, 0.451-0.452,
  // 0.680-0.682, 1.004-1.007, 1.190, 1.402 ms against 0.235, 0.378-0.379,
  // 0.570-0.571, 0.837-0.839, 1.005-1.008, 1.176 ms; so w = 2 keeps its own
  // body
  if constexpr (W == 2)
    reorder4(smem, src, dst, n, n_arr, bit, tile, chunk, nblocks, offs);
  else
    reorder_wide<W>(smem, src, dst, n, n_arr, bit, chunk, nblocks, offs);
}

// Threads, chunk and dynamic shared memory of a reorder block: kItems
// elements a thread. At w = 2, 32 to kMaxThreads threads (a tile of fewer
// than 512 elements leaves part of its one warp's items empty); at w > 2
// always kMaxThreads, with the spare area large enough for the counts, and
// tile / chunk blocks a cluster (1 to 16).
void reorder_plan(long long tile, int n_arr, int digit_bits, unsigned* threads,
                  unsigned* chunk, unsigned* smem_bytes) {
  long long t = digit_bits == 2 ? tile / kItems : kMaxThreads;
  t = t < 32 ? 32 : t > kMaxThreads ? kMaxThreads : t;
  *threads = (unsigned)t;
  *chunk = (unsigned)(tile < t * kItems ? tile : t * kItems);
  const unsigned spare = digit_bits == 2 || *chunk >= kCountWords ? *chunk : kCountWords;
  *smem_bytes = ((unsigned)n_arr * *chunk + spare) * 4u;
}
// the widest plan fits an SM's 227 KB of shared memory a block, and two
// blocks of it the SM's 228 KB (each block reserves 1 KB)
static_assert((6 + 1) * kMaxChunk * 4 + sizeof(unsigned) * (1u << kMaxBits) + 1024 <= 233472 / 2,
              "reorder_kernel's shared memory");
static_assert(kCountWords <= kMaxChunk && kMaxCluster * kMaxChunk == (1u << 16),
              "a wide tile of 2^16 is a cluster of 16 chunks, whose counts fit the spare area");

cudaError_t check_args(long long n, long long tile, int bit, int digit_bits) {
  // tile: a power of two in [32, 2^16]; n < 2^31; digit_bits 2, 4, 6 or 8;
  // bit in [0, 32 - digit_bits]
  if (n < 1 || n >= (1LL << 31) || tile < 32 || tile > (1LL << 16) ||
      (tile & (tile - 1)) != 0 || digit_bits < 2 || digit_bits > (int)kMaxBits ||
      (digit_bits & 1) != 0 || bit < 0 || bit > 32 - digit_bits)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <unsigned W>
cudaError_t launch_histogram(const void* x, long long n, int bit, long long tile, void* hist,
                             cudaStream_t stream) {
  const unsigned nblocks = (unsigned)((n + tile - 1) / tile);
  const unsigned threads = tile < kHistThreads ? (unsigned)tile : kHistThreads;
  digit_histogram_kernel<W><<<nblocks, threads, 0, stream>>>(
      (const unsigned*)x, (unsigned)n, (unsigned)bit, (unsigned)tile, nblocks, (unsigned*)hist);
  return cudaGetLastError();
}

template <unsigned W>
cudaError_t launch_reorder(const void* src, void* dst, long long n, int n_arr, int bit,
                           long long tile, const void* offs, cudaStream_t stream) {
  const unsigned nblocks = (unsigned)((n + tile - 1) / tile);
  unsigned threads, chunk, smem_bytes;
  reorder_plan(tile, n_arr, (int)W, &threads, &chunk, &smem_bytes);
  cudaError_t err = cudaSuccess;
  if (smem_bytes + sizeof(unsigned) * (1u << kMaxBits) > 48 * 1024)  // with the static arrays
    err = cudaFuncSetAttribute(reorder_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_bytes);
  if (err != cudaSuccess) return err;
  if (W == 2) {
    reorder_kernel<W><<<nblocks, threads, smem_bytes, stream>>>(
        (const unsigned*)src, (unsigned*)dst, (unsigned)n, n_arr, (unsigned)bit, (unsigned)tile,
        chunk, nblocks, (const unsigned*)offs);
    return cudaGetLastError();
  }
  const unsigned cluster = (unsigned)(tile / chunk);
  if (cluster > 8) {  // clusters above 8 blocks are not portable: allowed once a process
    static const cudaError_t allowed = cudaFuncSetAttribute(
        reorder_kernel<W>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (allowed != cudaSuccess) return allowed;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblocks * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, reorder_kernel<W>, (const unsigned*)src, (unsigned*)dst,
                           (unsigned)n, n_arr, (unsigned)bit, (unsigned)tile, chunk, nblocks,
                           (const unsigned*)offs);
  const cudaError_t last = cudaGetLastError();  // read, and cleared for the next launch
  return err != cudaSuccess ? err : last;
}

}  // namespace

extern "C" {

// x: n u32 keys; hist: 2^digit_bits * ceil(n / tile) u32, written
// digit-major.
int trs_digit_histogram(const void* x, long long n, int bit, int digit_bits, long long tile,
                        void* hist, void* stream) {
  cudaError_t err = check_args(n, tile, bit, digit_bits);
  if (err != cudaSuccess) return err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (digit_bits) {
    case 2: return launch_histogram<2>(x, n, bit, tile, hist, s);
    case 4: return launch_histogram<4>(x, n, bit, tile, hist, s);
    case 6: return launch_histogram<6>(x, n, bit, tile, hist, s);
    default: return launch_histogram<8>(x, n, bit, tile, hist, s);
  }
}

// src, dst: (n_arr, n) u32 with n_arr in 1..6 (the widest 64-bit key path),
// row-major, not overlapping; offs: the exclusive scan of the digit-major
// histogram of src's column 0 at `bit` with the same width and tile,
// 2^digit_bits * ceil(n / tile) u32.
int trs_reorder(const void* src, void* dst, long long n, int n_arr, int bit, int digit_bits,
                long long tile, const void* offs, void* stream) {
  cudaError_t err = check_args(n, tile, bit, digit_bits);
  if (err != cudaSuccess) return err;
  if (n_arr < 1 || n_arr > 6) return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (digit_bits) {
    case 2: return launch_reorder<2>(src, dst, n, n_arr, bit, tile, offs, s);
    case 4: return launch_reorder<4>(src, dst, n, n_arr, bit, tile, offs, s);
    case 6: return launch_reorder<6>(src, dst, n, n_arr, bit, tile, offs, s);
    default: return launch_reorder<8>(src, dst, n, n_arr, bit, tile, offs, s);
  }
}

const char* trs_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
