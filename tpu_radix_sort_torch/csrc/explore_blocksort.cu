// Probes P2 and P3 (Hopper): one 512 x 128 u32 tile, and many of them.
//
// blocksort_ce_kernel<C> replaces benchmarks/explore_blocksort.py:60, the
// primitive check (kernel body `ce_kernel` :42): y[r] = x[(r - 8) mod 512];
// z = min(x, y) where (r / 8) is even, else max (unsigned); the lane roll
// z[:, l] <- z[:, (l - 1) mod 128]; then the inclusive sum down the rows,
// mod 2^32. One tile is one thread-block cluster of C blocks (8, the
// portable size, or 16 where the card holds a cluster that large; the host
// picks C, `choose_cluster` in benchmarks/explore_blocksort.py): block b
// owns the band of 512 / C rows from row b * 512 / C. One thread copies the
// band and the 8 rows above it (band 0: rows 504-511) into shared memory
// with two TMA bulk transfers. The block's 256 threads are 128 lanes x 2
// chunks of the band's rows: each sums its chunk down its lane in
// registers, and the chunk totals meet in shared memory. (512 threads, 4
// chunks, measured slower on 256 tiles: fewer blocks resident, fewer bytes
// in flight.) Each block writes
// its band's 128 lane totals into the shared memory of every later block
// of the cluster (distributed shared memory); one cluster barrier orders
// those writes before each block reads its carries from its own shared
// memory, adds them and stores. A second barrier phase, which each thread
// arrives at when it starts and waits on only after its scan, makes sure
// that every block of the cluster runs before another writes into it. B
// tiles are B clusters.
//
// blocksort_stages_kernel and blocksort_stages_split_kernel<S> replace
// benchmarks/explore_blocksort.py:88, the stage-rate probe (kernel body
// `stages_kernel` :74): 64 times, x <- (min(x, y) where (r / 8) is even,
// else max(x, y)) + 1 mod 2^32, with y[r] = x[(r - 8) mod 512]. Row r needs
// only row r - 8, so a tile is 1,024 independent rings of 64 slots, one for
// each lane l and residue c = r mod 8: slot j is row c + 8j, and slot j's
// partner is slot j - 1 (slot 63 for slot 0). Every slot reads its
// partner's value from before the stage.
// - blocksort_stages_kernel (the split s = 1): a thread holds one whole ring
//   in 64 registers, and the tile stays resident in registers for all the
//   stages with no exchange at all. A block takes 32 lanes (the lanes of a
//   warp: coalesced loads) and the 8 residues, 256 threads; four blocks a
//   tile. That fills the card from 33 tiles.
// - blocksort_stages_split_kernel<S>, S in {2, ..., 32}: each ring is split
//   across S lanes of a warp, 64 / S slots a lane, so a tile takes 4 * S
//   blocks of 256 threads and one tile reaches 128 SMs at S = 32. A stage
//   passes each lane's last slot (from before the stage) to the next lane
//   of its ring with one __shfl_sync; lane 0 takes lane S - 1's, the ring's
//   own wrap. A block holds 256 / S rings: 16 lanes x 8 residues at S = 2,
//   else 8 lanes x 32 / S residues, so that every row it reads or writes
//   is a run of 32 or 64 bytes. The tile passes through shared memory, read
//   and written row by row (coalesced), each ring's slots contiguous there.
// The host picks S (`ring_split` in benchmarks/explore_blocksort.py).
//
// launch_floor_kernel is empty and replaces no TPU kernel: its time, queued
// behind the others as the probes are timed, is the card's cost of one
// launch (of one block, or of one cluster), which bounds a one-tile probe
// from below far above its bytes.
//
// Bound on this card: the tiles read once and written once at 3.35 TB/s
// (256 KB in and out a tile: 0.00016 ms; 0.0401 ms for 256 tiles), or one
// minimum or maximum an element (P2) or an element a stage (P3) on the
// integer lanes, the longer of the two; P3's + 1 and P2's running sum
// compile to VIADD, which issues beside them.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 512, kLanes = 128, kTile = kRows * kLanes;
constexpr int kShift = 8;                      // the row roll of both probes
constexpr int kResidues = kShift;              // a lane's rings: r mod 8
constexpr int kPerThread = kRows / kResidues;  // 64 slots a ring
constexpr unsigned kFull = 0xffffffffu;

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

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// ---- P2: a tile a cluster ----------------------------------------------------
constexpr int kCeChunks = 2;                    // chunks of a band's rows
constexpr int kCeThreads = kLanes * kCeChunks;  // a lane and a chunk a thread

// Hazards:
// - A block writes into another's shared memory only after the wait of
//   the first barrier phase (every block of the cluster has started), and
//   no block exits before the second phase, which each block reaches only
//   after its own writes into the others.
// - carry_in[j] of block b is written by rank j < b alone, once; block b
//   reads it only after the second phase (release by the writers, acquire
//   by the reader).
// - Launched only as clusters of C (cudaLaunchKernelEx); a launch of any
//   other shape traps.
// - in and out are 16-byte aligned (the bulk copy), and out is not in: a
//   block reads the 8 rows above its band, which another block writes.
template <int C>
__global__ void __launch_bounds__(kCeThreads)
blocksort_ce_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out) {
  constexpr int kBand = kRows / C, kPer = kBand / kCeChunks;
  constexpr unsigned kAboveBytes = kShift * kLanes * 4, kBandBytes = kBand * kLanes * 4;
  static_assert(kBand % kCeChunks == 0 && kBand % kShift == 0, "a band is whole row blocks");
  __shared__ __align__(128) uint32_t rows[(kShift + kBand) * kLanes];  // the 8 above, the band
  __shared__ uint32_t chunk_total[kCeChunks][kLanes];
  __shared__ uint32_t carry_in[C][kLanes];  // row j < b: block j's band totals
  __shared__ __align__(8) unsigned long long full;
  // this block runs: the first phase, waited on after the scan
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int b = (int)cluster.block_rank();
  const long long tile = blockIdx.x / C;
  const uint32_t* x = in + tile * kTile;
  if (threadIdx.x == 0) {
    if ((int)cluster.num_blocks() != C) __trap();
    const unsigned bar = smem_addr(&full);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(bar), "r"(kAboveBytes + kBandBytes) : "memory");
    bulk_load(rows, x + ((b * kBand - kShift) & (kRows - 1)) * kLanes, kAboveBytes, bar);
    bulk_load(rows + kShift * kLanes, x + b * kBand * kLanes, kBandBytes, bar);
  }
  __syncthreads();  // the mbarrier is initialised
  mbar_wait(smem_addr(&full), 0);
  const int l = threadIdx.x % kLanes, k = threadIdx.x / kLanes;
  const int src = (l + kLanes - 1) % kLanes;  // the lane roll by one
  uint32_t v[kPer];
  uint32_t sum = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int lr = k * kPer + i;  // the row in the band; rows[lr] is row lr - 8
    const uint32_t a = rows[(lr + kShift) * kLanes + src], p = rows[lr * kLanes + src];
    sum += (((b * kBand + lr) / kShift) & 1) ? max(a, p) : min(a, p);
    v[i] = sum;
  }
  chunk_total[k][l] = sum;
  __syncthreads();
  uint32_t prefix = 0, band = 0;
#pragma unroll
  for (int j = 0; j < kCeChunks; ++j) {
    const uint32_t t = chunk_total[j][l];
    prefix += j < k ? t : 0u;
    band += t;
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");  // every block runs
  for (int d = b + 1 + k; d < C; d += kCeChunks)
    *cluster.map_shared_rank(&carry_in[b][l], d) = band;
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  for (int j = 0; j < b; ++j) prefix += carry_in[j][l];
  uint32_t* o = out + tile * kTile + (long long)b * kBand * kLanes;
#pragma unroll
  for (int i = 0; i < kPer; ++i) o[(k * kPer + i) * kLanes + l] = v[i] + prefix;
}

// ---- P3: a ring a thread (s = 1) ----------------------------------------------
__global__ void __launch_bounds__(256)
blocksort_stages_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                        int n_stages) {
  const int l = threadIdx.x & 31, c = threadIdx.x >> 5;
  const long long at = (long long)(blockIdx.x >> 2) * kTile + (blockIdx.x & 3) * 32 + l;
  uint32_t x[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) x[j] = in[at + (c + kResidues * j) * kLanes];
  for (int q = 0; q < n_stages; ++q) {
    const uint32_t last = x[kPerThread - 1];
#pragma unroll
    for (int j = kPerThread - 1; j >= 1; --j)
      x[j] = ((j & 1) ? max(x[j], x[j - 1]) : min(x[j], x[j - 1])) + 1u;
    x[0] = min(x[0], last) + 1u;
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) out[at + (c + kResidues * j) * kLanes] = x[j];
}

// ---- P3: a ring across S lanes --------------------------------------------------
constexpr int kStageThreads = 256;
constexpr int kRingStride = kPerThread + 1;  // a ring's slots in shared memory; + 1: its
                                             // lanes' reads fall on 2 banks at most alike

template <int S>
__global__ void __launch_bounds__(kStageThreads)
blocksort_stages_split_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                              int n_stages) {
  constexpr int kSlots = kPerThread / S;     // a thread's slots of its ring
  constexpr int kRings = kStageThreads / S;  // a block's rings
  constexpr int kW = S == 2 ? 16 : 8;        // a block's lanes
  constexpr int kC = kRings / kW;            // a block's residues
  constexpr int kLaneBlocks = kLanes / kW;
  constexpr int kBlocksPerTile = kLaneBlocks * (kResidues / kC);
  static_assert(S >= 2 && 32 % S == 0 && kSlots % 2 == 0 && kC >= 1 && kResidues % kC == 0,
                "a ring's lanes lie in one warp, and a slot's parity is its register's");
  static_assert(kBlocksPerTile == 4 * S, "4 * S blocks a tile");
  __shared__ uint32_t ring[kRings * kRingStride];
  const long long tile = blockIdx.x / kBlocksPerTile;
  const int part = blockIdx.x % kBlocksPerTile;
  const int l0 = (part % kLaneBlocks) * kW, c0 = (part / kLaneBlocks) * kC;
  const long long base = tile * kTile + c0 * kLanes + l0;  // row c0, lane l0
  // element e: lane l0 + w of row c0 + cc + 8j, w fastest, so that a warp
  // reads runs of kW lanes; it is slot j of ring cc * kW + w
  for (int e = threadIdx.x; e < kRings * kPerThread; e += kStageThreads) {
    const int w = e % kW, cc = (e / kW) % kC, j = e / (kW * kC);
    ring[(cc * kW + w) * kRingStride + j] = in[base + (long long)(cc + kResidues * j) * kLanes + w];
  }
  __syncthreads();
  const int q = threadIdx.x % S;  // which part of ring threadIdx.x / S
  uint32_t* mine = ring + (threadIdx.x / S) * kRingStride + q * kSlots;
  uint32_t x[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) x[i] = mine[i];
  for (int st = 0; st < n_stages; ++st) {
    // the last slot of the ring's previous lane (lane S - 1 for lane 0)
    const uint32_t before = __shfl_sync(kFull, x[kSlots - 1], q + S - 1, S);
#pragma unroll
    for (int i = kSlots - 1; i >= 1; --i)
      x[i] = ((i & 1) ? max(x[i], x[i - 1]) : min(x[i], x[i - 1])) + 1u;
    x[0] = min(x[0], before) + 1u;
  }
#pragma unroll
  for (int i = 0; i < kSlots; ++i) mine[i] = x[i];
  __syncthreads();
  for (int e = threadIdx.x; e < kRings * kPerThread; e += kStageThreads) {
    const int w = e % kW, cc = (e / kW) % kC, j = e / (kW * kC);
    out[base + (long long)(cc + kResidues * j) * kLanes + w] =
        ring[(cc * kW + w) * kRingStride + j];
  }
}

__global__ void launch_floor_kernel() {}

// A launch of `blocks` blocks of `threads` in clusters of `cluster`.
cudaLaunchConfig_t cluster_config(unsigned blocks, unsigned threads, unsigned cluster,
                                  cudaStream_t stream, cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters above 8 blocks are not portable: the kernel has to allow them
// (once a process: the port runs on one device).
template <int C, class Kernel>
cudaError_t allow_cluster(Kernel kernel) {
  static const cudaError_t err =
      C > 8 ? cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)
            : cudaSuccess;
  return err;
}

template <int C, class Kernel, class... Args>
int launch_clusters(Kernel kernel, unsigned blocks, unsigned threads, cudaStream_t stream,
                    Args... args) {
  cudaError_t err = allow_cluster<C>(kernel);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(blocks, threads, C, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();  // read, and cleared for the next launch
  return err != cudaSuccess ? err : last;
}

// Asked once a process (the port runs on one device).
template <int C>
int ce_active(int* active) {
  static int resident = -1;
  if (resident < 0) {
    cudaError_t err = allow_cluster<C>(blocksort_ce_kernel<C>);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(C, kCeThreads, C, 0, &attr);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, blocksort_ce_kernel<C>, &cfg);
    if (err != cudaSuccess) return err;
    resident = n;
  }
  *active = resident;
  return cudaSuccess;
}

template <int S>
int launch_split(const void* in, void* out, long long tiles, int n_stages, cudaStream_t stream) {
  blocksort_stages_split_kernel<S><<<(unsigned)(4 * S * tiles), kStageThreads, 0, stream>>>(
      (const uint32_t*)in, (uint32_t*)out, n_stages);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// in, out: `tiles` contiguous 512 x 128 u32 tiles, 16-byte aligned; out
// must not be in. cluster: 8 or 16 blocks a tile.
int trs_blocksort_ce(const void* in, void* out, long long tiles, int cluster, void* stream) {
  if (tiles <= 0 || tiles > (1 << 26)) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(tiles * cluster);
  if (cluster == 8)
    return launch_clusters<8>(blocksort_ce_kernel<8>, blocks, kCeThreads, (cudaStream_t)stream,
                              (const uint32_t*)in, (uint32_t*)out);
  if (cluster == 16)
    return launch_clusters<16>(blocksort_ce_kernel<16>, blocks, kCeThreads,
                               (cudaStream_t)stream, (const uint32_t*)in, (uint32_t*)out);
  return cudaErrorInvalidValue;
}

// *active = the clusters of P2 in clusters of `cluster` (8 or 16) that the
// current device holds at once (0: it cannot run them).
int trs_blocksort_ce_active(int cluster, int* active) {
  *active = 0;
  const int err = cluster == 8 ? ce_active<8>(active)
                  : cluster == 16 ? ce_active<16>(active)
                                  : (int)cudaErrorInvalidValue;
  cudaGetLastError();  // a refused size leaves no error behind for the next launch
  return err;
}

// in, out: `tiles` contiguous 512 x 128 u32 tiles (out may be in);
// n_stages >= 0. A ring a thread.
int trs_blocksort_stages(const void* in, void* out, long long tiles, int n_stages,
                         void* stream) {
  if (tiles <= 0 || tiles > (1 << 28) || n_stages < 0) return cudaErrorInvalidValue;
  blocksort_stages_kernel<<<(unsigned)(4 * tiles), 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, n_stages);
  return cudaGetLastError();
}

// As trs_blocksort_stages, each ring split across `split` lanes of a warp
// (2, 4, 8, 16 or 32): 4 * split blocks a tile.
int trs_blocksort_stages_split(const void* in, void* out, long long tiles, int n_stages,
                               int split, void* stream) {
  if (tiles <= 0 || tiles > (1 << 22) || n_stages < 0) return cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (split) {
    case 2: return launch_split<2>(in, out, tiles, n_stages, s);
    case 4: return launch_split<4>(in, out, tiles, n_stages, s);
    case 8: return launch_split<8>(in, out, tiles, n_stages, s);
    case 16: return launch_split<16>(in, out, tiles, n_stages, s);
    case 32: return launch_split<32>(in, out, tiles, n_stages, s);
    default: return cudaErrorInvalidValue;
  }
}

// One empty launch: a block of 32 threads (cluster 1), or one cluster of
// `cluster` (8 or 16) such blocks.
int trs_launch_floor(int cluster, void* stream) {
  if (cluster == 1) {
    launch_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
    return cudaGetLastError();
  }
  if (cluster == 8) return launch_clusters<8>(launch_floor_kernel, 8, 32, (cudaStream_t)stream);
  if (cluster == 16)
    return launch_clusters<16>(launch_floor_kernel, 16, 32, (cudaStream_t)stream);
  return cudaErrorInvalidValue;
}

const char* trs_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
