// Probes P2 and P3 (Hopper): one 512 x 128 u32 tile, and many of them.
//
// blocksort_ce_kernel replaces benchmarks/explore_blocksort.py:60, the
// primitive check (kernel body `ce_kernel` :42): y[r] = x[(r - 8) mod 512];
// z = min(x, y) where (r / 8) is even, else max (unsigned); the lane roll
// z[:, l] <- z[:, (l - 1) mod 128]; then the inclusive sum down the rows,
// mod 2^32. One block of 128 threads a tile, one lane a thread: the sum
// runs down the rows in a register. It is a check, not a rate: one tile of
// 256 KB in and out is a launch's worth of work.
//
// blocksort_stages_kernel replaces benchmarks/explore_blocksort.py:88, the
// stage-rate probe (kernel body `stages_kernel` :74): 64 times,
// x <- (min(x, y) where (r / 8) is even, else max(x, y)) + 1 mod 2^32, with
// y[r] = x[(r - 8) mod 512]. Row r needs only row r - 8, so a thread holds
// the 64 rows r = c + 8j (j = 0..63) of one lane and one residue c of r
// mod 8 in registers: row r - 8 is its own slot j - 1 (slot 63 for j = 0),
// and the tile stays resident in registers for all the stages with no
// exchange at all. A block takes 32 lanes (the lanes of a warp: coalesced
// loads) and the 8 residues, 256 threads; four blocks a tile.
//
// Bound on this card: the tiles read once and written once at 3.35 TB/s
// (0.0401 ms for 256 tiles); the work is two integer operations an
// element a stage (min or max, add), 2^31 at 256 tiles, which the design
// keeps in registers, so the kernel measures the card's bare integer
// stage rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 512, kLanes = 128, kTile = kRows * kLanes;
constexpr int kResidues = 8;                // the row stride of the probe's roll
constexpr int kPerThread = kRows / kResidues;  // 64 rows a thread

__global__ void __launch_bounds__(kLanes)
blocksort_ce_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out) {
  const uint32_t* x = in + (long long)blockIdx.x * kTile;
  uint32_t* o = out + (long long)blockIdx.x * kTile;
  const int l = threadIdx.x;
  const int src = (l + kLanes - 1) & (kLanes - 1);  // the lane roll by one
  uint32_t sum = 0;
  for (int r = 0; r < kRows; ++r) {
    const uint32_t a = x[r * kLanes + src], b = x[((r - 8) & (kRows - 1)) * kLanes + src];
    sum += ((r >> 3) & 1) ? max(a, b) : min(a, b);
    o[r * kLanes + l] = sum;
  }
}

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

}  // namespace

extern "C" {

// in, out: `tiles` contiguous 512 x 128 u32 tiles; out must not be in.
int trs_blocksort_ce(const void* in, void* out, long long tiles, void* stream) {
  if (tiles <= 0 || tiles > (1 << 30)) return cudaErrorInvalidValue;
  blocksort_ce_kernel<<<(unsigned)tiles, kLanes, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out);
  return cudaGetLastError();
}

// in, out: `tiles` contiguous 512 x 128 u32 tiles (out may be in);
// n_stages >= 0.
int trs_blocksort_stages(const void* in, void* out, long long tiles, int n_stages,
                         void* stream) {
  if (tiles <= 0 || tiles > (1 << 28) || n_stages < 0) return cudaErrorInvalidValue;
  blocksort_stages_kernel<<<(unsigned)(4 * tiles), 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, n_stages);
  return cudaGetLastError();
}

const char* trs_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
