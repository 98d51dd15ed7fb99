// Compare-exchange stage probe P1 (Hopper): the cost of one stage per
// column count and per formulation.
//
// Replaces benchmarks/explore_ce.py:200 `run_variant` (kernel body `_kernel`
// :56). That probe runs 16 compare-exchange stages over 1,024 x 128 tiles of
// 2^24 elements, stage q pairing element e with e ^ (128 * m), m = MS[q] =
// 1 << (q % 9). Its variants compute three functions (with a = the element
// whose index bit is clear, b = its partner, lt the strict order below):
//   kDesc  ('roll', 'flip', 'u64'): a <- lt(b, a) ? a : b,
//          b <- lt(a, b) ? a : b (the larger tuple first);
//   kSwap  ('xorswap', 'flipminmax'): swap a and b iff lt(b, a);
//   kFold  ('minmax', 'fold2minmax', 'fold3minmax'): a <- lt(b, a) ? b : a,
//          b <- lt(a, b) ? b : a.
// lt compares column 0 (signed for kFold, else unsigned; one u64 column for
// 'u64'), then column 1 unsigned when the variant is stable; further
// columns move with the decision. Ties keep these formulas (a payload can
// be duplicated on a key tie, as in the probe).
//
// The stages only pair elements that differ in index bits 7-15, so the
// 2^24 elements are 32,768 problems of 512 elements (rows 0-511 of one
// lane, one half of a tile). A block takes 32 lanes of such a half: 512
// rows x 32 lanes = 16,384 elements per column, index bits 0-4 on the lanes
// of a warp (coalesced loads and stores), 512 threads. Two formulations
// compute the same bytes:
//   smem  every column of the block lives in shared memory; each stage,
//         each thread compare-exchanges 16 pairs there; one barrier a stage.
//   regs  each thread holds 32 rows of its lane in registers, a window of
//         five row bits: row bits 0-4 (window A: m = 1..16 are register
//         compare-exchanges) or row bits 4-8 (window B: m = 16..256). The
//         schedule A (1..16), B (32..256), A (1..16), B (32, 64) changes
//         window three times through shared memory (two barriers each).
// Every instance also runs with 0 stages: the same loads and stores, so the
// probe reads the time of a stage as (t16 - t0) / 16.
//
// Bound on this card: each column read once and written once at 3.35
// TB/s (0.0401 ms a u32 column at 2^24); the compares are a few integer
// operations an element a stage. What the design does about it: loads and
// stores are whole 128-byte rows of a warp; the regs form keeps the data
// in registers between window changes (96 registers of data for 3
// columns, under the 128 that 512 threads allow).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;                  // elements of a row: index bits 0-6
constexpr int kTileElems = 1024 * kLanes;    // the probe's tile
constexpr int kRows = 512;                   // rows of one problem: index bits 7-15
constexpr int kWarp = 32;
constexpr int kBlockElems = kRows * kWarp;   // 16,384 elements a column a block
constexpr int kThreads = 512;
constexpr int kSlots = kBlockElems / kThreads;  // 32 registers a column (regs)
constexpr int kStages = 16;

enum { kDesc = 0, kSwap = 1, kFold = 2 };

// Column c of the block's element (row r, lane l) in device memory.
__device__ __forceinline__ long long element(int r, int l) {
  const int b = blockIdx.x;
  return (long long)(b >> 3) * kTileElems + (long long)((b >> 2) & 1) * kRows * kLanes +
         (b & 3) * kWarp + (long long)r * kLanes + l;
}

template <typename T, bool SIGNED>
__device__ __forceinline__ bool key_lt(T x, T y) {
  if constexpr (SIGNED) return (int32_t)x < (int32_t)y;
  else return x < y;
}

// One compare-exchange of the pair (a, b), a the element whose index bit
// is clear.
template <int KIND, int NCOL, int NKEY, bool SIGNED, typename T>
__device__ __forceinline__ void ce_pair(T (&a)[NCOL], T (&b)[NCOL]) {
  bool b_lt_a = key_lt<T, SIGNED>(b[0], a[0]);
  bool a_lt_b = key_lt<T, SIGNED>(a[0], b[0]);
  if constexpr (NKEY == 2) {
    const bool eq = a[0] == b[0];
    b_lt_a = b_lt_a || (eq && b[1] < a[1]);
    a_lt_b = a_lt_b || (eq && a[1] < b[1]);
  }
#pragma unroll
  for (int c = 0; c < NCOL; ++c) {
    const T x = a[c], y = b[c];
    if constexpr (KIND == kDesc) {
      a[c] = b_lt_a ? x : y;
      b[c] = a_lt_b ? x : y;
    } else if constexpr (KIND == kSwap) {
      a[c] = b_lt_a ? y : x;
      b[c] = b_lt_a ? x : y;
    } else {
      a[c] = b_lt_a ? y : x;
      b[c] = a_lt_b ? y : x;
    }
  }
}

// ---- smem: every stage through shared memory ------------------------------
template <int KIND, int NCOL, int NKEY, bool SIGNED, typename T>
__global__ void __launch_bounds__(kThreads, 1)
ce_smem_kernel(const T* __restrict__ in, T* __restrict__ out, long long n, int n_stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);  // [NCOL][kBlockElems], (r, l) at r * 32 + l
  const int tid = threadIdx.x;
#pragma unroll
  for (int c = 0; c < NCOL; ++c)
#pragma unroll 8
    for (int k = 0; k < kSlots; ++k) {
      const int e = k * kThreads + tid;
      s[c * kBlockElems + e] = in[c * n + element(e >> 5, e & 31)];
    }
  __syncthreads();
  for (int q = 0; q < n_stages; ++q) {
    const int m = 1 << (q % 9);
#pragma unroll 4
    for (int k = 0; k < kSlots / 2; ++k) {
      const int p = k * kThreads + tid;  // pair: lane p & 31, pair row p >> 5
      const int pr = p >> 5;
      const int ra = ((pr & ~(m - 1)) << 1) | (pr & (m - 1));
      const int ea = ra * kWarp + (p & 31), eb = ea + m * kWarp;
      T a[NCOL], b[NCOL];
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        a[c] = s[c * kBlockElems + ea];
        b[c] = s[c * kBlockElems + eb];
      }
      ce_pair<KIND, NCOL, NKEY, SIGNED>(a, b);
#pragma unroll
      for (int c = 0; c < NCOL; ++c) {
        s[c * kBlockElems + ea] = a[c];
        s[c * kBlockElems + eb] = b[c];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < NCOL; ++c)
#pragma unroll 8
    for (int k = 0; k < kSlots; ++k) {
      const int e = k * kThreads + tid;
      out[c * n + element(e >> 5, e & 31)] = s[c * kBlockElems + e];
    }
}

// ---- regs: register windows of five row bits ------------------------------
// Window A: slot i of warp w holds row w * 32 + i (row bits 0-4 in the
// slot). Window B: row i * 16 + w (row bits 4-8 in the slot). Each window's
// rows are a base of the thread plus i times a constant stride, so every
// access is a register base and an immediate offset.
constexpr int kStrideA = 1, kStrideB = 16;

template <bool WINDOW_A>
__device__ __forceinline__ int first_row(int w) {
  return WINDOW_A ? w * kWarp : w;
}

// Compare-exchange at slot bit `bit` (a power of two below 32).
template <int KIND, int NCOL, int NKEY, bool SIGNED, typename T>
__device__ __forceinline__ void ce_slots(T (&v)[NCOL][kSlots], int bit) {
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (i & bit) continue;
    T a[NCOL], b[NCOL];
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      a[c] = v[c][i];
      b[c] = v[c][i | bit];
    }
    ce_pair<KIND, NCOL, NKEY, SIGNED>(a, b);
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      v[c][i] = a[c];
      v[c][i | bit] = b[c];
    }
  }
}

// Move the registers from one window to the other through shared memory.
template <bool FROM_A, int NCOL, typename T>
__device__ __forceinline__ void change_window(T (&v)[NCOL][kSlots], T* s) {
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
  constexpr int from_stride = (FROM_A ? kStrideA : kStrideB) * kWarp;
  constexpr int to_stride = (FROM_A ? kStrideB : kStrideA) * kWarp;
  T* from = s + first_row<FROM_A>(w) * kWarp + l;
  T* to = s + first_row<!FROM_A>(w) * kWarp + l;
#pragma unroll
  for (int c = 0; c < NCOL; ++c)
#pragma unroll
    for (int i = 0; i < kSlots; ++i) from[c * kBlockElems + i * from_stride] = v[c][i];
  __syncthreads();
#pragma unroll
  for (int c = 0; c < NCOL; ++c)
#pragma unroll
    for (int i = 0; i < kSlots; ++i) v[c][i] = to[c * kBlockElems + i * to_stride];
  __syncthreads();
}

template <bool WINDOW_A, int NCOL, typename T>
__device__ __forceinline__ void store_window(const T (&v)[NCOL][kSlots], T* out, long long n) {
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
  constexpr int stride = (WINDOW_A ? kStrideA : kStrideB) * kLanes;
#pragma unroll
  for (int c = 0; c < NCOL; ++c) {
    T* dst = out + c * n + element(first_row<WINDOW_A>(w), l);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) dst[i * stride] = v[c][i];
  }
}

template <int KIND, int NCOL, int NKEY, bool SIGNED, typename T>
__global__ void __launch_bounds__(kThreads, 1)
ce_regs_kernel(const T* __restrict__ in, T* __restrict__ out, long long n, int n_stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int l = threadIdx.x & 31, w = threadIdx.x >> 5;
  T v[NCOL][kSlots];
#pragma unroll
  for (int c = 0; c < NCOL; ++c) {
    const T* src = in + c * n + element(first_row<true>(w), l);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) v[c][i] = src[i * kStrideA * kLanes];
  }
  if (!n_stages) {
    store_window<true>(v, out, n);
    return;
  }
  // MS = 1, 2, 4, 8, 16 | 32, 64, 128, 256 | 1, 2, 4, 8, 16 | 32, 64
#pragma unroll
  for (int bit = 1; bit <= 16; bit <<= 1) ce_slots<KIND, NCOL, NKEY, SIGNED>(v, bit);
  change_window<true>(v, s);
#pragma unroll
  for (int bit = 2; bit <= 16; bit <<= 1) ce_slots<KIND, NCOL, NKEY, SIGNED>(v, bit);
  change_window<false>(v, s);
#pragma unroll
  for (int bit = 1; bit <= 16; bit <<= 1) ce_slots<KIND, NCOL, NKEY, SIGNED>(v, bit);
  change_window<true>(v, s);
  ce_slots<KIND, NCOL, NKEY, SIGNED>(v, 2);
  ce_slots<KIND, NCOL, NKEY, SIGNED>(v, 4);
  store_window<false>(v, out, n);
}

template <int KIND, int NCOL, int NKEY, bool SIGNED, typename T>
int launch(const void* in, void* out, long long n, int formulation, int n_stages,
           cudaStream_t stream) {
  const int smem = NCOL * kBlockElems * (int)sizeof(T);
  const unsigned blocks = (unsigned)(n / kBlockElems);
  auto kernel = formulation == 0 ? ce_smem_kernel<KIND, NCOL, NKEY, SIGNED, T>
                                 : ce_regs_kernel<KIND, NCOL, NKEY, SIGNED, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, stream>>>((const T*)in, (T*)out, n, n_stages);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// in, out: the columns, (columns, n) contiguous (u32; one u64 column for
// function 9), n a multiple of 131,072; out may be in. fn: the function id
// of FUNCTIONS in tpu_radix_sort_torch/benchmarks/explore_ce.py (0-9). formulation: 0
// smem, 1 regs. n_stages: 0 or 16.
int trs_explore_ce(const void* in, void* out, long long n, int fn, int formulation,
                   int n_stages, void* stream) {
  if (n <= 0 || n % kTileElems || (n_stages != 0 && n_stages != kStages) ||
      (formulation != 0 && formulation != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (fn) {
    case 0: return launch<kDesc, 1, 1, false, uint32_t>(in, out, n, formulation, n_stages, s);
    case 1: return launch<kDesc, 2, 2, false, uint32_t>(in, out, n, formulation, n_stages, s);
    case 2: return launch<kDesc, 3, 2, false, uint32_t>(in, out, n, formulation, n_stages, s);
    case 3: return launch<kFold, 1, 1, true, uint32_t>(in, out, n, formulation, n_stages, s);
    case 4: return launch<kFold, 2, 2, true, uint32_t>(in, out, n, formulation, n_stages, s);
    case 5: return launch<kFold, 3, 2, true, uint32_t>(in, out, n, formulation, n_stages, s);
    case 6: return launch<kSwap, 1, 1, false, uint32_t>(in, out, n, formulation, n_stages, s);
    case 7: return launch<kSwap, 2, 2, false, uint32_t>(in, out, n, formulation, n_stages, s);
    case 8: return launch<kSwap, 3, 2, false, uint32_t>(in, out, n, formulation, n_stages, s);
    case 9: return launch<kDesc, 1, 1, false, uint64_t>(in, out, n, formulation, n_stages, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* trs_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
