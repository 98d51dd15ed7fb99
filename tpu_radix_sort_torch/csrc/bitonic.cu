// Bitonic compare-exchange network over co-sorted u32 columns (Hopper).
//
// Replaces the TPU kernel `_stages_kernel` of tpu_radix_sort/ops/bitonic.py
// (launched by `_run_network`). It computes the same function: apply an
// ordered list of bitonic stages (k, j) to `n_arr` u32 columns laid out as
// one (n_arr, n) row-major array. Element i pairs with i ^ j; the pair is
// put in ascending order iff (global i & k) == 0. Order is lexicographic,
// unsigned, over the leading `n_keys` columns; the other columns move along.
// A pair is swapped iff it is strictly out of order in its direction, which
// is right for distinct tuples and keeps equal tuples where they are.
//
// Two kernels, no rolls, transposes or min/max folds:
//   bitonic_tile_kernel          one block per tile of T elements held in
//                                dynamic shared memory; runs a stage list
//                                with j < T, one __syncthreads() per stage.
//                                Serves phase 1 (rounds k = 2..T) and the
//                                merge tail of each round k >= 2T.
//   bitonic_global_stage_kernel  one thread per pair for one stride j >= T,
//                                straight in device memory (the TPU's fused
//                                cross-stage pass).
//
// Bound on this card: every launch reads and writes every column once,
// n_arr * 4 * n bytes each way, so a sort costs (1 + log2(n/T) merge tails
// + sum of global strides) passes at 3.35 TB/s. At n = 2^26 key+rank with
// T = 16384 that is 13 tile launches and 78 global launches. Fusing strides
// into fewer passes is later work.
//
// The output does not depend on T: the tie-break contract of sort_padded
// (real (key, tie) tuples distinct, identical sentinel pads) makes the
// sorted order unique, and the stage list is the same network for any T.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStages = 128;

struct StageList {
  int count;
  unsigned k[kMaxStages];
  unsigned j[kMaxStages];
};

// Lexicographic unsigned a < b over the first N_KEYS words.
template <int N_KEYS>
__device__ __forceinline__ bool lex_lt(const unsigned* a, const unsigned* b) {
  bool lt = a[N_KEYS - 1] < b[N_KEYS - 1];
#pragma unroll
  for (int c = N_KEYS - 2; c >= 0; --c) lt = (a[c] < b[c]) || (a[c] == b[c] && lt);
  return lt;
}

// Compare-exchange of elements i < q of columns spaced `stride` apart.
template <int N_ARR, int N_KEYS>
__device__ __forceinline__ void compare_exchange(unsigned* x, size_t stride,
                                                 unsigned i, unsigned q, bool up) {
  unsigned a[N_KEYS], b[N_KEYS];
#pragma unroll
  for (int c = 0; c < N_KEYS; ++c) {
    a[c] = x[c * stride + i];
    b[c] = x[c * stride + q];
  }
  const bool swap = up ? lex_lt<N_KEYS>(b, a) : lex_lt<N_KEYS>(a, b);
  if (!swap) return;
#pragma unroll
  for (int c = 0; c < N_KEYS; ++c) {
    x[c * stride + i] = b[c];
    x[c * stride + q] = a[c];
  }
#pragma unroll
  for (int c = N_KEYS; c < N_ARR; ++c) {
    const unsigned t = x[c * stride + i];
    x[c * stride + i] = x[c * stride + q];
    x[c * stride + q] = t;
  }
}

// Pair p of a stage with stride j: the element with bit j clear.
__device__ __forceinline__ unsigned pair_low(unsigned p, unsigned j) {
  return ((p & ~(j - 1)) << 1) | (p & (j - 1));
}

template <int N_ARR, int N_KEYS>
__global__ void bitonic_tile_kernel(unsigned* __restrict__ x, unsigned n, unsigned tile,
                                    const __grid_constant__ StageList st) {
  extern __shared__ unsigned smem[];
  const unsigned base = blockIdx.x * tile;
#pragma unroll
  for (int c = 0; c < N_ARR; ++c)
    for (unsigned t = threadIdx.x; t < tile; t += blockDim.x)
      smem[c * tile + t] = x[(size_t)c * n + base + t];
  __syncthreads();
  const unsigned half = tile >> 1;
  for (int s = 0; s < st.count; ++s) {
    const unsigned k = st.k[s], j = st.j[s];
    for (unsigned p = threadIdx.x; p < half; p += blockDim.x) {
      const unsigned i = pair_low(p, j);
      compare_exchange<N_ARR, N_KEYS>(smem, tile, i, i + j, ((base + i) & k) == 0);
    }
    __syncthreads();
  }
#pragma unroll
  for (int c = 0; c < N_ARR; ++c)
    for (unsigned t = threadIdx.x; t < tile; t += blockDim.x)
      x[(size_t)c * n + base + t] = smem[c * tile + t];
}

template <int N_ARR, int N_KEYS>
__global__ void bitonic_global_stage_kernel(unsigned* __restrict__ x, unsigned n,
                                            unsigned k, unsigned j) {
  const unsigned p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (n >> 1)) return;
  const unsigned i = pair_low(p, j);
  compare_exchange<N_ARR, N_KEYS>(x, n, i, i + j, (i & k) == 0);
}

template <int N_ARR, int N_KEYS>
cudaError_t launch_tile(unsigned* x, unsigned n, unsigned tile, const StageList& st,
                        cudaStream_t stream) {
  const size_t smem = (size_t)N_ARR * tile * sizeof(unsigned);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bitonic_tile_kernel<N_ARR, N_KEYS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned threads = tile / 2 < 1024 ? tile / 2 : 1024;
  bitonic_tile_kernel<N_ARR, N_KEYS><<<n / tile, threads, smem, stream>>>(x, n, tile, st);
  return cudaGetLastError();
}

template <int N_ARR, int N_KEYS>
cudaError_t launch_global(unsigned* x, unsigned n, unsigned k, unsigned j,
                          cudaStream_t stream) {
  const unsigned threads = 256;
  const unsigned blocks = ((n >> 1) + threads - 1) / threads;
  bitonic_global_stage_kernel<N_ARR, N_KEYS><<<blocks, threads, 0, stream>>>(x, n, k, j);
  return cudaGetLastError();
}

// Dispatch over (N_ARR, N_KEYS): N_ARR in 1..5, N_KEYS in 1..min(3, N_ARR).
#define TRS_DISPATCH(FN, ...)                                                   \
  switch (n_arr * 10 + n_keys) {                                               \
    case 11: return FN<1, 1>(__VA_ARGS__);                                     \
    case 21: return FN<2, 1>(__VA_ARGS__);                                     \
    case 22: return FN<2, 2>(__VA_ARGS__);                                     \
    case 31: return FN<3, 1>(__VA_ARGS__);                                     \
    case 32: return FN<3, 2>(__VA_ARGS__);                                     \
    case 33: return FN<3, 3>(__VA_ARGS__);                                     \
    case 41: return FN<4, 1>(__VA_ARGS__);                                     \
    case 42: return FN<4, 2>(__VA_ARGS__);                                     \
    case 43: return FN<4, 3>(__VA_ARGS__);                                     \
    case 51: return FN<5, 1>(__VA_ARGS__);                                     \
    case 52: return FN<5, 2>(__VA_ARGS__);                                     \
    case 53: return FN<5, 3>(__VA_ARGS__);                                     \
    default: return cudaErrorInvalidValue;                                     \
  }

}  // namespace

extern "C" {

// x: (n_arr, n) u32, n a power of two < 2^32 and a multiple of `tile`.
// Stage s is (ks[s], js[s]) with js[s] < tile; at most 128 stages.
int trs_bitonic_tile(void* x, long long n, int n_arr, int n_keys, long long tile,
                     const unsigned* ks, const unsigned* js, int n_stages, void* stream) {
  if (n_stages < 0 || n_stages > kMaxStages || tile < 2 || n % tile != 0)
    return cudaErrorInvalidValue;
  StageList st;
  st.count = n_stages;
  for (int s = 0; s < n_stages; ++s) {
    st.k[s] = ks[s];
    st.j[s] = js[s];
  }
  TRS_DISPATCH(launch_tile, (unsigned*)x, (unsigned)n, (unsigned)tile, st,
               (cudaStream_t)stream)
}

// One stage (k, j) over the whole (n_arr, n) array.
int trs_bitonic_global_stage(void* x, long long n, int n_arr, int n_keys,
                             long long k, long long j, void* stream) {
  if (j < 1 || 2 * j > n) return cudaErrorInvalidValue;
  TRS_DISPATCH(launch_global, (unsigned*)x, (unsigned)n, (unsigned)k, (unsigned)j,
               (cudaStream_t)stream)
}

const char* trs_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
