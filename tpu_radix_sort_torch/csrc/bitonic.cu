// Bitonic compare-exchange network over co-sorted u32 columns (Hopper).
//
// Replaces the TPU kernel `_stages_kernel` of tpu_radix_sort/ops/bitonic.py
// (launched by `_run_network`). It computes the same function: apply an
// ordered list of bitonic stages (k, j) to `n_arr` u32 columns laid out as
// one (n_arr, n) row-major array. Element i pairs with i ^ j; the pair is
// put in ascending order iff (global i & k) == 0. Order is lexicographic,
// unsigned, over the leading `n_keys` columns; the other columns move along.
// A pair is swapped iff it is strictly out of order in its direction, which
// is right for distinct tuples and keeps equal tuples where they are. The
// batched sorts' row-local network (ops/bitonic.py row_schedule) ends with a
// round whose k = 2^31 lies above every index: all of its pairs go up.
//
// Two kernels, no rolls, transposes or min/max folds:
//   bitonic_tile_kernel          a stage list with every j < T, on each tile
//                                of T elements; serves phase 1 (rounds
//                                k = 2..T) and the merge tail of each round
//                                k >= 2T.
//   bitonic_global_stage_kernel  one thread per pair for one stride j >= T,
//                                straight in device memory (the TPU's fused
//                                cross-stage pass).
//
// The tile kernel keeps its elements in registers: kE = 32 slots a thread,
// a block a chunk of S = 2^L = max(T, 1024) elements (whole tiles: no pair
// crosses a tile, so a chunk of several small tiles runs the same stages)
// in S / 32 threads; the wrapper pads an array shorter than one chunk. Each
// thread holds its elements' key words and, when the call has payload
// columns, their positions in the chunk (the payloads stay in device memory
// and are gathered once at the end). A layout, or window
// s, puts index bits s..s+4 in the register slots r:
//   s = 0           i = w << 10 | lane << 5 | r
//   5 <= s <= L-5   i = (w >> (s-5)) << (s+5) | r << s | (w mod 2^(s-5)) << 5 | lane
// (lane 0..31, warp w). Every stride bit lies in some window, so every
// stage is a compare-exchange between two registers of one thread: no
// shuffle, no shared memory, no barrier. Between stages of different
// windows the block writes its words to shared memory and reads them back
// in the other window: one barrier pair per layout change. One spare word
// after every 32 makes a warp's accesses in any window fall in 32 distinct
// banks, and slot r sits at a fixed stride from slot 0. The caller plans the
// window of each stage (ops/bitonic.py `tile_plan`, fewest changes); a chunk
// is loaded and stored in a window s >= 5, where a warp's accesses to one
// slot are 128 consecutive bytes.
//
// Bound on this card: every launch reads and writes every column once,
// n_arr * 4 * n bytes each way, at 3.35 TB/s; the stage work is compares and
// selects on registers and the exchanges through shared memory. At n = 2^26
// key+rank with T = 16384 a sort makes 13 tile launches and 78 global
// launches.
//
// The output does not depend on T: the tie-break contract of sort_padded
// (real (key, tie) tuples distinct, identical sentinel pads) makes the
// sorted order unique, and the stage list is the same network for any T.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxStages = 128;
constexpr int kE = 32;                // register slots a thread, per word
constexpr unsigned kChunkMin = 1024;  // 32 lanes x kE: one warp's elements

// A stage: its window s (bits 3-6) and register bit, b - s (bits 0-2).
struct StageList {
  int count;
  unsigned first;  // the window the chunk is loaded in
  unsigned k[kMaxStages];
  unsigned char op[kMaxStages];
};

// Lexicographic unsigned a < b over the first N_KEYS words (1..4).
// (Words 0-1 and 2-3 as 64-bit compares.)
template <int N_KEYS>
__device__ __forceinline__ bool lex_lt(const unsigned* a, const unsigned* b) {
  if (N_KEYS == 1) return a[0] < b[0];
  const unsigned long long A = (unsigned long long)a[0] << 32 | a[1];
  const unsigned long long B = (unsigned long long)b[0] << 32 | b[1];
  if (N_KEYS == 2) return A < B;
  if (N_KEYS == 3) return A < B || (A == B && a[2] < b[2]);
  const unsigned long long C = (unsigned long long)a[2] << 32 | a[3];
  const unsigned long long D = (unsigned long long)b[2] << 32 | b[3];
  return A < B || (A == B && C < D);
}

// Per (N_ARR, N_KEYS): whether the elements' positions ride in registers
// (when there are payload columns; two 16-bit positions a register, slots r
// and r + 16), the threads of a block at the largest tile whose n_arr
// columns fit 227 KB of shared memory (ops/bitonic.py resolve_tile), and
// the compare form (the flip form keeps 3 key words at 512 threads within
// 128 registers).
template <int N_ARR, int N_KEYS>
struct Tile {
  static constexpr bool kIdx = N_ARR > N_KEYS;
  static constexpr int kMaxThreads = (N_ARR == 1 ? 32768 : N_ARR <= 3 ? 16384 : 8192) / kE;
  static constexpr bool kFlip = N_KEYS == 3 && kMaxThreads == 512;
};

// Position of slot r in the packed positions: slots r and r + 16 share ip[r % 16].
template <int R>
__device__ __forceinline__ unsigned position(const unsigned (&ip)[kE / 2]) {
  return R < kE / 2 ? ip[R] & 0xffffu : ip[R - kE / 2] >> 16;
}

// Index bits of a thread's slot 0 in window s.
__device__ __forceinline__ unsigned thread_bits(unsigned s, unsigned lane, unsigned warp) {
  if (s == 0) return warp << 10 | lane << 5;
  return (warp >> (s - 5)) << (s + 5) | (warp & ((1u << (s - 5)) - 1)) << 5 | lane;
}

// Shared-memory position of element i: one spare word after every 32.
__host__ __device__ __forceinline__ unsigned pad(unsigned i) { return i + (i >> 5); }

// pad(thread_bits | r << s) = pad(thread_bits) + r * pad_stride(s).
__device__ __forceinline__ unsigned pad_stride(unsigned s) {
  return s == 0 ? 1u : (1u << s) + (1u << (s - 5));
}

// Payload gather: slot r's element takes the word staged at its position.
template <int R = 0>
__device__ __forceinline__ void gather(unsigned* col, unsigned tb, unsigned step,
                                       const unsigned* staged, const unsigned (&ip)[kE / 2]) {
  col[tb + R * step] = staged[position<R>(ip)];
  if constexpr (R + 1 < kE) gather<R + 1>(col, tb, step, staged, ip);
}

// Stage on register bit RB: slots r and r | 1 << RB. The pair goes up iff
// ((bt | r << s) & k) == 0, with bt the thread's index bits and kr = k >> s,
// so that r stays an immediate. FLIP: one compare of the words XORed with
// ~0 when the pair goes down (which reverses unsigned order) instead of two
// compares and a select; slower, but it holds fewer values live, which
// three words a slot at 512 threads need to stay within 128 registers.
template <int N_KEYS, int RB, bool FLIP, bool IDX>
__device__ __forceinline__ void reg_stage(unsigned (&v)[N_KEYS][kE], unsigned (&ip)[kE / 2],
                                          unsigned btk, unsigned kr) {
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    if (r & (1 << RB)) continue;
    const int q = r | (1 << RB);
    const bool up = (btk | ((unsigned)r & kr)) == 0;
    const unsigned m = FLIP && !up ? ~0u : 0u;
    unsigned a[N_KEYS], b[N_KEYS];
#pragma unroll
    for (int c = 0; c < N_KEYS; ++c) {
      a[c] = v[c][r] ^ m;
      b[c] = v[c][q] ^ m;
    }
    const bool sw = FLIP || up ? lex_lt<N_KEYS>(b, a) : lex_lt<N_KEYS>(a, b);
#pragma unroll
    for (int c = 0; c < N_KEYS; ++c) {
      const unsigned lo = v[c][r], hi = v[c][q];
      v[c][r] = sw ? hi : lo;
      v[c][q] = sw ? lo : hi;
    }
    if (IDX) {
      if (RB == 4) {  // r and r + 16: the two halves of ip[r]
        ip[r] = sw ? __byte_perm(ip[r], 0, 0x1032) : ip[r];
      } else {  // the same half of ip[r % 16] and ip[q % 16]
        const unsigned half = r & 16 ? 0xffff0000u : 0x0000ffffu;
        const unsigned d = (ip[r & 15] ^ ip[q & 15]) & half & (0u - (unsigned)sw);
        ip[r & 15] ^= d;
        ip[q & 15] ^= d;
      }
    }
  }
}

// Window change through shared memory: the key words as u32 columns of
// sp = pad(S) words, the positions as u16 after them. from/to: each
// window's slot-0 position and slot stride.
template <int N_KEYS, bool IDX>
__device__ __forceinline__ void exchange(unsigned (&v)[N_KEYS][kE], unsigned (&ip)[kE / 2],
                                         unsigned* sm, unsigned sp, unsigned p0, unsigned d0,
                                         unsigned p1, unsigned d1) {
  unsigned short* si = reinterpret_cast<unsigned short*>(sm + N_KEYS * sp);
#pragma unroll
  for (int r = 0; r < kE; ++r, p0 += d0) {
#pragma unroll
    for (int c = 0; c < N_KEYS; ++c) sm[c * sp + p0] = v[c][r];
    if (IDX) si[p0] = (unsigned short)(r < kE / 2 ? ip[r % 16] : ip[r % 16] >> 16);
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kE; ++r, p1 += d1) {
#pragma unroll
    for (int c = 0; c < N_KEYS; ++c) v[c][r] = sm[c * sp + p1];
    if (IDX) {
      if (r < kE / 2) ip[r] = si[p1];
      else ip[r - kE / 2] |= (unsigned)si[p1] << 16;
    }
  }
  __syncthreads();
}

template <int N_ARR, int N_KEYS>
__global__ void __launch_bounds__(Tile<N_ARR, N_KEYS>::kMaxThreads)
bitonic_tile_kernel(unsigned* __restrict__ x, unsigned n, unsigned S, unsigned last,
                    const __grid_constant__ StageList st) {
  using T = Tile<N_ARR, N_KEYS>;
  extern __shared__ unsigned smem[];
  const unsigned lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned base = blockIdx.x * S, sp = pad(S);
  unsigned cur = st.first;
  unsigned tb = thread_bits(cur, lane, warp), step = 1u << cur;
  unsigned v[N_KEYS][kE], ip[kE / 2];
#pragma unroll
  for (int c = 0; c < N_KEYS; ++c) {
    const unsigned* q = x + (size_t)c * n + base + tb;
#pragma unroll
    for (int r = 0; r < kE; ++r, q += step) v[c][r] = *q;
  }
  if (T::kIdx) {
#pragma unroll
    for (int h = 0; h < kE / 2; ++h) ip[h] = (tb + h * step) | (tb + (h + kE / 2) * step) << 16;
  }
  for (int s = 0; s <= st.count; ++s) {
    // after the last stage: back to the window `last` to store
    const unsigned op = s < st.count ? st.op[s] : last << 3;
    const unsigned win = op >> 3;
    if (win != cur) {
      exchange<N_KEYS, T::kIdx>(v, ip, smem, sp, pad(thread_bits(cur, lane, warp)),
                                pad_stride(cur), pad(thread_bits(win, lane, warp)),
                                pad_stride(win));
      cur = win;
    }
    if (s == st.count) break;
    const unsigned k = st.k[s];
    const unsigned btk = (base | thread_bits(cur, lane, warp)) & k, kr = k >> cur;
    switch (op & 7) {
      case 0: reg_stage<N_KEYS, 0, T::kFlip, T::kIdx>(v, ip, btk, kr); break;
      case 1: reg_stage<N_KEYS, 1, T::kFlip, T::kIdx>(v, ip, btk, kr); break;
      case 2: reg_stage<N_KEYS, 2, T::kFlip, T::kIdx>(v, ip, btk, kr); break;
      case 3: reg_stage<N_KEYS, 3, T::kFlip, T::kIdx>(v, ip, btk, kr); break;
      default: reg_stage<N_KEYS, 4, T::kFlip, T::kIdx>(v, ip, btk, kr); break;
    }
  }
  tb = thread_bits(cur, lane, warp);
  step = 1u << cur;
#pragma unroll
  for (int c = 0; c < N_KEYS; ++c) {
    unsigned* q = x + (size_t)c * n + base + tb;
#pragma unroll
    for (int r = 0; r < kE; ++r, q += step) *q = v[c][r];
  }
  // payload columns: stage the chunk in shared memory, gather by position
  for (int c = N_KEYS; c < N_ARR; ++c) {
    unsigned* col = x + (size_t)c * n + base;
    for (unsigned i = threadIdx.x; i < S; i += blockDim.x) smem[i] = col[i];
    __syncthreads();
    gather(col, tb, step, smem, ip);
    __syncthreads();
  }
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
__global__ void bitonic_global_stage_kernel(unsigned* __restrict__ x, unsigned n,
                                            unsigned k, unsigned j) {
  const unsigned p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (n >> 1)) return;
  const unsigned i = pair_low(p, j);
  compare_exchange<N_ARR, N_KEYS>(x, n, i, i + j, (i & k) == 0);
}

// Windows: 0, or 5 <= s <= L - 5 for a chunk of 2^L elements; windows[s]
// must hold the bit of js[s]. Encodes the stages and launches.
template <int N_ARR, int N_KEYS>
cudaError_t launch_tile(unsigned* x, unsigned n, unsigned tile, const unsigned* ks,
                        const unsigned* js, const unsigned* windows, int n_stages,
                        cudaStream_t stream) {
  using T = Tile<N_ARR, N_KEYS>;
  const unsigned chunk = tile < kChunkMin ? kChunkMin : tile;
  const unsigned threads = chunk / kE;
  if (threads > (unsigned)T::kMaxThreads || n % chunk != 0) return cudaErrorInvalidValue;
  unsigned bits = 0;
  while ((1u << bits) < chunk) ++bits;
  StageList st;
  st.count = n_stages;
  for (int s = 0; s < n_stages; ++s) {
    unsigned b = 0;
    while ((1u << b) < js[s]) ++b;
    const unsigned w = windows[s];
    if (js[s] != 1u << b || js[s] >= tile || (w != 0 && (w < 5 || w > bits - 5)) || b < w ||
        b > w + 4)
      return cudaErrorInvalidValue;
    st.k[s] = ks[s];
    st.op[s] = (unsigned char)(w << 3 | (b - w));
  }
  // load and store in a window s >= 5, where a warp's accesses to one slot
  // are 128 consecutive bytes
  const unsigned top = bits - 5;
  st.first = n_stages && windows[0] >= 5 ? windows[0] : top;
  const unsigned last = n_stages && windows[n_stages - 1] >= 5 ? windows[n_stages - 1] : top;
  // key words and u16 positions at the padded size (one word in 33 spare)
  const size_t smem = (size_t)pad(chunk) * (N_KEYS * sizeof(unsigned) + (T::kIdx ? 2 : 0));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bitonic_tile_kernel<N_ARR, N_KEYS>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  bitonic_tile_kernel<N_ARR, N_KEYS><<<n / chunk, threads, smem, stream>>>(x, n, chunk, last,
                                                                           st);
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

// Dispatch over (N_ARR, N_KEYS): N_ARR in 1..8, N_KEYS in 1..min(4, N_ARR).
// Eight columns are the widest 64-bit segmented path: (segment, hi, lo, tie,
// the full key's hi and lo, an 8-byte value's hi and lo).
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
    case 44: return FN<4, 4>(__VA_ARGS__);                                     \
    case 51: return FN<5, 1>(__VA_ARGS__);                                     \
    case 52: return FN<5, 2>(__VA_ARGS__);                                     \
    case 53: return FN<5, 3>(__VA_ARGS__);                                     \
    case 54: return FN<5, 4>(__VA_ARGS__);                                     \
    case 61: return FN<6, 1>(__VA_ARGS__);                                     \
    case 62: return FN<6, 2>(__VA_ARGS__);                                     \
    case 63: return FN<6, 3>(__VA_ARGS__);                                     \
    case 64: return FN<6, 4>(__VA_ARGS__);                                     \
    case 71: return FN<7, 1>(__VA_ARGS__);                                     \
    case 72: return FN<7, 2>(__VA_ARGS__);                                     \
    case 73: return FN<7, 3>(__VA_ARGS__);                                     \
    case 74: return FN<7, 4>(__VA_ARGS__);                                     \
    case 81: return FN<8, 1>(__VA_ARGS__);                                     \
    case 82: return FN<8, 2>(__VA_ARGS__);                                     \
    case 83: return FN<8, 3>(__VA_ARGS__);                                     \
    case 84: return FN<8, 4>(__VA_ARGS__);                                     \
    default: return cudaErrorInvalidValue;                                     \
  }

}  // namespace

extern "C" {

// x: (n_arr, n) u32, n <= 2^31 a multiple of the chunk, max(tile, 1024)
// elements. Stage s is (ks[s], js[s]) with js[s] < tile, run in window
// windows[s] (planned by ops/bitonic.py tile_plan); at most 128 stages.
int trs_bitonic_tile(void* x, long long n, int n_arr, int n_keys, long long tile,
                     const unsigned* ks, const unsigned* js, const unsigned* windows,
                     int n_stages, void* stream) {
  if (n_stages < 0 || n_stages > kMaxStages || tile < 2 || tile > 32768 || n % tile != 0)
    return cudaErrorInvalidValue;
  TRS_DISPATCH(launch_tile, (unsigned*)x, (unsigned)n, (unsigned)tile, ks, js, windows,
               n_stages, (cudaStream_t)stream)
}

// One stage (k, j) over the whole (n_arr, n) array; n a multiple of 2j.
int trs_bitonic_global_stage(void* x, long long n, int n_arr, int n_keys,
                             long long k, long long j, void* stream) {
  if (j < 1 || n % (2 * j) != 0) return cudaErrorInvalidValue;
  TRS_DISPATCH(launch_global, (unsigned*)x, (unsigned)n, (unsigned)k, (unsigned)j,
               (cudaStream_t)stream)
}

const char* trs_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
