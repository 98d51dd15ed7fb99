// Lane-width stage-rate probe P9 (Hopper): do 16-bit lanes packed two to a
// register run min/max stages at twice the 32-bit element rate?
//
// Replaces benchmarks/explore_keys16.py:163 `stage_rate` (kernel body
// `_stage_kernel` :144): `reps` times, s = 1 + (r & 3),
// p[:, l] = x[:, (l - s) mod 128] (a roll within each 128-element row),
// x <- min(x, p) at even lanes l, max(x, p) at odd ones; for int32, uint16,
// int16 and bfloat16 rows of 128.
//
// A thread holds one whole row in registers: 128 int32, or 64 words of two
// 16-bit elements (element 2k in the low half of word k). The roll is then a
// choice of register, fixed at compile time, and a stage is pure ALU work:
// one min or max an element for int32; for 16 bits, one packed minimum and
// one packed maximum a word (__vminu2/__vmaxu2 for uint16, __vmins2/
// __vmaxs2 for int16, __hmin2_nan/__hmax2_nan for bfloat16), merged by one
// byte permute, plus one more to realign the partner when s is odd (the
// partner pair then straddles two words). A row is updated in place from
// its last element down, with the words that wrap saved first.
//
// bfloat16 follows what the JAX package computes for these rows on the CPU
// (measured in Pallas interpret mode): subnormals count as zero of their
// sign, -0 < +0, and a NaN operand gives NaN: for the minimum 0x7FC0 if any
// NaN operand is positive, else 0xFFC0; for the maximum 0xFFC0 if any is
// negative, else 0x7FC0. The kernel flushes subnormals and makes each NaN
// 0x7FC0 or 0xFFC0 (by its sign) at the load when reps > 0; a stage then
// takes the card's NaN-propagating minimum and maximum and, in the halves
// where an operand is NaN, the unsigned minimum (maximum) of the NaN
// operands' patterns.
//
// Bound on this card: the rows read once and written once at 3.35 TB/s
// (0.0100 ms for int32, 0.0050 ms for 16 bits, 2^22 elements), or the
// stage operations: one an element a stage, above the bytes bound from
// about 16 stages on. The design keeps every stage in registers, so at
// reps = 256 the time is the ALU's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>

namespace {

constexpr int kLanes = 128;
constexpr int kWords = kLanes / 2;  // 16-bit rows: 64 words
constexpr int kThreads = 128;
enum { kI32 = 0, kU16 = 1, kI16 = 2, kBF16 = 3 };

// ---- int32: one element a register -----------------------------------------
template <int S>
__device__ __forceinline__ void stage32(int (&v)[kLanes]) {
  int tail[S];
#pragma unroll
  for (int t = 0; t < S; ++t) tail[t] = v[kLanes - S + t];
#pragma unroll
  for (int l = kLanes - 1; l >= 0; --l) {
    const int p = l >= S ? v[l >= S ? l - S : 0] : tail[l < S ? l : 0];
    v[l] = (l & 1) ? max(v[l], p) : min(v[l], p);
  }
}

__global__ void __launch_bounds__(kThreads)
stage32_kernel(const int4* __restrict__ in, int4* __restrict__ out, long long rows, int reps) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= rows) return;
  int v[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes / 4; ++k) {
    const int4 q = in[row * (kLanes / 4) + k];
    v[4 * k] = q.x, v[4 * k + 1] = q.y, v[4 * k + 2] = q.z, v[4 * k + 3] = q.w;
  }
  int r = 0;
  for (; r + 4 <= reps; r += 4) {
    stage32<1>(v);
    stage32<2>(v);
    stage32<3>(v);
    stage32<4>(v);
  }
  if (r < reps) stage32<1>(v);
  if (r + 1 < reps) stage32<2>(v);
  if (r + 2 < reps) stage32<3>(v);
#pragma unroll
  for (int k = 0; k < kLanes / 4; ++k)
    out[row * (kLanes / 4) + k] = make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

// ---- 16 bits: two elements a register ---------------------------------------
__device__ __forceinline__ uint32_t nan2(uint32_t x) {  // 0xFFFF in each NaN half
  return __vcmpgtu2(x & 0x7FFF7FFFu, 0x7F807F80u);
}

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t x) {
  __nv_bfloat162 r;
  memcpy(&r, &x, 4);
  return r;
}

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 x) {
  uint32_t r;
  memcpy(&r, &x, 4);
  return r;
}

// The low half (an even lane) takes the minimum, the high half the maximum.
template <int KIND>
__device__ __forceinline__ uint32_t min_max(uint32_t x, uint32_t p) {
  if constexpr (KIND == kU16) return __byte_perm(__vminu2(x, p), __vmaxu2(x, p), 0x7610);
  else if constexpr (KIND == kI16) return __byte_perm(__vmins2(x, p), __vmaxs2(x, p), 0x7610);
  else {
    const uint32_t r = __byte_perm(as_u32(__hmin2_nan(as_bf2(x), as_bf2(p))),
                                   as_u32(__hmax2_nan(as_bf2(x), as_bf2(p))), 0x7610);
    const uint32_t nx = nan2(x), np = nan2(p), any = nx | np;
    // a number stands in as the NaN that loses: 0xFFC0 for the minimum,
    // 0x7FC0 for the maximum
    const uint32_t xa = (x & nx) | (0x7FC0FFC0u & ~nx), pa = (p & np) | (0x7FC0FFC0u & ~np);
    const uint32_t nr = __byte_perm(__vminu2(xa, pa), __vmaxu2(xa, pa), 0x7610);
    return (nr & any) | (r & ~any);
  }
}

// Subnormals to zero of their sign; NaN to 0x7FC0 or 0xFFC0 by its sign.
__device__ __forceinline__ uint32_t canonical_bf16(uint32_t x) {
  const uint32_t tiny = __vcmpeq2(x & 0x7F807F80u, 0u);
  x = (x & ~tiny) | (x & 0x80008000u & tiny);
  const uint32_t nan = nan2(x);
  return (x & ~nan) | (((x & 0x80008000u) | 0x7FC07FC0u) & nan);
}

// One stage on a row of packed words, from word 63 down: the partner of
// word k holds elements 2k - S and 2k + 1 - S, old values (words 62 and 63
// are saved in t62, t63 before they change).
template <int S, int KIND>
__device__ __forceinline__ void stage16(uint32_t (&w)[kWords]) {
  const uint32_t t62 = w[kWords - 2], t63 = w[kWords - 1];
#pragma unroll
  for (int k = kWords - 1; k >= 0; --k) {
    // word k - (S + 1) / 2 holds element 2k - S (its high half when S is
    // odd, the whole pair when S is even); word k - (S - 1) / 2 holds
    // element 2k + 1 - S in its low half when S is odd
    const int ja = k - (S + 1) / 2, jb = k - (S - 1) / 2;
    const uint32_t a = ja >= 0 ? w[ja >= 0 ? ja : 0] : (ja == -1 ? t63 : t62);
    const uint32_t b = jb >= 0 ? w[jb >= 0 ? jb : 0] : t63;
    const uint32_t p = S % 2 ? __byte_perm(a, b, 0x5432) : a;
    w[k] = min_max<KIND>(w[k], p);
  }
}

template <int KIND>
__global__ void __launch_bounds__(kThreads)
stage16_kernel(const uint4* __restrict__ in, uint4* __restrict__ out, long long rows, int reps) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= rows) return;
  uint32_t w[kWords];
#pragma unroll
  for (int k = 0; k < kWords / 4; ++k) {
    const uint4 q = in[row * (kWords / 4) + k];
    w[4 * k] = q.x, w[4 * k + 1] = q.y, w[4 * k + 2] = q.z, w[4 * k + 3] = q.w;
  }
  if (KIND == kBF16 && reps > 0) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) w[k] = canonical_bf16(w[k]);
  }
  int r = 0;
  for (; r + 4 <= reps; r += 4) {
    stage16<1, KIND>(w);
    stage16<2, KIND>(w);
    stage16<3, KIND>(w);
    stage16<4, KIND>(w);
  }
  if (r < reps) stage16<1, KIND>(w);
  if (r + 1 < reps) stage16<2, KIND>(w);
  if (r + 2 < reps) stage16<3, KIND>(w);
#pragma unroll
  for (int k = 0; k < kWords / 4; ++k)
    out[row * (kWords / 4) + k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
}

}  // namespace

extern "C" {

// in, out: `rows` rows of 128 elements, contiguous and 16-byte aligned
// (out may be in); kind: 0 int32, 1 uint16, 2 int16, 3 bfloat16; reps >= 0.
int trs_keys16_stage(const void* in, void* out, long long rows, int reps, int kind,
                     void* stream) {
  if (rows <= 0 || reps < 0 || kind < 0 || kind > 3) return cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((rows + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case kI32:
      stage32_kernel<<<blocks, kThreads, 0, s>>>((const int4*)in, (int4*)out, rows, reps);
      break;
    case kU16:
      stage16_kernel<kU16><<<blocks, kThreads, 0, s>>>((const uint4*)in, (uint4*)out, rows, reps);
      break;
    case kI16:
      stage16_kernel<kI16><<<blocks, kThreads, 0, s>>>((const uint4*)in, (uint4*)out, rows, reps);
      break;
    default:
      stage16_kernel<kBF16><<<blocks, kThreads, 0, s>>>((const uint4*)in, (uint4*)out, rows, reps);
  }
  return cudaGetLastError();
}

const char* trs_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
