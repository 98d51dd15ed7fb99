// Lane-width stage-rate probe P9 (Hopper): do 16-bit lanes packed two to a
// register run min/max stages at twice the 32-bit element rate?
//
// Replaces benchmarks/explore_keys16.py:163 `stage_rate` (kernel body
// `_stage_kernel` :144): `reps` times, s = 1 + (r & 3),
// p[:, l] = x[:, (l - s) mod 128] (a roll within each 128-element row),
// x <- min(x, p) at even lanes l, max(x, p) at odd ones; for int32, uint16,
// int16 and bfloat16 rows of 128.
//
// A thread holds one whole row in registers. The roll is then a choice of
// register, fixed at compile time, and a stage is pure ALU work.
// - int32: 128 registers, one min or max an element.
// - uint16, int16: 64 words of two elements (element 2k in the low half of
//   word k), one packed minimum and one packed maximum a word (__vminu2/
//   __vmaxu2, __vmins2/__vmaxs2), merged by one byte permute, plus one more
//   to realign the partner when s is odd (the partner pair then straddles
//   two words). A row is updated in place from its last element down, with
//   the words that wrap saved first.
// - bfloat16: widened to one 32-bit code an element, 128 registers, and run
//   through the int32 stage with a signed minimum at even lanes and an
//   unsigned maximum at odd ones: one min or max an element, as int32.
//
// bfloat16 follows what the JAX package computes for these rows on the CPU
// (measured in Pallas interpret mode): subnormals count as zero of their
// sign, -0 < +0, and a NaN operand gives NaN: for the minimum 0x7FC0 if any
// NaN operand is positive, else 0xFFC0; for the maximum 0xFFC0 if any is
// negative, else 0x7FC0. So the minimum puts NaNs below every number and
// +NaN below -NaN; the maximum puts NaNs above every number and -NaN above
// +NaN. Neither the card's float order nor a 16-bit integer order gives
// both. One 32-bit code does, taken signed for the minimum and unsigned for
// the maximum: the NaNs get the two codes with the top bit set, +NaN
// 0x80000000 and -NaN 0x80000001, and every number x its total-order code
// x ^ (x & 0x8000 ? 0xFFFF : 0x8000), 0..0xFFFF, where -0 (0x7FFF) is below
// +0 (0x8000). (In 16 bits that would leave 15 bits for the 65,028 numbers
// that remain after the subnormal flush: they do not fit.) When reps > 0
// the kernel flushes subnormals, makes each NaN 0x7FC0 or 0xFFC0 by its
// sign and encodes at the load, and decodes at the store; reps = 0 copies
// the row untouched.
//
// Bound on this card: the rows read once and written once at 3.35 TB/s
// (0.0100 ms for int32, 0.0050 ms for 16 bits, 2^22 elements), or the
// stage operations: one an element a stage, above the bytes bound from
// about 16 stages on. The design keeps every stage in registers, so at
// reps = 256 the time is the ALU's.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;
constexpr int kWords = kLanes / 2;  // 16-bit rows: 64 words
constexpr int kThreads = 128;
enum { kI32 = 0, kU16 = 1, kI16 = 2, kBF16 = 3 };

// ---- 32-bit lanes: one element a register ---------------------------------
// The int32 order at both lanes.
struct MinMaxI32 {
  static __device__ __forceinline__ int lo(int a, int b) { return min(a, b); }
  static __device__ __forceinline__ int hi(int a, int b) { return max(a, b); }
};

// bfloat16 codes: signed at the minimum, unsigned at the maximum.
struct MinMaxBF16Code {
  static __device__ __forceinline__ int lo(int a, int b) { return min(a, b); }
  static __device__ __forceinline__ int hi(int a, int b) {
    return (int)max((unsigned)a, (unsigned)b);
  }
};

template <int S, class Op>
__device__ __forceinline__ void stage32(int (&v)[kLanes]) {
  int tail[S];
#pragma unroll
  for (int t = 0; t < S; ++t) tail[t] = v[kLanes - S + t];
#pragma unroll
  for (int l = kLanes - 1; l >= 0; --l) {
    const int p = l >= S ? v[l >= S ? l - S : 0] : tail[l < S ? l : 0];
    v[l] = (l & 1) ? Op::hi(v[l], p) : Op::lo(v[l], p);
  }
}

template <class Op>
__device__ __forceinline__ void stages32(int (&v)[kLanes], int reps) {
  int r = 0;
  for (; r + 4 <= reps; r += 4) {
    stage32<1, Op>(v);
    stage32<2, Op>(v);
    stage32<3, Op>(v);
    stage32<4, Op>(v);
  }
  if (r < reps) stage32<1, Op>(v);
  if (r + 1 < reps) stage32<2, Op>(v);
  if (r + 2 < reps) stage32<3, Op>(v);
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
  stages32<MinMaxI32>(v, reps);
#pragma unroll
  for (int k = 0; k < kLanes / 4; ++k)
    out[row * (kLanes / 4) + k] = make_int4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
}

// ---- bfloat16: one code an element -----------------------------------------
// Subnormals to zero of their sign; NaN to 0x7FC0 or 0xFFC0 by its sign.
__device__ __forceinline__ uint32_t canonical_bf16(uint32_t x) {
  const uint32_t tiny = __vcmpeq2(x & 0x7F807F80u, 0u);
  x = (x & ~tiny) | (x & 0x80008000u & tiny);
  const uint32_t nan = __vcmpgtu2(x & 0x7FFF7FFFu, 0x7F807F80u);
  return (x & ~nan) | (((x & 0x80008000u) | 0x7FC07FC0u) & nan);
}

// A canonical pattern (in the low 16 bits) -> its code.
__device__ __forceinline__ int bf16_code(uint32_t h) {
  const uint32_t sign = h >> 15;
  if ((h & 0x7FFFu) > 0x7F80u) return (int)(0x80000000u | sign);
  return (int)(h ^ (sign ? 0xFFFFu : 0x8000u));
}

// A code -> its pattern (in the low 16 bits).
__device__ __forceinline__ uint32_t bf16_decode(int c) {
  const uint32_t u = (uint32_t)c;
  if (c < 0) return 0x7FC0u | ((u & 1u) << 15);
  return u ^ ((u & 0x8000u) ? 0x8000u : 0xFFFFu);
}

__global__ void __launch_bounds__(kThreads)
stage_bf16_kernel(const uint4* __restrict__ in, uint4* __restrict__ out, long long rows,
                  int reps) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= rows) return;
  if (reps == 0) {
#pragma unroll
    for (int k = 0; k < kWords / 4; ++k) out[row * (kWords / 4) + k] = in[row * (kWords / 4) + k];
    return;
  }
  int v[kLanes];
#pragma unroll
  for (int k = 0; k < kWords / 4; ++k) {
    const uint4 q = in[row * (kWords / 4) + k];
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t c = canonical_bf16(w[j]);
      v[8 * k + 2 * j] = bf16_code(c & 0xFFFFu);
      v[8 * k + 2 * j + 1] = bf16_code(c >> 16);
    }
  }
  stages32<MinMaxBF16Code>(v, reps);
#pragma unroll
  for (int k = 0; k < kWords / 4; ++k) {
    uint32_t w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = bf16_decode(v[8 * k + 2 * j]) | (bf16_decode(v[8 * k + 2 * j + 1]) << 16);
    out[row * (kWords / 4) + k] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ---- 16 bits: two elements a register ---------------------------------------
// The low half (an even lane) takes the minimum, the high half the maximum.
template <int KIND>
__device__ __forceinline__ uint32_t min_max(uint32_t x, uint32_t p) {
  if constexpr (KIND == kU16) return __byte_perm(__vminu2(x, p), __vmaxu2(x, p), 0x7610);
  else return __byte_perm(__vmins2(x, p), __vmaxs2(x, p), 0x7610);
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
      stage_bf16_kernel<<<blocks, kThreads, 0, s>>>((const uint4*)in, (uint4*)out, rows, reps);
  }
  return cudaGetLastError();
}

const char* trs_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
