// Native CPU baseline sorter: the host-side yardstick of the port's sorts.
//
// The port's copy of tpu_radix_sort/runtime/native/sort.cc. The demos and
// benchmarks/crossover.py time the card's sort against this C++ LSD radix
// sort, a strong CPU baseline (O(n), cache-aware, several times faster than
// std::sort on 32-bit keys), so that a reported speedup is honest.
//
// Exposed through a plain C ABI and loaded from Python with ctypes
// (../cpu_baseline.py). Stable, ascending, 8-bit digits, 4 passes.
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

// One LSD pass: stable counting sort of (keys, payload) by byte shift / 8.
inline void radix_pass(const uint32_t* k_in, const uint32_t* v_in,
                       uint32_t* k_out, uint32_t* v_out, size_t n,
                       unsigned shift, bool has_values) {
  size_t count[256] = {0};
  for (size_t i = 0; i < n; ++i) count[(k_in[i] >> shift) & 0xFF]++;
  size_t sum = 0;
  for (int d = 0; d < 256; ++d) {
    size_t c = count[d];
    count[d] = sum;
    sum += c;
  }
  if (has_values) {
    for (size_t i = 0; i < n; ++i) {
      size_t pos = count[(k_in[i] >> shift) & 0xFF]++;
      k_out[pos] = k_in[i];
      v_out[pos] = v_in[i];
    }
  } else {
    for (size_t i = 0; i < n; ++i) {
      size_t pos = count[(k_in[i] >> shift) & 0xFF]++;
      k_out[pos] = k_in[i];
    }
  }
}

}  // namespace

extern "C" {

// Sort `n` uint32 keys ascending (stable); values co-permuted when non-null.
// In place from the caller's view (an internal ping-pong buffer).
void trs_radix_sort_u32(uint32_t* keys, uint32_t* values, size_t n) {
  if (n < 2) return;
  bool has_values = values != nullptr;
  std::vector<uint32_t> tmp_k(n);
  std::vector<uint32_t> tmp_v(has_values ? n : 0);
  uint32_t* ka = keys;
  uint32_t* kb = tmp_k.data();
  uint32_t* va = values;
  uint32_t* vb = has_values ? tmp_v.data() : nullptr;
  for (unsigned shift = 0; shift < 32; shift += 8) {
    radix_pass(ka, va, kb, vb, n, shift, has_values);
    std::swap(ka, kb);
    std::swap(va, vb);
  }
  // 4 passes, an even number of swaps: the result is back in `keys`.
}

// Number of adjacent inversions (0 == sorted): the order check's oracle.
size_t trs_disorder_count_u32(const uint32_t* keys, size_t n) {
  size_t bad = 0;
  for (size_t i = 1; i < n; ++i) bad += keys[i - 1] > keys[i];
  return bad;
}

}  // extern "C"
