// Compare-exchange stage probe P1 (Hopper): the cost of one stage per
// column count and per formulation, with the stages of one problem running
// while the next problem's columns arrive.
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
// Problems. The stages only pair elements that differ in index bits 7-15,
// so the elements split into independent problems of 512 rows (rows 0-511
// of one half of a tile) x kProbLanes = 16 lanes: 8,192 elements a column,
// 32 KB of u32 (64 KB of u64), 16 problems a tile, 2,048 at 2^24.
//
// Persistent blocks. The launch runs as many 512-thread blocks as can be
// resident (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs: one an
// SM), never more than there are problems, and block b takes problems b,
// b + grid, b + 2 grid, ... Its shared memory is a ring of two problem
// buffers (every column of a problem), one for each of its two teams of 8
// warps: team 0 takes the block's problems 0, 2, 4, ..., team 1 problems
// 1, 3, 5, ... A team loads its problem into its buffer (16-byte cp.async
// copies), runs the stages, stores the results and loads its next problem.
// Team 1 issues its first copies only once team 0's first problem has
// landed, so the teams take turns: one team's copies run while the other
// team runs its stages, and where both run stages, 16 warps hide each
// other's latencies. Two buffers of a 3-column problem take 192 KB of the
// 227 KB a block may have; the 32-lane problems of the earlier design
// (64 KB a column) could not hold two.
//
// Shared layout: row r of a column takes 16 consecutive words at
// soff(r) = 32 * (r >> 1) + 16 * H(r), H(r) = bit 0 ^ bit 1 ^ bit 5 of r, so
// the two half-warps of every access below (rows differing in bit 0, 1 or
// 5) meet different banks.
//
// Two formulations compute the same bytes; only where a problem comes from
// and goes to changed from the earlier design, not the stages:
//   smem  each stage, each thread compare-exchanges 16 pairs of every
//         column in the problem's buffer; one barrier a stage. (Stages are
//         unrolled with m known, so each partner's address is a thread base
//         plus an immediate.) Results leave from the buffer, 16 bytes a
//         copy.
//   regs  each thread holds 32 rows of its lane in registers, a window of
//         five row bits: row bits 0-4 (window A: m = 1..16 are register
//         compare-exchanges) or row bits 4-8 (window B: m = 16..256). The
//         schedule A (1..16), B (32..256), A (1..16), B (32, 64) changes
//         window three times through the problem's own buffer (two barriers
//         each). Results leave from the registers (with three columns,
//         through the buffer).
// Every instance also runs with 0 stages: the same copies in and out, so
// the probe reads (t16 - t0) / 16 as the stage time that the copies do not
// hide.
//
// Bound on this card: each column read once and written once at 3.35 TB/s
// (0.0401 ms a u32 column at 2^24), or the operations the function needs at
// the card's 32-bit integer rate (benchmarks/__init__.py ALU_OPS_PER_S, 132
// SMs x 64 lanes x the SM clock; explore_ce.ops_per_pair): one u32 column a
// minimum and a maximum a pair a stage; two or three columns a two-word
// compare in each direction the function decides and a select of each
// column of each side (2-column 'roll': 8, 16 x 2^23 x 8 operations in
// 0.064 ms, under its bytes). The bytes bound every case. As compiled, the
// compare takes about twice the counted operations (`kernel_times.py
// --sass`), so at two and three columns the stages take longer than the
// bytes. What the design does about it: each team's copies run while the
// other team runs stages; loads and stores move whole 64-byte half rows
// (the loads ask L2 for the whole 128-byte line, which the neighbouring
// problem reads next); the regs form keeps the data in registers between
// window changes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 128;                  // elements of a row: index bits 0-6
constexpr int kTileElems = 1024 * kLanes;    // the probe's tile
constexpr int kRows = 512;                   // rows of one problem: index bits 7-15
constexpr int kProbLanes = 16;               // lanes of one problem
constexpr int kProblem = kRows * kProbLanes; // 8,192 elements a column a problem
constexpr int kLaneGroups = kLanes / kProbLanes;
constexpr int kTeamThreads = 256;              // a team: 8 warps on one problem
constexpr int kTeams = 2;                       // and one problem buffer a team
constexpr int kThreads = kTeams * kTeamThreads;
constexpr int kGroups = kTeamThreads / kProbLanes;  // 16 row groups of 16 threads
constexpr int kSlots = kProblem / kTeamThreads;     // 32 elements a column a thread
constexpr int kStages = 16;

enum { kDesc = 0, kSwap = 1, kFold = 2 };

// Element (row 0, lane 0) of problem p: tile p / 16, half (p / 8) % 2,
// lanes 16 (p % 8) ...
__device__ __forceinline__ long long problem_base(int p) {
  return (long long)(p / (2 * kLaneGroups)) * kTileElems +
         ((p / kLaneGroups) & 1) * kRows * kLanes + (p % kLaneGroups) * kProbLanes;
}

// The swizzled shared offset of row r (lanes at + 0..15).
__host__ __device__ constexpr int swz(int r) { return (r ^ (r >> 1) ^ (r >> 5)) & 1; }
__host__ __device__ constexpr int soff(int r) { return ((r >> 1) << 5) | (swz(r) << 4); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The thread's index in its team, and a barrier of its team alone.
__device__ __forceinline__ int tid() { return threadIdx.x % kTeamThreads; }

__device__ __forceinline__ void team_sync() {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + (int)(threadIdx.x / kTeamThreads)), "n"(kTeamThreads)
               : "memory");
}

// A team's copies of a problem between device memory and its buffer
// ([NCOL][kProblem], swizzled rows), 16 bytes a copy: thread t of the team
// moves pieces t, t + 256, ... of each column, a warp eight consecutive
// half rows.
template <int NCOL, typename T>
struct Copies {
  static constexpr int kPer = 16 / (int)sizeof(T);          // elements a piece
  static constexpr int kPieces = kProbLanes / kPer;         // pieces a row
  static constexpr int kEach = kRows * kPieces / kTeamThreads;  // pieces a column a thread

  __device__ __forceinline__ static int row(int k) { return (k * kTeamThreads + tid()) / kPieces; }
  __device__ __forceinline__ static int lane(int k) {
    return (k * kTeamThreads + tid()) % kPieces * kPer;
  }

  // Problem p (if p < problems) into `buf`, one commit group.
  __device__ __forceinline__ static void load(const T* in, long long n, int p, int problems,
                                              T* buf) {
    if (p < problems) {
      const T* const src = in + problem_base(p);
#pragma unroll
      for (int c = 0; c < NCOL; ++c)
#pragma unroll
        for (int k = 0; k < kEach; ++k)
          asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;" ::"r"(
                           smem_addr(buf + c * kProblem + soff(row(k)) + lane(k))),
                       "l"(src + c * n + (long long)row(k) * kLanes + lane(k)) : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  }

  // `buf` to problem p.
  __device__ __forceinline__ static void store(const T* buf, T* out, long long n, int p) {
    T* const dst = out + problem_base(p);
#pragma unroll
    for (int c = 0; c < NCOL; ++c)
#pragma unroll
      for (int k = 0; k < kEach; ++k)
        *reinterpret_cast<uint4*>(dst + c * n + (long long)row(k) * kLanes + lane(k)) =
            *reinterpret_cast<const uint4*>(buf + c * kProblem + soff(row(k)) + lane(k));
  }
};

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
// Stage m: pair j = k * 256 + t (k = 0..15) of thread t = 16 g + l is lane l
// of pair row pr = 16 k + g, rows ra = pr + (pr & -m) and ra + m. ra splits
// into a part of the thread (g, fewer than 32 rows) and a part of k whose
// bits do not overlap it, and soff is linear over such parts (XOR): so each
// partner is one of two thread bases plus an immediate.
template <int M, int KIND, int NCOL, int NKEY, bool SIGNED, typename T>
__device__ __forceinline__ void smem_stage(T* s) {
  const int l = tid() % kProbLanes, g = tid() / kProbLanes;
  const int tpart = soff(M <= 16 ? g + (g & -M) : g) | l;
  T* const base[2] = {s + tpart, s + (tpart ^ 16)};
#pragma unroll
  for (int k = 0; k < kSlots / 2; ++k) {
    const int kpart = M <= 16 ? 32 * k : 16 * k + ((16 * k) & -M);
    T* const pa = base[swz(kpart)] + ((kpart >> 1) << 5);
    T* const pb = base[swz(kpart) ^ swz(M)] + ((kpart >> 1) << 5) + ((M >> 1) << 5);
    T a[NCOL], b[NCOL];
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      a[c] = pa[c * kProblem];
      b[c] = pb[c * kProblem];
    }
    ce_pair<KIND, NCOL, NKEY, SIGNED>(a, b);
#pragma unroll
    for (int c = 0; c < NCOL; ++c) {
      pa[c * kProblem] = a[c];
      pb[c * kProblem] = b[c];
    }
  }
  team_sync();
}

template <int KIND, int NCOL, int NKEY, bool SIGNED, typename T>
__device__ __forceinline__ void smem_problem(T* s) {
  // MS = 1, 2, 4, 8, 16, 32, 64, 128, 256, 1, 2, 4, 8, 16, 32, 64
  smem_stage<1, KIND, NCOL, NKEY, SIGNED>(s);
  smem_stage<2, KIND, NCOL, NKEY, SIGNED>(s);
  smem_stage<4, KIND, NCOL, NKEY, SIGNED>(s);
  smem_stage<8, KIND, NCOL, NKEY, SIGNED>(s);
  smem_stage<16, KIND, NCOL, NKEY, SIGNED>(s);
  smem_stage<32, KIND, NCOL, NKEY, SIGNED>(s);
  smem_stage<64, KIND, NCOL, NKEY, SIGNED>(s);
  smem_stage<128, KIND, NCOL, NKEY, SIGNED>(s);
  smem_stage<256, KIND, NCOL, NKEY, SIGNED>(s);
  smem_stage<1, KIND, NCOL, NKEY, SIGNED>(s);
  smem_stage<2, KIND, NCOL, NKEY, SIGNED>(s);
  smem_stage<4, KIND, NCOL, NKEY, SIGNED>(s);
  smem_stage<8, KIND, NCOL, NKEY, SIGNED>(s);
  smem_stage<16, KIND, NCOL, NKEY, SIGNED>(s);
  smem_stage<32, KIND, NCOL, NKEY, SIGNED>(s);
  smem_stage<64, KIND, NCOL, NKEY, SIGNED>(s);
}

// ---- regs: register windows of five row bits ------------------------------
// Thread t = 16 g + l holds lane l. Window A: slot i holds row 32 g + i
// (row bits 0-4 in the slot). Window B: row 16 i + g (row bits 4-8 in the
// slot). In either window the row is a part of the thread plus a part of
// the slot on other bits, so each slot's shared address is one of two
// thread bases plus an immediate, and its device address a thread base
// plus an immediate.
template <bool WINDOW_A>
__device__ __forceinline__ int thread_row(int g) {
  return WINDOW_A ? g * 32 : g;
}

template <bool WINDOW_A>
__device__ __forceinline__ int slot_row(int i) {
  return WINDOW_A ? i : i * kGroups;
}

template <bool WINDOW_A, typename T>
struct Window {
  T* base[2];  // for slots whose row part has H = 0, and H = 1
  __device__ __forceinline__ explicit Window(T* s) {
    const int l = tid() % kProbLanes, g = tid() / kProbLanes;
    const int t = soff(thread_row<WINDOW_A>(g)) | l;
    base[0] = s + t;
    base[1] = s + (t ^ 16);
  }
  // slot i of column c
  __device__ __forceinline__ T& at(int c, int i) const {
    const int r = slot_row<WINDOW_A>(i);
    return base[swz(r)][c * kProblem + (soff(r) & ~16)];
  }
};

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

template <bool WINDOW_A, int NCOL, typename T>
__device__ __forceinline__ void read_window(T (&v)[NCOL][kSlots], T* s) {
  const Window<WINDOW_A, T> w(s);
#pragma unroll
  for (int c = 0; c < NCOL; ++c)
#pragma unroll
    for (int i = 0; i < kSlots; ++i) v[c][i] = w.at(c, i);
}

template <bool WINDOW_A, int NCOL, typename T>
__device__ __forceinline__ void write_window(const T (&v)[NCOL][kSlots], T* s) {
  const Window<WINDOW_A, T> w(s);
#pragma unroll
  for (int c = 0; c < NCOL; ++c)
#pragma unroll
    for (int i = 0; i < kSlots; ++i) w.at(c, i) = v[c][i];
}

// Move the registers from one window to the other through the problem's
// buffer. Each thread first writes the slots it read itself, so no barrier
// is needed before; one between the writes and the reads, one after.
template <bool FROM_A, int NCOL, typename T>
__device__ __forceinline__ void change_window(T (&v)[NCOL][kSlots], T* s) {
  write_window<FROM_A>(v, s);
  team_sync();
  read_window<!FROM_A>(v, s);
  team_sync();
}

template <bool WINDOW_A, int NCOL, typename T>
__device__ __forceinline__ void store_window(const T (&v)[NCOL][kSlots], T* dst, long long n) {
  const int l = tid() % kProbLanes, g = tid() / kProbLanes;
#pragma unroll
  for (int c = 0; c < NCOL; ++c) {
    T* const d = dst + c * n + (long long)thread_row<WINDOW_A>(g) * kLanes + l;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) d[slot_row<WINDOW_A>(i) * kLanes] = v[c][i];
  }
}

// The regs form stores its results from the registers, except with three
// columns: there they go back to the buffer and leave from it, as the smem
// form's do (beside 96 registers of data, ptxas spilled the stores'
// addresses out of the 128 registers a thread of 512 may have).
template <int NCOL>
__host__ __device__ constexpr bool stores_from_registers() {
  return NCOL < 3;
}

// The stages of problem p in buffer s; the results leave from the
// registers, or go back to s.
template <int KIND, int NCOL, int NKEY, bool SIGNED, typename T>
__device__ __forceinline__ void regs_problem(T* s, T* out, long long n, int p) {
  T v[NCOL][kSlots];
  read_window<true>(v, s);
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
  if constexpr (stores_from_registers<NCOL>())
    store_window<false>(v, out + problem_base(p), n);
  else
    write_window<false>(v, s);  // the slots this thread read itself
}

// ---- the persistent loop ---------------------------------------------------
// Block b takes problems b + j grid, j = 0, 1, ...; team t those with j % 2
// == t, in its own buffer.
template <bool REGS, int KIND, int NCOL, int NKEY, bool SIGNED, typename T>
__device__ __forceinline__ void ce_problems(const T* in, T* out, long long n, int n_stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int team = threadIdx.x / kTeamThreads;
  T* const s = reinterpret_cast<T*>(smem_raw) + team * NCOL * kProblem;
  // Problem indices are ints: the entry point takes n < 2^30 problems. The
  // loop's bounds are read again where they are used (volatile), so that
  // they hold no register through the stages.
  auto problems = [n] {
    long long m;
    asm volatile("mov.b64 %0, %1;" : "=l"(m) : "l"(n));
    return (int)(m / kProblem);
  };
  auto step = [] {
    unsigned g;
    asm volatile("mov.u32 %0, %%nctaid.x;" : "=r"(g));
    return kTeams * (int)g;
  };
  int p = blockIdx.x + team * gridDim.x;
  // team 1 copies its first problem in once team 0's first has landed
  // (team 0 has one: grid <= problems)
  if (team == 1) asm volatile("bar.sync 3, %0;" ::"n"(kThreads) : "memory");
  Copies<NCOL, T>::load(in, n, p, problems(), s);
#pragma unroll 1
  for (; p < problems(); p += step()) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    team_sync();  // problem p is in s for every thread of the team
    if (team == 0 && p == blockIdx.x) asm volatile("bar.arrive 3, %0;" ::"n"(kThreads) : "memory");
    bool stored = false;
    if constexpr (REGS) {
      if (n_stages) {
        regs_problem<KIND, NCOL, NKEY, SIGNED>(s, out, n, p);
        // stored from the registers: the last window change has read s,
        // and the next copies may land; else the results are in s
        stored = stores_from_registers<NCOL>();
        if (!stored) team_sync();
      }
    } else {
      if (n_stages) smem_problem<KIND, NCOL, NKEY, SIGNED>(s);
    }
    if (!stored) {
      Copies<NCOL, T>::store(s, out, n, p);
      team_sync();  // every thread of the team has read s
    }
    Copies<NCOL, T>::load(in, n, p + step(), problems(), s);
  }
}

// The dynamic shared memory of a block.
template <int NCOL, typename T>
constexpr int smem_bytes() {
  return kTeams * NCOL * kProblem * (int)sizeof(T);
}

// `in` and `out` may be the same columns: each problem's loads complete
// before its stores are issued, and problems do not overlap.
template <int KIND, int NCOL, int NKEY, bool SIGNED, typename T>
__global__ void __launch_bounds__(kThreads, 1)
ce_smem_kernel(const T* in, T* out, long long n, int n_stages) {
  ce_problems<false, KIND, NCOL, NKEY, SIGNED>(in, out, n, n_stages);
}

template <int KIND, int NCOL, int NKEY, bool SIGNED, typename T>
__global__ void __launch_bounds__(kThreads, 1)
ce_regs_kernel(const T* in, T* out, long long n, int n_stages) {
  ce_problems<true, KIND, NCOL, NKEY, SIGNED>(in, out, n, n_stages);
}

// Launch (resident == nullptr) or report the blocks an SM that can be
// resident (resident[0]), the SMs (resident[1]), the shared memory a block
// (resident[2]) and the grid that n elements launch (resident[3]): as many
// blocks as can be resident, never more than there are problems. The
// occupancy is asked once an instance.
template <int KIND, int NCOL, int NKEY, bool SIGNED, typename T>
int run(const void* in, void* out, long long n, int formulation, int n_stages,
        cudaStream_t stream, int* resident) {
  constexpr int smem = smem_bytes<NCOL, T>();
  auto kernel = formulation == 0 ? ce_smem_kernel<KIND, NCOL, NKEY, SIGNED, T>
                                 : ce_regs_kernel<KIND, NCOL, NKEY, SIGNED, T>;
  static int per_sm[2] = {0, 0}, sms = 0;
  if (!per_sm[formulation]) {
    int dev;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[formulation], kernel,
                                                          kThreads, smem);
    if (err != cudaSuccess) return err;
    if (!per_sm[formulation]) return cudaErrorLaunchOutOfResources;
  }
  const long long problems = n / kProblem, most = (long long)per_sm[formulation] * sms;
  const int grid = (int)(problems < most ? problems : most);
  if (resident) {
    resident[0] = per_sm[formulation];
    resident[1] = sms;
    resident[2] = smem;
    resident[3] = grid;
    return cudaSuccess;
  }
  kernel<<<grid, kThreads, smem, stream>>>((const T*)in, (T*)out, n, n_stages);
  return cudaGetLastError();
}

// n: a whole number of tiles, fewer than 2^30 problems.
bool length_ok(long long n) {
  return n > 0 && n % kTileElems == 0 && n / kProblem < (1 << 30);
}

int dispatch(const void* in, void* out, long long n, int fn, int formulation, int n_stages,
             cudaStream_t s, int* resident) {
  if (formulation != 0 && formulation != 1) return cudaErrorInvalidValue;
  switch (fn) {
    case 0: return run<kDesc, 1, 1, false, uint32_t>(in, out, n, formulation, n_stages, s, resident);
    case 1: return run<kDesc, 2, 2, false, uint32_t>(in, out, n, formulation, n_stages, s, resident);
    case 2: return run<kDesc, 3, 2, false, uint32_t>(in, out, n, formulation, n_stages, s, resident);
    case 3: return run<kFold, 1, 1, true, uint32_t>(in, out, n, formulation, n_stages, s, resident);
    case 4: return run<kFold, 2, 2, true, uint32_t>(in, out, n, formulation, n_stages, s, resident);
    case 5: return run<kFold, 3, 2, true, uint32_t>(in, out, n, formulation, n_stages, s, resident);
    case 6: return run<kSwap, 1, 1, false, uint32_t>(in, out, n, formulation, n_stages, s, resident);
    case 7: return run<kSwap, 2, 2, false, uint32_t>(in, out, n, formulation, n_stages, s, resident);
    case 8: return run<kSwap, 3, 2, false, uint32_t>(in, out, n, formulation, n_stages, s, resident);
    case 9: return run<kDesc, 1, 1, false, uint64_t>(in, out, n, formulation, n_stages, s, resident);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// in, out: the columns, (columns, n) contiguous (u32; one u64 column for
// function 9), 16-byte aligned, n a multiple of 131,072; out may be in. fn:
// the function id of FUNCTIONS in tpu_radix_sort_torch/benchmarks/explore_ce.py
// (0-9). formulation: 0 smem, 1 regs. n_stages: 0 or 16.
int trs_explore_ce(const void* in, void* out, long long n, int fn, int formulation,
                   int n_stages, void* stream) {
  if (!length_ok(n) || (n_stages != 0 && n_stages != kStages) ||
      ((uintptr_t)in | (uintptr_t)out) % 16)
    return cudaErrorInvalidValue;
  return dispatch(in, out, n, fn, formulation, n_stages, (cudaStream_t)stream, nullptr);
}

// For function fn in formulation on the current device: the blocks an SM
// that can be resident, the SMs, the dynamic shared memory a block, and the
// grid that trs_explore_ce launches for n elements.
int trs_explore_ce_resident(int fn, int formulation, long long n, int* per_sm, int* sms,
                            int* smem, int* grid) {
  if (!length_ok(n)) return cudaErrorInvalidValue;
  int r[4];
  const int err = dispatch(nullptr, nullptr, n, fn, formulation, 0, nullptr, r);
  if (err == cudaSuccess) *per_sm = r[0], *sms = r[1], *smem = r[2], *grid = r[3];
  return err;
}

const char* trs_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
