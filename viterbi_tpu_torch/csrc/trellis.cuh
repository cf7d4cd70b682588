// Shared pieces of the ACS kernels (acs_regs.cu, acs_words.cu): the
// 64-state DAB trellis (K=7, rate 1/4, polynomials {109, 79, 83, 109}),
// the lane schedule that spreads one frame over several lanes of a warp,
// symbol loads, branch metrics, renormalization and the exchange.
//
// Branch metric of butterfly b: avg(avg(a0,a1),avg(a2,a3)) >> 2 with
// a_q = s_q ^ (255 if pol[q][b]) and the rounding avg (x+y+1)>>1. The
// polarity of butterfly b takes one of eight patterns, so a step has
// eight distinct branch metrics.
//
// The lane schedule. A frame is held by kLanes neighbouring lanes of one
// warp, each with 64 / kLanes states in its own registers. A butterfly
// reads old states b and b + 32 and writes 2b and 2b + 1: a step moves
// state bit i to bit i + 1 and drops bit 5. So the lane of a state may
// hang on any bits but bit 5, and the data stays where the next butterfly
// needs it as long as the lane's bits move up with it. At phase p a state
// belongs to the lane named by its bits [p, p + log2 kLanes); a step
// takes phase p to p + 1 with no traffic between lanes. After kPhases = 3
// steps (lane in bits {4, 3} for four lanes: one more step would reach
// bit 5) one exchange brings every state back to phase 0. Within a lane
// a state's slot is its index with the lane's bits taken out, so every
// register index is a compile-time constant and the butterfly permutation
// is register renaming. Three divides six, so a six-step window of the
// kernels (the deferred register shift of kernel A) ends at phase 0.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStates = 64;
// Lanes of a warp that share one frame in the several-lane form of both
// kernels (the other form has one lane a frame). Four lanes put four
// warps on a scheduler at 16384 frames and cut the unrolled code of a
// step to a quarter (PERF.md has the card's numbers for 1, 2 and 4).
constexpr int kLanes = 4;
constexpr int kPhases = 3;       // steps between two exchanges
constexpr int kMaxThreads = 128;  // threads of a block, whole warps
constexpr unsigned kFullWarp = 0xffffffffu;

__host__ __device__ constexpr int log2i(int x) {
  return x <= 1 ? 0 : 1 + log2i(x >> 1);
}

// The lane that holds state s at phase p.
__host__ __device__ constexpr int lane_of(int L, int p, int s) {
  return (s >> p) & (L - 1);
}

// The slot (register index) of state s in its lane at phase p: s with the
// lane's bits taken out.
__host__ __device__ constexpr int slot_of(int L, int p, int s) {
  return (s & ((1 << p) - 1)) | ((s >> (p + log2i(L))) << p);
}

// The state in slot i of lane l at phase p.
__host__ __device__ constexpr int state_of(int L, int p, int l, int i) {
  return (i & ((1 << p) - 1)) | (l << p) | ((i >> p) << (p + log2i(L)));
}

// What the kernels rely on: at every phase each state has exactly one
// (lane, slot); b and b + 32 share a lane with slots half a lane apart;
// the states a step writes lie in the same lane one phase on.
constexpr bool schedule_ok(int L) {
  const int per = kStates / L;
  for (int p = 0; p <= kPhases; ++p) {
    for (int s = 0; s < kStates; ++s) {
      const int l = lane_of(L, p, s), i = slot_of(L, p, s);
      if (l < 0 || l >= L || i < 0 || i >= per) return false;
      if (state_of(L, p, l, i) != s) return false;
    }
    for (int l = 0; l < L; ++l)
      for (int i = 0; i < per; ++i) {
        const int s = state_of(L, p, l, i);
        if (lane_of(L, p, s) != l || slot_of(L, p, s) != i) return false;
      }
    for (int b = 0; b < kStates / 2; ++b) {
      if (lane_of(L, p, b) != lane_of(L, p, b + 32)) return false;
      if (slot_of(L, p, b + 32) != slot_of(L, p, b) + per / 2) return false;
      if (p == kPhases) continue;
      for (int u = 0; u < 2; ++u)
        if (lane_of(L, p + 1, 2 * b + u) != lane_of(L, p, b)) return false;
    }
  }
  return true;
}
static_assert(schedule_ok(1) && schedule_ok(2) && schedule_ok(4),
              "lane schedule");
static_assert(6 % kPhases == 0, "a six-step window must end at phase 0");
static_assert(kMaxThreads % 32 == 0 && 32 % kLanes == 0,
              "a frame's lanes lie in one warp");

__host__ __device__ constexpr int parity7(int x) {
  return (x ^ (x >> 1) ^ (x >> 2) ^ (x >> 3) ^ (x >> 4) ^ (x >> 5) ^
          (x >> 6)) & 1;
}

// Polarity pattern of butterfly b: bit 2 <- g0 (== g3), bit 1 <- g1,
// bit 0 <- g2. Linear over the bits of b: pattern(x ^ y) ==
// pattern(x) ^ pattern(y).
__host__ __device__ constexpr int pattern(int b) {
  return (parity7((b << 1) & 109) << 2) | (parity7((b << 1) & 79) << 1) |
         parity7((b << 1) & 83);
}

// The polarity of butterfly b as a word over the step's four symbols:
// byte q is 255 where symbol q is complemented. A lane XORs the word of
// its own bits of b into the symbols and then indexes the eight branch
// metrics by the pattern of the bits its slot holds.
__host__ __device__ constexpr uint32_t polarity_word(int b) {
  return ((pattern(b) & 4) ? 0xff0000ffu : 0u) |
         ((pattern(b) & 2) ? 0x0000ff00u : 0u) |
         ((pattern(b) & 1) ? 0x00ff0000u : 0u);
}

constexpr bool pattern_linear() {
  for (int x = 0; x < 32; ++x)
    for (int y = 0; y < 32; ++y)
      if (pattern(x ^ y) != (pattern(x) ^ pattern(y))) return false;
  return true;
}
static_assert(pattern_linear(), "pattern must be linear over b's bits");

// The thread's place: which frame (clamped into the batch, so the idle
// lanes of a ragged last warp stay alive for the shuffles and only skip
// their stores) and which of the frame's lanes.
template <int L>
struct Place {
  int frame;   // the frame this lane works on, < B
  int lane;    // its lane among the frame's L
  int local;   // the frame's index within the block
  bool live;   // false for a lane past the batch: it stores nothing
  __device__ __forceinline__ explicit Place(int B) {
    const int f = (blockIdx.x * blockDim.x + threadIdx.x) / L;
    lane = threadIdx.x & (L - 1);
    local = threadIdx.x / L;
    live = f < B;
    frame = live ? f : B - 1;
  }
};

// Blocks of `threads` threads that cover B frames of L lanes each.
template <int L>
inline unsigned blocks_for(int B, int threads) {
  return static_cast<unsigned>(
      (static_cast<long long>(B) * L + threads - 1) / threads);
}

// What a launch takes: one lane a frame or kLanes, whole warps a block.
inline bool launch_ok(int lanes, int threads) {
  return (lanes == 1 || lanes == kLanes) && threads > 0 &&
         threads <= kMaxThreads && threads % 32 == 0;
}

__device__ __forceinline__ int avg(int a, int b) { return (a + b + 1) >> 1; }

// One step's four symbols at p as one word, symbol q in byte q: the
// packed int32 word that is stored there or, with kUnpacked, the low
// bytes of the four int32 symbols from there.
template <bool kUnpacked>
__device__ __forceinline__ uint32_t load_symbols(
    const int32_t* __restrict__ p) {
  if (!kUnpacked) return static_cast<uint32_t>(__ldg(p));
  const uint32_t lo = __byte_perm(__ldg(p), __ldg(p + 1), 0x0040);
  const uint32_t hi = __byte_perm(__ldg(p + 2), __ldg(p + 3), 0x0040);
  return __byte_perm(lo, hi, 0x5410);
}

// The eight branch metrics of one step from its symbol word w, into which
// the lane has XOR-ed its polarity word for the step's phase; entry q is
// for the butterflies whose slot bits have polarity pattern q.
__device__ __forceinline__ void branch_metrics(uint32_t w, int (&m8)[8]) {
  const int s0 = w & 255, s1 = (w >> 8) & 255, s2 = (w >> 16) & 255,
            s3 = w >> 24;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int x0 = (q & 4) ? 255 : 0;
    const int x1 = (q & 2) ? 255 : 0;
    const int x2 = (q & 1) ? 255 : 0;
    m8[q] = avg(avg(s0 ^ x0, s1 ^ x1), avg(s2 ^ x2, s3 ^ x0)) >> 2;
  }
}

// One half of a butterfly, the survivor into one new state: low
// predecessor's metric lo with branch metric a, high predecessor's hi
// with b. Only the high path is capped at 255: the new metric is
// min(lo + a, high) with high = min(hi + b, 255), which is the minimum of
// both capped paths (two fused add-min instructions), and the decision
// "the high path wins, ties included" is metric == high. kSat false
// leaves the cap out (the ablation probe).
template <bool kSat>
__device__ __forceinline__ void survivor(int lo, int a, int hi, int b,
                                         int& metric, int& high) {
  high = kSat ? min(hi + b, 255) : hi + b;
  metric = min(lo + a, high);
}

// After every odd step: if state 0's metric is above 150, subtract 63
// from every metric with a floor at 0. State 0 is slot 0 of the frame's
// lane 0 at every phase; the other lanes get its metric by a shuffle.
template <int L>
__device__ __forceinline__ void renormalize(int (&M)[kStates / L]) {
  int m0 = M[0];
  if (L > 1) m0 = __shfl_sync(kFullWarp, m0, 0, L);
  const int sub = m0 > 150 ? 63 : 0;
#pragma unroll
  for (int i = 0; i < kStates / L; ++i) M[i] = max(M[i] - sub, 0);
}

// The exchange: every state from the lane and slot it has at phase P back
// to the lane and slot it has at phase 0, through shared memory. A lane
// stores its values at addresses computed from the state and, after a
// warp barrier, reads back the ones it owns next; x is the frame's own
// kExchangeWords words, which only the frame's lanes touch.
//
// Shared memory, not shuffles: __shfl_xor_sync moves one value a lane an
// instruction and, since register arrays need compile-time indices, takes
// three selects for every two values to pick what is sent and where the
// answer goes, in two rounds for four lanes: 16 shuffles and 48 selects
// for a lane's 16 values. Through shared memory the general form is 16
// stores and 16 loads, and the form for phase kPhases with four lanes,
// which every full window takes, is four 16-byte stores and four 16-byte
// loads: state bits 5 and 2 are free on both sides, so their four states
// travel as one vector. Vector (a, c) (a: state bits {4, 3}, the lane
// that stores it; c: state bits {1, 0}, the lane that loads it) lies at
// vector a * 4 + (c ^ a) of the frame's 20: with that twist and a frame
// stride of 20 vectors the eight lanes of a quarter warp hit eight
// different bank groups on the way in and on the way out.
constexpr int kExchangeWords = 80;

template <int L, int P, typename T>
__device__ __forceinline__ void exchange(T (&V)[kStates / L],
                                         uint32_t* __restrict__ x, int lane) {
  constexpr int kPer = kStates / L;
  if constexpr (L == 1) {
    return;             // one lane holds every state in its own slot
  } else if constexpr (L == 4 && P == kPhases) {
    __syncwarp();       // the last exchange's loads are done
    uint4* xv = reinterpret_cast<uint4*>(x);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      // slot of state (s5, a, s2, c) at phase 3: (s5, s2, c)
      xv[lane * 4 + (c ^ lane)] = make_uint4(
          static_cast<uint32_t>(V[c]), static_cast<uint32_t>(V[4 + c]),
          static_cast<uint32_t>(V[8 + c]), static_cast<uint32_t>(V[12 + c]));
    }
    __syncwarp();
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      // slot of state (s5, a, s2, c) at phase 0: (s5, a, s2)
      const uint4 v = xv[a * 4 + (lane ^ a)];
      V[2 * a] = static_cast<T>(v.x);
      V[2 * a + 1] = static_cast<T>(v.y);
      V[8 + 2 * a] = static_cast<T>(v.z);
      V[8 + 2 * a + 1] = static_cast<T>(v.w);
    }
  } else {
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      x[state_of(L, P, 0, i) + (lane << P)] = static_cast<uint32_t>(V[i]);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      V[i] = static_cast<T>(x[state_of(L, 0, 0, i) + lane]);
  }
}

}  // namespace
