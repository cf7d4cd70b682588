// The fused register-exchange ACS of kernel A as inlined device code:
// seed, one trellis step, the three-step run between two exchanges, the
// deferred register shift and the per-frame loop with its checkpoint
// stores. acs_regs.cu instantiates it whole (kernel A); probes/kablate.cu
// instantiates it with parts of the step left out (kernel E). The
// contract, layout and bound are described in acs_regs.cu, the lane
// schedule and the exchange in trellis.cuh.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "trellis.cuh"

namespace {

// Parts of the step that an instantiation may leave out: kernel A runs
// with none left out (kAbl == 0); the ablation probe (probes/kablate.cu)
// instantiates the same code with each part switched off to time it.
enum : int {
  kNoReg = 1,     // no register exchange: the registers keep their seeds
  kNoRenorm = 2,  // no renormalization
  kNoSat = 4,     // adds do not saturate at 255
  kNoBm = 8,      // no branch metrics: the metric is symbol byte 0
};

// Blocks of kMaxThreads threads that an SM must be able to hold, for
// __launch_bounds__: it tells the compiler how many registers a thread
// may take (255 with one lane a frame, 128 with four), so that it does
// not spill to stay below a smaller number it picked itself.
constexpr int regs_min_blocks(int L) { return L == 1 ? 2 : 4; }

// What a lane keeps for the whole frame.
struct RegsLane {
  int lane;                 // the lane among the frame's kLanes
  uint32_t flip[kPhases];   // the lane's polarity word at each phase
  uint32_t* xm;             // the frame's exchange words for the metrics
  uint32_t* xq;             // and for the registers
};

// Slot i of the lane holds state (i << log2 L) | lane at phase 0.
template <int L>
__device__ __forceinline__ void seed(int (&M)[kStates / L],
                                     uint32_t (&Q)[kStates / L], int lane,
                                     const int32_t* __restrict__ init) {
#pragma unroll
  for (int i = 0; i < kStates / L; ++i) {
    const int s = state_of(L, 0, 0, i) + lane;
    M[i] = __ldg(init + s);
    Q[i] = static_cast<uint32_t>(s);
  }
}

// One step at phase P of step parity kOdd on the step's symbol word w.
// The registers are only selected here: new state 2b + u takes the
// register of b or of b + 32. The shift that makes room for u, and u
// itself, come once a window (shift_in below).
template <int L, int P, bool kOdd, int kAbl>
__device__ __forceinline__ void step(int (&M)[kStates / L],
                                     uint32_t (&Q)[kStates / L], uint32_t w,
                                     const RegsLane& me) {
  constexpr int kPer = kStates / L, kHalf = kPer / 2;
  constexpr bool kSat = !(kAbl & kNoSat);
  int m8[8];
  if (kAbl & kNoBm) {
    // symbol 0 of the step for every butterfly
#pragma unroll
    for (int q = 0; q < 8; ++q) m8[q] = w & 255;
  } else {
    branch_metrics(w ^ me.flip[P], m8);
  }
  int N[kPer];
  uint32_t NQ[kPer];
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    // butterfly b, the lane's own bits left out: old states b and b + 32
    // are slots j and j + kHalf, new states 2b and 2b + 1 slots e and o
    const int b = state_of(L, P, 0, j);
    const int e = slot_of(L, P + 1, 2 * b), o = slot_of(L, P + 1, 2 * b + 1);
    const int m = m8[pattern(b)];
    const int cm = 63 - m;
    int he, ho;
    survivor<kSat>(M[j], m, M[j + kHalf], cm, N[e], he);
    survivor<kSat>(M[j], cm, M[j + kHalf], m, N[o], ho);
    if (!(kAbl & kNoReg)) {
      NQ[e] = N[e] == he ? Q[j + kHalf] : Q[j];
      NQ[o] = N[o] == ho ? Q[j + kHalf] : Q[j];
    }
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    M[i] = N[i];
    if (!(kAbl & kNoReg)) Q[i] = NQ[i];
  }
  if (!(kAbl & kNoRenorm) && kOdd) renormalize<L>(M);
}

// kPhases steps from phase 0 on the symbol words w and the exchange back
// to phase 0; the first step has parity kOdd.
template <int L, bool kOdd, int kAbl>
__device__ __forceinline__ void run(int (&M)[kStates / L],
                                    uint32_t (&Q)[kStates / L],
                                    const uint32_t (&w)[kPhases],
                                    const RegsLane& me) {
  static_assert(kPhases == 3, "the run names its steps");
  step<L, 0, kOdd, kAbl>(M, Q, w[0], me);
  step<L, 1, !kOdd, kAbl>(M, Q, w[1], me);
  step<L, 2, kOdd, kAbl>(M, Q, w[2], me);
  exchange<L, kPhases>(M, me.xm, me.lane);
  if (!(kAbl & kNoReg)) exchange<L, kPhases>(Q, me.xq, me.lane);
}

// One step from phase 0 and the exchange back to it: the form of the
// windows that are shorter than six steps.
template <int L, bool kOdd, int kAbl>
__device__ __forceinline__ void one(int (&M)[kStates / L],
                                    uint32_t (&Q)[kStates / L], uint32_t w,
                                    const RegsLane& me) {
  step<L, 0, kOdd, kAbl>(M, Q, w, me);
  exchange<L, 1>(M, me.xm, me.lane);
  if (!(kAbl & kNoReg)) exchange<L, 1>(Q, me.xq, me.lane);
}

// The deferred shift at the end of a window of n <= 6 steps, at phase 0:
// after n steps the low n bits of a survivor's register are the low n
// bits of its state, so R[s] = (Q[s] << n) | (s & (2^n - 1)) is what n
// shifts by one would have left, truncation to 32 bits included.
template <int L, int n, int kAbl>
__device__ __forceinline__ void shift_in(uint32_t (&Q)[kStates / L],
                                         int lane) {
  if (kAbl & kNoReg) return;
#pragma unroll
  for (int i = 0; i < kStates / L; ++i)
    Q[i] = (Q[i] << n) |
           (static_cast<uint32_t>(state_of(L, 0, 0, i) + lane) &
            ((1u << n) - 1u));
}

// The whole kernel for the thread's lane of its frame; the __global__
// functions that instantiate it only name L, kUnpacked and kAbl. Every
// window (a run to the next checkpoint, or to the reset if that comes
// first) starts at an even step and at phase 0, since the checkpoint
// period, the front pad and the trellis length are even.
template <int L, bool kUnpacked, int kAbl>
__device__ __forceinline__ void
acs_regs_frame(const int32_t* __restrict__ sym, int64_t sb, int64_t st,
               const int32_t* __restrict__ init, int B, int total, int pad,
               int reset_at, int ckpt, int32_t* __restrict__ regs,
               int32_t* __restrict__ met) {
  constexpr int kPer = kStates / L;
  constexpr int kFrames = kMaxThreads / L;   // frames of a block
  __shared__ __align__(16) uint32_t xbuf[L > 1 ? 2 * kFrames * kExchangeWords
                                               : 4];
  const Place<L> at(B);
  RegsLane me;
  me.lane = at.lane;
#pragma unroll
  for (int p = 0; p < kPhases; ++p) me.flip[p] = polarity_word(at.lane << p);
  me.xm = xbuf + (L > 1 ? at.local * kExchangeWords : 0);
  me.xq = me.xm + (L > 1 ? kFrames * kExchangeWords : 0);
  const int32_t* frame = sym + static_cast<int64_t>(at.frame) * sb;
  const int32_t* my_init = init + static_cast<int64_t>(at.frame) * kStates;
  int M[kPer];
  uint32_t Q[kPer];
  seed<L>(M, Q, at.lane, my_init);
  int k = 0;
  int next_ck = min(ckpt, total);
  int t = 0;
  while (t < total) {
    if (t == reset_at) seed<L>(M, Q, at.lane, my_init);
    // run to the next checkpoint, or to the reset if that comes first
    const int wend = (t < reset_at && reset_at < next_ck) ? reset_at
                                                          : next_ck;
    // the reset ends a window, so a window's steps are all dead (before
    // the front pad's end: zero symbols) or all alive
    const bool dead = t < pad;
    const int32_t* p = frame + static_cast<int64_t>(t - pad) * st;
#pragma unroll 1
    for (; t + 6 <= wend; t += 6, p += 6 * st) {
      uint32_t w[2][kPhases];
#pragma unroll
      for (int j = 0; j < 6; ++j)
        w[j / kPhases][j % kPhases] =
            dead ? 0u : load_symbols<kUnpacked>(p + j * st);
      run<L, false, kAbl>(M, Q, w[0], me);
      run<L, true, kAbl>(M, Q, w[1], me);
      shift_in<L, 6, kAbl>(Q, at.lane);
    }
    // wend - t is even: 2 or 4 steps are left, in windows of two
#pragma unroll 1
    for (; t < wend; t += 2, p += 2 * st) {
      const uint32_t w0 = dead ? 0u : load_symbols<kUnpacked>(p);
      const uint32_t w1 = dead ? 0u : load_symbols<kUnpacked>(p + st);
      one<L, false, kAbl>(M, Q, w0, me);
      one<L, true, kAbl>(M, Q, w1, me);
      shift_in<L, 2, kAbl>(Q, at.lane);
    }
    if (t == next_ck) {
      // [K, 64, B]: a warp stores, for each of its L lanes' states, a run
      // of 32 / L neighbouring frames
      if (at.live) {
        int32_t* out = regs + static_cast<int64_t>(k) * kStates * B + at.frame;
#pragma unroll
        for (int i = 0; i < kPer; ++i)
          out[static_cast<int64_t>(state_of(L, 0, 0, i) + at.lane) * B] =
              static_cast<int32_t>(Q[i]);
      }
      ++k;
      next_ck = min(next_ck + ckpt, total);
    }
  }
  if (at.live) {
    int32_t* my_met = met + static_cast<int64_t>(at.frame) * kStates;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      my_met[state_of(L, 0, 0, i) + at.lane] = M[i];
  }
}

// --- The warp-wide form: kWarpLanes = 32 lanes a frame -----------------
//
// Lane l of a frame holds butterfly l: old states l and l + 32, in the
// slot order of warp_state (trellis.cuh; an odd lane holds them swapped),
// with their metrics and registers. A step computes the two new states
// 2l and 2l + 1 and hands each to the lane that holds it next, by two
// shuffles of each array: in the first, lane l sends the new state that
// slot 0 of its reader wants, in the second the one slot 1 wants. So a
// value arrives in its slot, and nothing is selected after a shuffle: the
// swap costs nothing on the chain from one step's metrics to the next,
// since the lane picks its branch metrics for it (off that chain) and
// breaks a tie towards the high predecessor, whichever slot holds it.
// What the lanes would each compute alike is shared out: lane j holds
// the symbol word of step j of a chunk (six steps, the deferred shift's
// window), and in a round of branch metrics lane j computes pattern j & 7
// of step j / 8 of the round, which each butterfly fetches. Renormalizing
// follows the exchange of an odd step: state 0's metric (lane 0's first
// value sent) is read beside the exchange, and subtracting from every
// metric commutes with moving them.

constexpr int kChunk = 6;   // steps of a chunk: the six-step window
constexpr int kRoundSteps = kWarpLanes / 8;   // steps a round of metrics

// What a lane of the warp-wide form keeps for the whole frame.
struct WarpLane {
  int lane;
  int src[2];       // the lane each slot comes from (warp_source)
  int state[2];     // the state each slot holds at a chunk's edges
  uint32_t flip;    // the pattern word of the metric it computes in a round
  int bm[kRoundSteps];   // the lane with its butterfly's metric, for step
                         // s of a round: (s << 3) | pattern(l)
  int fx;           // 63 where slot 0 takes the complement metric in the
                    // first shuffle's state, else 0
  int tie;          // 1 where slot 0 holds the high predecessor (odd l)
  __device__ __forceinline__ explicit WarpLane(int l) : lane(l) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      src[i] = warp_source(l, i);
      state[i] = warp_state(l, i);
    }
    flip = pattern_word(l & 7);
#pragma unroll
    for (int s = 0; s < kRoundSteps; ++s) bm[s] = (s << 3) | pattern(l);
    fx = warp_complement(l) ? 63 : 0;
    tie = l & 1;
  }
};

// Step s of a chunk: both new states of the lane's butterfly, their
// exchange, and after an odd step the renormalization. m is the branch
// metric of the butterfly's low predecessor into new state 2l; a, the
// one slot 0 takes into the state it sends first, is m or its complement.
template <int s>
__device__ __forceinline__ void warp_step(int (&M)[2], uint32_t (&Q)[2],
                                          int bm, const WarpLane& me) {
  const int m = __shfl_sync(kFullWarp, bm, me.bm[s % kRoundSteps]);
  const int a = m ^ me.fx, b = a ^ 63;
  // new metric min(sat(M0 + x), sat(M1 + y)); the survivor is slot 1's
  // register where sat(M1 + y) + tie <= sat(M0 + x)
  const int p0 = min(M[0] + a, 255);
  const int n0 = min(M[1] + b, p0);
  const uint32_t q0 =
      min(M[1] + b + me.tie, 255 + me.tie) <= p0 ? Q[1] : Q[0];
  const int p1 = min(M[0] + b, 255);
  const int n1 = min(M[1] + a, p1);
  const uint32_t q1 =
      min(M[1] + a + me.tie, 255 + me.tie) <= p1 ? Q[1] : Q[0];
  constexpr bool kOdd = s % 2 == 1;   // a chunk starts at an even step
  int m0 = 0;
  if (kOdd) m0 = __shfl_sync(kFullWarp, n0, 0);   // state 0
  M[0] = __shfl_sync(kFullWarp, n0, me.src[0]);
  M[1] = __shfl_sync(kFullWarp, n1, me.src[1]);
  Q[0] = __shfl_sync(kFullWarp, q0, me.src[0]);
  Q[1] = __shfl_sync(kFullWarp, q1, me.src[1]);
  if (kOdd) {
    const int sub = m0 > 150 ? 63 : 0;
    M[0] = max(M[0] - sub, 0);
    M[1] = max(M[1] - sub, 0);
  }
}

template <int s, int kSteps, int kRounds>
__device__ __forceinline__ void warp_steps(int (&M)[2], uint32_t (&Q)[2],
                                           const int (&bm)[kRounds],
                                           const WarpLane& me) {
  if constexpr (s < kSteps) {
    warp_step<s>(M, Q, bm[s / kRoundSteps], me);
    warp_steps<s + 1, kSteps>(M, Q, bm, me);
  }
}

// A chunk of kSteps (6, or 2 at a window's end) steps on the words that
// lanes 0 to kSteps - 1 hold in win, and its deferred shift.
template <int kSteps>
__device__ __forceinline__ void warp_chunk(int (&M)[2], uint32_t (&Q)[2],
                                           uint32_t win, const WarpLane& me) {
  constexpr int kRounds = (kSteps + kRoundSteps - 1) / kRoundSteps;
  int bm[kRounds];
#pragma unroll
  for (int r = 0; r < kRounds; ++r)
    bm[r] = branch_metric(
        __shfl_sync(kFullWarp, win, r * kRoundSteps + (me.lane >> 3)) ^
        me.flip);
  warp_steps<0, kSteps>(M, Q, bm, me);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    Q[i] = (Q[i] << kSteps) |
           (static_cast<uint32_t>(me.state[i]) & ((1u << kSteps) - 1u));
}

// The symbol word of step k for lane `lane` of a chunk's kChunk: zero in
// the front pad, and nothing is read past the trellis.
template <bool kUnpacked>
__device__ __forceinline__ uint32_t warp_word(const int32_t* __restrict__ frame,
                                              int64_t st, int k, int lane,
                                              int pad, int total) {
  return lane < kChunk && k >= pad && k < total
             ? load_symbols<kUnpacked>(frame + static_cast<int64_t>(k - pad) *
                                                   st)
             : 0u;
}

// The whole kernel for the thread's lane of its frame in the warp-wide
// form; windows, checkpoints, the reset and the outputs as in
// acs_regs_frame.
template <bool kUnpacked>
__device__ __forceinline__ void
acs_regs_frame_warp(const int32_t* __restrict__ sym, int64_t sb, int64_t st,
                    const int32_t* __restrict__ init, int B, int total,
                    int pad, int reset_at, int ckpt,
                    int32_t* __restrict__ regs, int32_t* __restrict__ met) {
  const Place<kWarpLanes> at(B);
  if (!at.live) return;   // a warp past the batch: the frame is the warp's
  const WarpLane me(at.lane);
  const int32_t* frame = sym + static_cast<int64_t>(at.frame) * sb;
  const int32_t* my_init = init + static_cast<int64_t>(at.frame) * kStates;
  int M[2];
  uint32_t Q[2];
  const auto seed_warp = [&] {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      M[i] = __ldg(my_init + me.state[i]);
      Q[i] = static_cast<uint32_t>(me.state[i]);
    }
  };
  seed_warp();
  // lane j < kChunk holds the word of step t + j
  uint32_t win = warp_word<kUnpacked>(frame, st, at.lane, at.lane, pad, total);
  int k = 0;
  int next_ck = min(ckpt, total);
  int t = 0;
  while (t < total) {
    if (t == reset_at) seed_warp();
    const int wend = (t < reset_at && reset_at < next_ck) ? reset_at
                                                          : next_ck;
#pragma unroll 1
    for (; t + kChunk <= wend; t += kChunk) {
      // the next chunk's words, loaded a chunk before they are used
      const uint32_t ahead = warp_word<kUnpacked>(
          frame, st, t + kChunk + at.lane, at.lane, pad, total);
      warp_chunk<kChunk>(M, Q, win, me);
      win = ahead;
    }
    // wend - t is even: 2 or 4 steps are left, in chunks of two
#pragma unroll 1
    for (; t < wend; t += 2) {
      warp_chunk<2>(M, Q, win, me);
      // the words move on by two steps; the chunk's last two lanes load
      const uint32_t moved = __shfl_down_sync(kFullWarp, win, 2);
      win = at.lane < kChunk - 2
                ? moved
                : warp_word<kUnpacked>(frame, st, t + 2 + at.lane, at.lane,
                                       pad, total);
    }
    if (t == next_ck) {
      int32_t* out = regs + static_cast<int64_t>(k) * kStates * B + at.frame;
#pragma unroll
      for (int i = 0; i < 2; ++i)
        out[static_cast<int64_t>(me.state[i]) * B] =
            static_cast<int32_t>(Q[i]);
      ++k;
      next_ck = min(next_ck + ckpt, total);
    }
  }
  int32_t* my_met = met + static_cast<int64_t>(at.frame) * kStates;
#pragma unroll
  for (int i = 0; i < 2; ++i) my_met[me.state[i]] = M[i];
}

}  // namespace
