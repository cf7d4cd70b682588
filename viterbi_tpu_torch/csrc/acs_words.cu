// Kernel C: the decisions kernel. Add-compare-select (ACS) over the
// 64-state DAB trellis that writes every step's 64 decisions as the
// reference's two decision words.
//
// Replaces the TPU kernels of viterbi_tpu/ops/acs_pallas.py that compute
// this one function: _kernel_mxu (:830, the default) and its VPU twin
// _kernel (:79), both launched by forward (:166-246).
//
// Contract (bit-identical to those kernels and to the plain version,
// viterbi_tpu_torch.ops.acs_cuda.forward_plain):
//   * branch metrics, saturating adds capped at 255, ties to the high
//     predecessor and the renormalization after every odd step, as in
//     trellis.cuh and kernel A (acs_regs.cu);
//   * decisions int32[nsteps, B, 2]: bit s of word s/32 of step t is 1 iff
//     the survivor into state s at step t came from the high predecessor
//     (s>>1)+32, in natural state order (viterbi.h:89-92);
//   * final metrics int32[B, 64]; entry metrics int32[B, 64].
//
// Layout: two forms of one device code, chosen by the wrapper from the
// batch. With one lane a frame a thread keeps the 64 metrics in registers
// and a warp holds 32 frames; with kLanes = 4 neighbouring lanes a frame
// each lane keeps 16, eight frames a warp, on the lane schedule of
// trellis.cuh: three fully unrolled steps in which the butterfly
// permutation is register renaming, then one exchange through shared
// memory; branch metrics and renormalization as in kernel A. The new
// metric is min(low, high) with only the high path capped (survivor in
// trellis.cuh), and the decision enters its word as the sign of
// metric - high in one funnel shift: that is the inverted decision, so
// the states are taken in descending order and the word is inverted once
// at the end. A lane's states of one word come in runs (of 2, 4 and 8
// states at the three phases of four lanes) a fixed distance apart, so
// the word is shifted once more between two runs and lands with each bit
// at its natural place for lane 0; a shift by the lane's own bits puts it
// right for the lane. The frame's four partial word pairs are OR-ed by
// two rounds of __shfl_xor_sync and lane 0 stores the pair: a warp stores
// one 64-byte run a step (256 bytes with one lane a frame).
//
// What bounds it: the integer instruction rate, as for kernel A: a scheduler
// starts one integer instruction every other clock. A step needs about
// 403 operations a frame (32 butterflies of 10: two adds, two capped
// adds, two mins, two differences and two funnel shifts; the branch
// metrics; the renormalization) against 4 bytes of symbols read and 8
// bytes of decisions written (at B = 16384 and 3078 steps, 403 MB in
// about the time kernel A takes: far below the card's bandwidth). One
// lane a frame compiles to about 355 instructions a step and frame but
// fills the schedulers only from 16384 frames on; four lanes a frame run
// about 640 a step and frame (each lane pays for its own branch metrics,
// the exchange and the words' shuffles) on four times the warps, with a
// quarter of the instructions in a thread: the faster form below about
// 12000 frames, and twice as fast for a single frame (PERF.md has the
// card's times for both forms).

#include <cstdint>
#include <cuda_runtime.h>

#include "trellis.cuh"

namespace {

// The inverted decisions of the lane's butterflies [kLo, kHi) at phase P,
// taken in descending order of the new states into w: bit n % 32 of the
// result is the sign of metric - high of new state n, for the states the lane
// would hold if it were lane 0. Writes the new metrics into N.
template <int L, int P, int kLo, int kHi>
__device__ __forceinline__ uint32_t
butterflies(const int (&M)[kStates / L], int (&N)[kStates / L],
            const int (&m8)[8]) {
  constexpr int kHalf = kStates / L / 2;
  uint32_t w = 0;
#pragma unroll
  for (int j = kHi - 1; j >= kLo; --j) {
    // butterfly b, the lane's own bits left out: old states b and b + 32
    // are slots j and j + kHalf, new states 2b and 2b + 1 slots e and o
    const int b = state_of(L, P, 0, j);
    const int e = slot_of(L, P + 1, 2 * b), o = slot_of(L, P + 1, 2 * b + 1);
    const int m = m8[pattern(b)];
    const int cm = 63 - m;
    int he, ho;
    survivor<true>(M[j], m, M[j + kHalf], cm, N[e], he);
    survivor<true>(M[j], cm, M[j + kHalf], m, N[o], ho);
    if (j < kHi - 1) {
      // the run above ended 2 * (b' - b) - 2 states higher
      const int gap = 2 * (state_of(L, P, 0, j + 1) - b) - 2;
      if (gap > 0) w <<= gap;
    }
    // metric - high is negative iff the low path won: the inverted decision
    w = __funnelshift_l(static_cast<uint32_t>(N[o] - ho), w, 1);
    w = __funnelshift_l(static_cast<uint32_t>(N[e] - he), w, 1);
  }
  return w;
}

// The bits of a decision word that lane 0 owns after a step at phase P.
template <int L, int P>
__host__ __device__ constexpr uint32_t owned_bits() {
  uint32_t mask = 0;
  for (int i = 0; i < kStates / L; ++i) {
    const int n = state_of(L, P + 1, 0, i);
    if (n < 32) mask |= 1u << n;
  }
  return mask;
}

// What a lane keeps for the whole frame.
struct WordsLane {
  int lane;                 // the lane among the frame's kLanes
  bool store;               // lane 0 of a frame inside the batch
  uint32_t flip[kPhases];   // the lane's polarity word at each phase
  uint32_t* xm;             // the frame's exchange words
};

// One step at phase P of step parity kOdd on the step's symbol word w.
template <int L, int P, bool kOdd>
__device__ __forceinline__ void step(int (&M)[kStates / L], uint32_t w,
                                     const WordsLane& me,
                                     int2* __restrict__ out) {
  constexpr int kPer = kStates / L, kHalf = kPer / 2;
  int m8[8];
  branch_metrics(w ^ me.flip[P], m8);
  int N[kPer];
  // new states 32..63 come from butterflies 16..31, the upper half of the
  // lane's slots; both words own the same bit positions
  uint32_t w1 = butterflies<L, P, kHalf / 2, kHalf>(M, N, m8);
  uint32_t w0 = butterflies<L, P, 0, kHalf / 2>(M, N, m8);
  constexpr uint32_t kOwned = owned_bits<L, P>();
  w0 = (~w0 & kOwned) << (me.lane << (P + 1));
  w1 = (~w1 & kOwned) << (me.lane << (P + 1));
#pragma unroll
  for (int i = 0; i < kPer; ++i) M[i] = N[i];
  if (kOdd) renormalize<L>(M);
#pragma unroll
  for (int x = 1; x < L; x <<= 1) {
    w0 |= __shfl_xor_sync(kFullWarp, w0, x);
    w1 |= __shfl_xor_sync(kFullWarp, w1, x);
  }
  if (me.store) *out = make_int2(static_cast<int>(w0), static_cast<int>(w1));
}

// kPhases steps from phase 0 on the symbol words w and the exchange back
// to phase 0; the first step has parity kOdd.
template <int L, bool kOdd>
__device__ __forceinline__ void run(int (&M)[kStates / L],
                                    const uint32_t (&w)[kPhases],
                                    const WordsLane& me,
                                    int2* __restrict__ out, int64_t B) {
  static_assert(kPhases == 3, "the run names its steps");
  step<L, 0, kOdd>(M, w[0], me, out);
  step<L, 1, !kOdd>(M, w[1], me, out + B);
  step<L, 2, kOdd>(M, w[2], me, out + 2 * B);
  exchange<L, kPhases>(M, me.xm, me.lane);
}

// One step from phase 0 and the exchange back to it: the form of the
// two or four steps that six does not divide.
template <int L, bool kOdd>
__device__ __forceinline__ void one(int (&M)[kStates / L], uint32_t w,
                                    const WordsLane& me,
                                    int2* __restrict__ out) {
  step<L, 0, kOdd>(M, w, me, out);
  exchange<L, 1>(M, me.xm, me.lane);
}

template <int L, bool kUnpacked>
__global__ void __launch_bounds__(kMaxThreads)
acs_words_kernel(const int32_t* __restrict__ sym, int64_t sb, int64_t st,
                 const int32_t* __restrict__ init, int B, int nsteps,
                 int2* __restrict__ dec, int32_t* __restrict__ met) {
  constexpr int kPer = kStates / L;
  constexpr int kFrames = kMaxThreads / L;   // frames of a block
  __shared__ __align__(16) uint32_t xbuf[L > 1 ? kFrames * kExchangeWords : 4];
  const Place<L> at(B);
  WordsLane me;
  me.lane = at.lane;
  me.store = at.live && at.lane == 0;
#pragma unroll
  for (int p = 0; p < kPhases; ++p) me.flip[p] = polarity_word(at.lane << p);
  me.xm = xbuf + (L > 1 ? at.local * kExchangeWords : 0);
  const int32_t* frame = sym + static_cast<int64_t>(at.frame) * sb;
  int M[kPer];
  const int32_t* my_init = init + static_cast<int64_t>(at.frame) * kStates;
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    M[i] = __ldg(my_init + state_of(L, 0, 0, i) + at.lane);
  int2* out = dec + at.frame;
  // t is even at the start of every window, so step parity is static
#pragma unroll 1
  for (int t = 0; t + 6 <= nsteps; t += 6, frame += 6 * st, out += 6 * B) {
    uint32_t w[2][kPhases];
#pragma unroll
    for (int j = 0; j < 6; ++j)
      w[j / kPhases][j % kPhases] = load_symbols<kUnpacked>(frame + j * st);
    run<L, false>(M, w[0], me, out, B);
    run<L, true>(M, w[1], me, out + kPhases * B, B);
  }
  // nsteps is even: 2 or 4 steps are left, each with its own exchange
#pragma unroll 1
  for (int t = nsteps / 6 * 6; t < nsteps;
       t += 2, frame += 2 * st, out += 2 * B) {
    const uint32_t w0 = load_symbols<kUnpacked>(frame);
    const uint32_t w1 = load_symbols<kUnpacked>(frame + st);
    one<L, false>(M, w0, me, out);
    one<L, true>(M, w1, me, out + B);
  }
  if (at.live) {
    int32_t* my_met = met + static_cast<int64_t>(at.frame) * kStates;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      my_met[state_of(L, 0, 0, i) + at.lane] = M[i];
  }
}

}  // namespace

extern "C" {

// sym: frame b's step-u symbols at sym + b*sb + u*st (one packed int32
// word, symbol q in byte q) or, with unpacked != 0, four int32 symbols
// from there. init: [B, 64]; dec: [nsteps, B, 2]; met: [B, 64]. nsteps
// must be even; lanes: 1 or kLanes lanes a frame; threads: a multiple of
// 32, at most kMaxThreads.
int acs_words_launch(const void* sym, long long sb, long long st,
                     int unpacked, const void* init, int B, int nsteps,
                     void* dec, void* met, int lanes, int threads, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!launch_ok(lanes, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* y = static_cast<const int32_t*>(sym);
  const int32_t* i = static_cast<const int32_t*>(init);
  int2* d = static_cast<int2*>(dec);
  int32_t* m = static_cast<int32_t*>(met);
#define VT_WORDS_CASE(L, U)                                                 \
  acs_words_kernel<L, U><<<blocks_for<L>(B, threads), threads, 0, s>>>(     \
      y, sb, st, i, B, nsteps, d, m)
  if (lanes == 1) {
    if (unpacked) VT_WORDS_CASE(1, true); else VT_WORDS_CASE(1, false);
  } else {
    if (unpacked) VT_WORDS_CASE(kLanes, true); else VT_WORDS_CASE(kLanes, false);
  }
#undef VT_WORDS_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
