// Kernel A: fused register-exchange add-compare-select (ACS) over the
// 64-state DAB trellis (K=7, rate 1/4, polynomials {109, 79, 83, 109}).
//
// Replaces the TPU kernels of viterbi_tpu/ops/acs_pallas.py that compute
// this one function: _kernel_regs_cg_mxu (:463, the default),
// _kernel_regs_cg (:325), _kernel_regs (:749, checkpoint periods that are
// not a multiple of 6) and _kernel_regs_x6 (:613).
//
// Contract (bit-identical to those kernels and to the plain version,
// viterbi_tpu_torch.ops.acs_cuda.forward_regs_plain):
//   * branch metric of butterfly b: avg(avg(a0,a1),avg(a2,a3)) >> 2 with
//     a_q = s_q ^ (255 if pol[q][b]) and the rounding avg (x+y+1)>>1;
//   * saturating adds capped at 255; ties go to the high predecessor;
//   * after every odd step t, if state 0's metric is above 150, 63 is
//     subtracted from every metric with a floor at 0;
//   * every state carries a 32-bit survivor register, seeded with its own
//     index and shifted left by one input bit per step (the shifts of
//     a window are made at its end, see below);
//   * checkpoint k is the register file as of step min((k+1)*ckpt, total):
//     the last one may be partial, so any even trellis length works;
//   * steps t < pad read zero symbols; at t == reset_at the metrics restart
//     from the entry metrics and the registers from the state index.
//
// Layout: two forms of one device code, chosen by the wrapper from the
// batch. With one lane a frame a thread keeps the 64 metrics and the 64
// registers in registers and a warp holds 32 frames. With kLanes = 4
// neighbouring lanes a frame each lane keeps 16 of either, eight frames a
// warp. A fully unrolled step reads and writes them by compile-time
// index, so the butterfly permutation (new state 2b, 2b+1 <- old b, b+32)
// is register renaming; the lane of a state follows the lane schedule of
// trellis.cuh: three steps without a word between lanes, then one
// exchange through shared memory. A lane XORs the polarity of its own
// bits of b into the symbols, so its eight branch metrics are indexed by
// the bits its slots hold alone; state 0's metric reaches the other lanes
// by one shuffle every other step. Checkpoint stores ([K, 64, B], frames
// fastest) are, for each state, runs of eight neighbouring frames (32
// with one lane a frame): whole 32-byte sectors.
//
// The deferred shift. Inside a window of six steps the registers are only
// selected (Q'[2b+u] = d ? Q[b+32] : Q[b]); at the window's end each
// becomes (Q << 6) | state, one instruction a state a window instead of
// one a state a step. After n steps the low n bits of a survivor's
// register are the low n bits of its state, so every checkpoint holds
// what a shift a step would have left. Windows end at checkpoints and at
// the reset; what is left of one after its six-step windows (2 or 4
// steps) runs in windows of two with an exchange a step. A window's six
// symbol words are loaded before its first step.
//
// What bounds it: the integer instruction rate: a scheduler starts one
// integer instruction every other clock, and the kernel's time is its
// instruction count at that rate once the schedulers have warps. A step
// needs about 411 operations a frame (32 butterflies of 10: two adds, two
// capped adds, two mins, two compares and two selects of the register;
// the shared branch metrics; the renormalization; 64 / 6 for the deferred
// shift) against 4 bytes of symbols read and 256 / ckpt bytes of
// checkpoints written, so memory is not the limit. One lane a frame
// compiles to about 425 instructions a step and frame, close to that
// count, but holds 128 live values a thread: one warp a scheduler at
// 16384 frames, two at most, nothing to hide a stall behind, and 2,500
// instructions of unrolled code a window: 40 KB, more than an SM keeps of
// its code, so every SM streams the window from L2 and slows as more SMs
// do. Four lanes a frame need half the registers and 1,000 instructions a
// window, so four warps share a scheduler at 16384 frames and a single
// frame runs a quarter of the instructions a thread; they cost
// about 660 instructions a step and frame, since each lane computes the
// branch metrics itself and the states change lanes (eight 16-byte
// shared-memory accesses an array every three steps). So four lanes are
// the faster form up to about 28000 frames and one lane beyond (PERF.md
// has the card's times for both forms). The frame-major symbol layout
// ([B, T] words) makes the four lanes of a frame read one word together
// and a warp touch eight rows; each 32-byte sector then serves 8 steps of
// one frame from L1, and time-major symbols are no faster on the card.
//
// The device code is in acs_regs.cuh, which the ablation probe
// (probes/kablate.cu) instantiates too, with parts of the step left out.

#include <cstdint>
#include <cuda_runtime.h>

#include "acs_regs.cuh"

namespace {

template <int L, bool kUnpacked>
__global__ void __launch_bounds__(kMaxThreads, regs_min_blocks(L))
acs_regs_kernel(const int32_t* __restrict__ sym, int64_t sb, int64_t st,
                const int32_t* __restrict__ init, int B, int total, int pad,
                int reset_at, int ckpt, int32_t* __restrict__ regs,
                int32_t* __restrict__ met) {
  acs_regs_frame<L, kUnpacked, 0>(sym, sb, st, init, B, total, pad, reset_at,
                                  ckpt, regs, met);
}

}  // namespace

extern "C" {

// sym: frame b's step-u symbols at sym + b*sb + u*st (one packed int32
// word, symbol q in byte q) or, with unpacked != 0, four int32 symbols
// from there. init: [B, 64]; regs: [ceil(total/ckpt), 64, B]; met: [B, 64].
// lanes: 1 or kLanes lanes a frame; threads: a multiple of 32, at most
// kMaxThreads.
int acs_regs_launch(const void* sym, long long sb, long long st,
                    int unpacked, const void* init, int B, int total,
                    int pad, int reset_at, int ckpt, void* regs, void* met,
                    int lanes, int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!launch_ok(lanes, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* y = static_cast<const int32_t*>(sym);
  const int32_t* i = static_cast<const int32_t*>(init);
  int32_t* r = static_cast<int32_t*>(regs);
  int32_t* m = static_cast<int32_t*>(met);
#define VT_REGS_CASE(L, U)                                                  \
  acs_regs_kernel<L, U><<<blocks_for<L>(B, threads), threads, 0, s>>>(      \
      y, sb, st, i, B, total, pad, reset_at, ckpt, r, m)
  if (lanes == 1) {
    if (unpacked) VT_REGS_CASE(1, true); else VT_REGS_CASE(1, false);
  } else {
    if (unpacked) VT_REGS_CASE(kLanes, true); else VT_REGS_CASE(kLanes, false);
  }
#undef VT_REGS_CASE
  return static_cast<int>(cudaGetLastError());
}

const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
