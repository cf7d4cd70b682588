// Kernel E: ablation of kernel A. The fused register-exchange ACS of
// acs_regs.cuh, instantiated with parts of its step left out, to time
// what each part costs on the card.
//
// Replaces the TPU probe `kernel` of scripts/kablate.py (:68), a
// parameterized copy of _kernel_regs_cg. Here nothing is copied: the
// variants are instantiations of the code kernel A runs, so they cannot
// drift from it. Variant 0 (nothing left out) is kernel A bit for bit;
// every other variant has a defined result, the one of
// viterbi_tpu_torch.ops.acs_cuda.forward_regs_plain with the same parts
// left out.
//
// Same contract, layouts (one lane a frame or kLanes, packed symbols)
// and bound as kernel A: the integer instruction rate, not bytes. What a
// variant saves of kernel A's time is what the part it leaves out costs.

#include <cstdint>
#include <cuda_runtime.h>

#include "../acs_regs.cuh"

namespace {

template <int L, int kAbl>
__global__ void __launch_bounds__(kMaxThreads, regs_min_blocks(L))
kablate_kernel(const int32_t* __restrict__ sym, int64_t sb, int64_t st,
               const int32_t* __restrict__ init, int B, int total, int ckpt,
               int32_t* __restrict__ regs, int32_t* __restrict__ met) {
  acs_regs_frame<L, false, kAbl>(sym, sb, st, init, B, total, 0, -1, ckpt,
                                 regs, met);
}

constexpr int kBare = kNoReg | kNoRenorm | kNoSat | kNoBm;

}  // namespace

extern "C" {

// Packed symbols only: frame b's step-u word at sym + b*sb + u*st.
// ablate: a mask of kNoReg (1), kNoRenorm (2), kNoSat (4), kNoBm (8);
// the instantiated masks are 0, each single part, and all four, each
// with one lane a frame and with kLanes.
// init: [B, 64]; regs: [ceil(total/ckpt), 64, B]; met: [B, 64].
int kablate_launch(const void* sym, long long sb, long long st, int ablate,
                   const void* init, int B, int total, int ckpt, void* regs,
                   void* met, int lanes, int threads, void* stream) {
  if (!launch_ok(lanes, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* y = static_cast<const int32_t*>(sym);
  const int32_t* i = static_cast<const int32_t*>(init);
  int32_t* r = static_cast<int32_t*>(regs);
  int32_t* m = static_cast<int32_t*>(met);
#define VT_ABLATE_LAUNCH(L, mask)                                           \
  kablate_kernel<L, mask><<<blocks_for<L>(B, threads), threads, 0, s>>>(    \
      y, sb, st, i, B, total, ckpt, r, m)
#define VT_ABLATE_CASE(mask)                                                \
  case mask:                                                                \
    if (lanes == 1) VT_ABLATE_LAUNCH(1, mask);                              \
    else VT_ABLATE_LAUNCH(kLanes, mask);                                    \
    break;
  switch (ablate) {
    VT_ABLATE_CASE(0)
    VT_ABLATE_CASE(kNoReg)
    VT_ABLATE_CASE(kNoRenorm)
    VT_ABLATE_CASE(kNoSat)
    VT_ABLATE_CASE(kNoBm)
    VT_ABLATE_CASE(kBare)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VT_ABLATE_CASE
#undef VT_ABLATE_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
