// The fused register-exchange ACS of kernel A as inlined device code:
// seed, one trellis step and the per-frame loop with its checkpoint
// stores. acs_regs.cu instantiates it whole (kernel A); probes/kablate.cu
// instantiates it with parts of the step left out (kernel E). The
// contract, layout and bound are described in acs_regs.cu.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "trellis.cuh"

namespace {

constexpr int kMaxThreads = 128;

// Parts of the step that an instantiation may leave out: kernel A runs
// with none left out (kAbl == 0); the ablation probe (probes/kablate.cu)
// instantiates the same code with each part switched off to time it.
enum : int {
  kNoReg = 1,     // no register exchange: the registers keep their seeds
  kNoRenorm = 2,  // no renormalization
  kNoSat = 4,     // adds do not saturate at 255
  kNoBm = 8,      // no branch metrics: the metric is symbol byte 0
};

template <int kAbl>
__device__ __forceinline__ int sat(int x) {
  return (kAbl & kNoSat) ? x : min(x, 255);
}

__device__ __forceinline__ void seed(int (&M)[kStates],
                                     uint32_t (&R)[kStates],
                                     const int32_t* __restrict__ init) {
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    M[s] = __ldg(init + s);
    R[s] = static_cast<uint32_t>(s);
  }
}

template <bool kUnpacked, int kAbl>
__device__ __forceinline__ void step(int (&M)[kStates],
                                     uint32_t (&R)[kStates], int t,
                                     const int32_t* __restrict__ frame,
                                     int64_t st, int pad) {
  const int32_t* p =
      t >= pad ? frame + static_cast<int64_t>(t - pad) * st : nullptr;
  int m8[8];
  if (kAbl & kNoBm) {
    // byte 0 of the packed word, or the first of the four int32 symbols
    const int s0 = p != nullptr ? (__ldg(p) & 255) : 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) m8[q] = s0;
  } else {
    branch_metrics<kUnpacked>(p, m8);
  }
  int N[kStates];
  uint32_t NR[kStates];
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const int m = m8[pattern(b)];
    const int cm = 63 - m;
    const int p0e = sat<kAbl>(M[b] + m), p1e = sat<kAbl>(M[b + 32] + cm);
    const int p0o = sat<kAbl>(M[b] + cm), p1o = sat<kAbl>(M[b + 32] + m);
    const bool de = p1e <= p0e, dodd = p1o <= p0o;
    N[2 * b] = de ? p1e : p0e;
    N[2 * b + 1] = dodd ? p1o : p0o;
    if (!(kAbl & kNoReg)) {
      NR[2 * b] = (de ? R[b + 32] : R[b]) << 1;
      NR[2 * b + 1] = ((dodd ? R[b + 32] : R[b]) << 1) | 1u;
    }
  }
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    M[s] = N[s];
    if (!(kAbl & kNoReg)) R[s] = NR[s];
  }
  if (!(kAbl & kNoRenorm) && (t & 1)) renormalize(M);
}

// The whole kernel for the thread's frame; the __global__ functions that
// instantiate it only name kUnpacked and kAbl.
template <bool kUnpacked, int kAbl>
__device__ __forceinline__ void
acs_regs_frame(const int32_t* __restrict__ sym, int64_t sb, int64_t st,
               const int32_t* __restrict__ init, int B, int total, int pad,
               int reset_at, int ckpt, int32_t* __restrict__ regs,
               int32_t* __restrict__ met) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int32_t* frame = sym + static_cast<int64_t>(b) * sb;
  const int32_t* my_init = init + static_cast<int64_t>(b) * kStates;
  int M[kStates];
  uint32_t R[kStates];
  seed(M, R, my_init);
  int k = 0;
  int next_ck = min(ckpt, total);
  int t = 0;
  while (t < total) {
    if (t == reset_at) seed(M, R, my_init);
    // run to the next checkpoint, or to the reset if that comes first
    const int wend = (t < reset_at && reset_at < next_ck) ? reset_at
                                                          : next_ck;
    for (; t + 6 <= wend; t += 6) {
#pragma unroll
      for (int j = 0; j < 6; ++j)
        step<kUnpacked, kAbl>(M, R, t + j, frame, st, pad);
    }
#pragma unroll 1
    for (; t < wend; ++t) step<kUnpacked, kAbl>(M, R, t, frame, st, pad);
    if (t == next_ck) {
      int32_t* out = regs + static_cast<int64_t>(k) * kStates * B + b;
#pragma unroll
      for (int s = 0; s < kStates; ++s)
        out[static_cast<int64_t>(s) * B] = static_cast<int32_t>(R[s]);
      ++k;
      next_ck = min(next_ck + ckpt, total);
    }
  }
  int32_t* my_met = met + static_cast<int64_t>(b) * kStates;
#pragma unroll
  for (int s = 0; s < kStates; ++s) my_met[s] = M[s];
}

}  // namespace
