// Shared pieces of the ACS kernels (acs_regs.cu, acs_words.cu): the
// 64-state DAB trellis (K=7, rate 1/4, polynomials {109, 79, 83, 109}),
// symbol loads and branch metrics.
//
// Branch metric of butterfly b: avg(avg(a0,a1),avg(a2,a3)) >> 2 with
// a_q = s_q ^ (255 if pol[q][b]) and the rounding avg (x+y+1)>>1. The
// polarity of butterfly b takes one of eight patterns, so a step has
// eight distinct branch metrics.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStates = 64;

__host__ __device__ constexpr int parity7(int x) {
  return (x ^ (x >> 1) ^ (x >> 2) ^ (x >> 3) ^ (x >> 4) ^ (x >> 5) ^
          (x >> 6)) & 1;
}

// Polarity pattern of butterfly b: bit 2 <- g0 (== g3), bit 1 <- g1,
// bit 0 <- g2.
__host__ __device__ constexpr int pattern(int b) {
  return (parity7((b << 1) & 109) << 2) | (parity7((b << 1) & 79) << 1) |
         parity7((b << 1) & 83);
}

__device__ __forceinline__ int avg(int a, int b) { return (a + b + 1) >> 1; }

// The eight branch metrics of one step from the step's symbols at p:
// one packed int32 word (symbol q in byte q) or, with kUnpacked, four
// int32 symbols. A null p reads zero symbols (a dead padded step).
template <bool kUnpacked>
__device__ __forceinline__ void branch_metrics(const int32_t* __restrict__ p,
                                               int (&m8)[8]) {
  int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
  if (p != nullptr) {
    if (kUnpacked) {
      s0 = __ldg(p) & 255;
      s1 = __ldg(p + 1) & 255;
      s2 = __ldg(p + 2) & 255;
      s3 = __ldg(p + 3) & 255;
    } else {
      const uint32_t w = static_cast<uint32_t>(__ldg(p));
      s0 = w & 255;
      s1 = (w >> 8) & 255;
      s2 = (w >> 16) & 255;
      s3 = w >> 24;
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const int x0 = (q & 4) ? 255 : 0;
    const int x1 = (q & 2) ? 255 : 0;
    const int x2 = (q & 1) ? 255 : 0;
    m8[q] = avg(avg(s0 ^ x0, s1 ^ x1), avg(s2 ^ x2, s3 ^ x0)) >> 2;
  }
}

// After every odd step: if state 0's metric is above 150, subtract 63
// from every metric with a floor at 0.
__device__ __forceinline__ void renormalize(int (&M)[kStates]) {
  const int sub = M[0] > 150 ? 63 : 0;
#pragma unroll
  for (int s = 0; s < kStates; ++s) M[s] = max(M[s] - sub, 0);
}

}  // namespace
