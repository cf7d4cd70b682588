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
// Layout: one frame per thread, the 64 metrics in registers. A fully
// unrolled step reads and writes them by compile-time index, so the
// butterfly permutation (new state 2b, 2b+1 <- old b, b+32) is register
// renaming; six steps, the permutation's period, are unrolled together so
// the loop carries no copies. Each decision is OR-ed into its word at the
// compile-time bit of its natural state index, so the renaming never
// reaches the words. Threads of a warp are neighbouring frames: the
// 8-byte word pairs of one step are stored as one coalesced 256-byte run.
//
// What bounds it: instruction latency within one frame, as for kernel A.
// A step costs about 500 integer instructions per frame against 4 bytes of
// symbols read and 8 bytes of decisions written (at B = 16384 and 3078
// steps, 403 MB in about the time kernel A takes: far below the card's
// bandwidth). Without kernel A's survivor registers the live state is
// half as large, so the kernel needs far fewer registers.

#include <cstdint>
#include <cuda_runtime.h>

#include "trellis.cuh"

namespace {

constexpr int kMaxThreads = 128;

template <bool kUnpacked, bool kOdd>
__device__ __forceinline__ void step(int (&M)[kStates],
                                     const int32_t* __restrict__ p,
                                     int2* __restrict__ out) {
  int m8[8];
  branch_metrics<kUnpacked>(p, m8);
  int N[kStates];
  uint32_t w0 = 0, w1 = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const int m = m8[pattern(b)];
    const int cm = 63 - m;
    const int p0e = min(M[b] + m, 255), p1e = min(M[b + 32] + cm, 255);
    const int p0o = min(M[b] + cm, 255), p1o = min(M[b + 32] + m, 255);
    const bool de = p1e <= p0e, dodd = p1o <= p0o;
    N[2 * b] = de ? p1e : p0e;
    N[2 * b + 1] = dodd ? p1o : p0o;
    // states 2b and 2b+1 land at bits 2b%32 and 2b%32+1 of word 2b/32
    const uint32_t pair = static_cast<uint32_t>(de) |
                          (static_cast<uint32_t>(dodd) << 1);
    if (b < 16)
      w0 |= pair << (2 * b);
    else
      w1 |= pair << (2 * b - 32);
  }
#pragma unroll
  for (int s = 0; s < kStates; ++s) M[s] = N[s];
  if (kOdd) renormalize(M);
  *out = make_int2(static_cast<int>(w0), static_cast<int>(w1));
}

template <bool kUnpacked>
__global__ void __launch_bounds__(kMaxThreads)
acs_words_kernel(const int32_t* __restrict__ sym, int64_t sb, int64_t st,
                 const int32_t* __restrict__ init, int B, int nsteps,
                 int2* __restrict__ dec, int32_t* __restrict__ met) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int32_t* frame = sym + static_cast<int64_t>(b) * sb;
  int M[kStates];
  const int32_t* my_init = init + static_cast<int64_t>(b) * kStates;
#pragma unroll
  for (int s = 0; s < kStates; ++s) M[s] = __ldg(my_init + s);
  int2* out = dec + b;
  int t = 0;
  // t is even at every block start, so step parity is static inside it
  for (; t + 6 <= nsteps; t += 6) {
#pragma unroll
    for (int j = 0; j < 6; j += 2) {
      step<kUnpacked, false>(M, frame + static_cast<int64_t>(t + j) * st,
                             out + static_cast<int64_t>(t + j) * B);
      step<kUnpacked, true>(M, frame + static_cast<int64_t>(t + j + 1) * st,
                            out + static_cast<int64_t>(t + j + 1) * B);
    }
  }
  // nsteps is even: the remainder is 2 or 4 steps
#pragma unroll 1
  for (; t < nsteps; t += 2) {
    step<kUnpacked, false>(M, frame + static_cast<int64_t>(t) * st,
                           out + static_cast<int64_t>(t) * B);
    step<kUnpacked, true>(M, frame + static_cast<int64_t>(t + 1) * st,
                          out + static_cast<int64_t>(t + 1) * B);
  }
  int32_t* my_met = met + static_cast<int64_t>(b) * kStates;
#pragma unroll
  for (int s = 0; s < kStates; ++s) my_met[s] = M[s];
}

}  // namespace

extern "C" {

// sym: frame b's step-u symbols at sym + b*sb + u*st (one packed int32
// word, symbol q in byte q) or, with unpacked != 0, four int32 symbols
// from there. init: [B, 64]; dec: [nsteps, B, 2]; met: [B, 64]. nsteps
// must be even.
int acs_words_launch(const void* sym, long long sb, long long st,
                     int unpacked, const void* init, int B, int nsteps,
                     void* dec, void* met, int threads, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* y = static_cast<const int32_t*>(sym);
  const int32_t* i = static_cast<const int32_t*>(init);
  int2* d = static_cast<int2*>(dec);
  int32_t* m = static_cast<int32_t*>(met);
  if (unpacked)
    acs_words_kernel<true><<<grid, threads, 0, s>>>(y, sb, st, i, B, nsteps,
                                                    d, m);
  else
    acs_words_kernel<false><<<grid, threads, 0, s>>>(y, sb, st, i, B,
                                                     nsteps, d, m);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
