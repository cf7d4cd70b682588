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
//     index and shifted left by one input bit per step;
//   * checkpoint k is the register file as of step min((k+1)*ckpt, total):
//     the last one may be partial, so any even trellis length works;
//   * steps t < pad read zero symbols; at t == reset_at the metrics restart
//     from the entry metrics and the registers from the state index.
//
// Layout: one frame per thread. The 64 metrics and 64 registers live in
// registers; a fully unrolled step reads them by compile-time index, so
// the butterfly permutation (new state 2b, 2b+1 <- old b, b+32) is
// register renaming. The permutation has period 6, so a six-step block
// ends with every value back in its own register and the loop carries no
// copies. Threads of a warp are neighbouring frames: checkpoint stores
// ([K, 64, B], frames fastest) are coalesced.
//
// What bounds it: instruction latency within one frame. A step costs
// about 700 integer instructions per frame (32 butterflies of ~20
// operations plus the branch metrics) against 4 bytes of symbols read and
// 256/ckpt bytes of checkpoints written, so memory is not the limit. At
// one frame per thread, 16384 frames fill only about one warp per
// scheduler, and each warp waits on its own dependent instructions: on an
// H100 the kernel's time is nearly flat in the batch (PERF.md). The
// unrolled butterflies are independent of each other, which is the
// instruction-level parallelism the design relies on. The frame-major
// symbol layout ([B, T] words) makes each warp load touch 32 rows; each
// 32-byte sector then serves 8 steps of one frame from L1, so the layout
// costs cache lines, not memory bandwidth.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStates = 64;
constexpr int kMaxThreads = 128;

__host__ __device__ constexpr int parity7(int x) {
  return (x ^ (x >> 1) ^ (x >> 2) ^ (x >> 3) ^ (x >> 4) ^ (x >> 5) ^
          (x >> 6)) & 1;
}

// Polarity pattern of butterfly b: bit 2 <- g0 (== g3), bit 1 <- g1,
// bit 0 <- g2. Eight patterns, so eight distinct branch metrics per step.
__host__ __device__ constexpr int pattern(int b) {
  return (parity7((b << 1) & 109) << 2) | (parity7((b << 1) & 79) << 1) |
         parity7((b << 1) & 83);
}

__device__ __forceinline__ int avg(int a, int b) { return (a + b + 1) >> 1; }

__device__ __forceinline__ void seed(int (&M)[kStates],
                                     uint32_t (&R)[kStates],
                                     const int32_t* __restrict__ init) {
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    M[s] = __ldg(init + s);
    R[s] = static_cast<uint32_t>(s);
  }
}

template <bool kUnpacked>
__device__ __forceinline__ void step(int (&M)[kStates],
                                     uint32_t (&R)[kStates], int t,
                                     const int32_t* __restrict__ frame,
                                     int64_t st, int pad) {
  int s0 = 0, s1 = 0, s2 = 0, s3 = 0;
  if (t >= pad) {
    const int32_t* p = frame + static_cast<int64_t>(t - pad) * st;
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
  int m8[8];
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int x0 = (p & 4) ? 255 : 0;
    const int x1 = (p & 2) ? 255 : 0;
    const int x2 = (p & 1) ? 255 : 0;
    m8[p] = avg(avg(s0 ^ x0, s1 ^ x1), avg(s2 ^ x2, s3 ^ x0)) >> 2;
  }
  int N[kStates];
  uint32_t NR[kStates];
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const int m = m8[pattern(b)];
    const int cm = 63 - m;
    const int p0e = min(M[b] + m, 255), p1e = min(M[b + 32] + cm, 255);
    const int p0o = min(M[b] + cm, 255), p1o = min(M[b + 32] + m, 255);
    const bool de = p1e <= p0e, dodd = p1o <= p0o;
    N[2 * b] = de ? p1e : p0e;
    N[2 * b + 1] = dodd ? p1o : p0o;
    NR[2 * b] = (de ? R[b + 32] : R[b]) << 1;
    NR[2 * b + 1] = ((dodd ? R[b + 32] : R[b]) << 1) | 1u;
  }
#pragma unroll
  for (int s = 0; s < kStates; ++s) {
    M[s] = N[s];
    R[s] = NR[s];
  }
  if (t & 1) {
    const int sub = M[0] > 150 ? 63 : 0;
#pragma unroll
    for (int s = 0; s < kStates; ++s) M[s] = max(M[s] - sub, 0);
  }
}

template <bool kUnpacked>
__global__ void __launch_bounds__(kMaxThreads)
acs_regs_kernel(const int32_t* __restrict__ sym, int64_t sb, int64_t st,
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
      for (int j = 0; j < 6; ++j) step<kUnpacked>(M, R, t + j, frame, st, pad);
    }
#pragma unroll 1
    for (; t < wend; ++t) step<kUnpacked>(M, R, t, frame, st, pad);
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

extern "C" {

// sym: frame b's step-u symbols at sym + b*sb + u*st (one packed int32
// word, symbol q in byte q) or, with unpacked != 0, four int32 symbols
// from there. init: [B, 64]; regs: [ceil(total/ckpt), 64, B]; met: [B, 64].
int acs_regs_launch(const void* sym, long long sb, long long st,
                    int unpacked, const void* init, int B, int total,
                    int pad, int reset_at, int ckpt, void* regs, void* met,
                    int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* y = static_cast<const int32_t*>(sym);
  const int32_t* i = static_cast<const int32_t*>(init);
  int32_t* r = static_cast<int32_t*>(regs);
  int32_t* m = static_cast<int32_t*>(met);
  if (unpacked)
    acs_regs_kernel<true><<<grid, threads, 0, s>>>(y, sb, st, i, B, total,
                                                   pad, reset_at, ckpt, r, m);
  else
    acs_regs_kernel<false><<<grid, threads, 0, s>>>(y, sb, st, i, B, total,
                                                    pad, reset_at, ckpt, r, m);
  return static_cast<int>(cudaGetLastError());
}

const char* vt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
