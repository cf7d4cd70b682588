// Kernel H: how much instruction-level parallelism one thread can use.
//
// Replaces the TPU probe `streams_kernel` of scripts/kilp.py (:30): N
// independent streams per lane, each running v = min(v + c, v) twice a
// round for many rounds, in int32, in float32, or alternating (odd
// streams float); the output is the int32 sum of the streams. With one
// stream every operation waits for the one before it; more streams give
// the scheduler independent work, until issue, not latency, is the limit.
// That is the question behind kernel A, whose 32 butterflies per step
// are its independent streams.
//
// One lane per thread, the streams in registers (the loop over N is
// unrolled at compile time). The constant is a kernel argument and the
// integer add is unsigned: with c compiled in, or a signed add, the
// compiler may fold min(v + c, v) to v + min(c, 0) and delete the loop.
// Bound by issue or latency, not bytes: 8 bytes per lane for thousands
// of operations.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

enum Mode : int { kInt, kFloat, kMixed };

template <int kMode>
__host__ __device__ constexpr bool is_float(int k) {
  return kMode == kFloat || (kMode == kMixed && (k & 1));
}

template <int N, int kMode>
__global__ void __launch_bounds__(kThreads)
streams_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ o, int n,
               int rounds, int c, float cf) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int vi[N];
  float vf[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    vi[k] = x[i] + k;
    vf[k] = static_cast<float>(vi[k]);
  }
  for (int r = 0; r < rounds; ++r) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (is_float<kMode>(k)) {
          vf[k] = fminf(vf[k] + cf, vf[k]);
        } else {
          const int sum = static_cast<int>(static_cast<uint32_t>(vi[k]) +
                                           static_cast<uint32_t>(c));
          vi[k] = min(sum, vi[k]);
        }
      }
    }
  }
  int acc = 0;
#pragma unroll
  for (int k = 0; k < N; ++k)
    acc += is_float<kMode>(k) ? static_cast<int>(vf[k]) : vi[k];
  o[i] = acc;
}

template <int kMode>
cudaError_t launch_mode(int nstreams, const int32_t* x, int32_t* o, int n,
                        int rounds, int c, cudaStream_t s) {
  const dim3 grid((n + kThreads - 1) / kThreads);
  const float cf = static_cast<float>(c);
#define VT_STREAMS_CASE(k)                                                  \
  case k:                                                                   \
    streams_kernel<k, kMode><<<grid, kThreads, 0, s>>>(x, o, n, rounds, c, \
                                                       cf);                 \
    break;
  switch (nstreams) {
    VT_STREAMS_CASE(1)
    VT_STREAMS_CASE(2)
    VT_STREAMS_CASE(4)
    VT_STREAMS_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef VT_STREAMS_CASE
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// nstreams: 1, 2, 4 or 8; mode: 0 int, 1 float, 2 mixed. x, o: int32[n].
int kilp_streams_launch(int nstreams, int mode, const void* x, void* o, int n,
                        int rounds, int c, void* stream) {
  cudaError_t err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* a = static_cast<const int32_t*>(x);
  int32_t* b = static_cast<int32_t*>(o);
  switch (mode) {
    case kInt: err = launch_mode<kInt>(nstreams, a, b, n, rounds, c, s); break;
    case kFloat:
      err = launch_mode<kFloat>(nstreams, a, b, n, rounds, c, s);
      break;
    case kMixed:
      err = launch_mode<kMixed>(nstreams, a, b, n, rounds, c, s);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
