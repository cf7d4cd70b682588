// Kernels F and G: what narrow integer types cost on the card.
//
// F replaces the TPU probe `kernel` of scripts/kdtype.py (:27): one
// elementwise operation of {add, min, compare+select, shift, xor, sub,
// add through int32, compare to an int32 select} over u8 / i8 / u16 / i16.
// On a TPU the question was which narrow vector operations the compiler
// accepts. A CUDA thread has 32-bit registers only: C++ promotes a narrow
// operand to int, so every narrow operation compiles, and the result is
// cast back at every step to keep the type's wrap-around. The question on
// this card is byte SIMD, so F also has the video instructions on four u8
// or two u16 lanes packed in one 32-bit register (__vadd4, __vaddus4,
// __vminu4, __vsub4, __vcmpleu4, __vadd2, __vminu2).
//
// G replaces `chain_kernel` of scripts/kdtype.py (:60): rounds of
// v = min(v + 3, 200); v = min(v, v + 1); v ^= 3 in i32 / i16 / u16 / u8,
// and on four u8 lanes per register with a quarter of the threads. Values
// stay below 207, so no type wraps and every type gives the same lanes.
// The constants are kernel arguments and the adds are unsigned: with
// compiled-in constants and signed adds, min(v, v + 1) folds to v.
//
// Both are bound by instruction issue and latency, not by bytes (F moves
// 3 bytes per lane once; G reads and writes each lane once for thousands
// of dependent operations). One lane (or one packed word) per thread.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

enum Op : int { kAdd, kMin, kCmpSel, kShift, kXor, kSub, kCvtI32, kCmpI32,
                kNumOps };
enum PackedOp : int { kVadd4, kVaddus4, kVminu4, kVsub4, kVcmpsel4, kVadd2,
                      kVminu2, kNumPackedOps };

// a + b with the type's wrap-around (unsigned add, then truncation)
template <typename T>
__device__ __forceinline__ T add_wrap(T a, T b) {
  return static_cast<T>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

template <typename T, int kOp>
__device__ __forceinline__ T apply(T a, T b) {
  switch (kOp) {
    case kAdd: return add_wrap(a, b);
    case kMin: return b < a ? b : a;
    case kCmpSel: return a <= b ? a : b;
    case kShift: return static_cast<T>(add_wrap(a, b) >> 1);
    case kXor: return static_cast<T>(a ^ b);
    case kSub:
      return static_cast<T>(static_cast<uint32_t>(a) -
                            static_cast<uint32_t>(b));
    case kCvtI32: {
      const int32_t wide = static_cast<int32_t>(a) + static_cast<int32_t>(b);
      return static_cast<T>(wide);
    }
    default: {  // kCmpI32
      const int32_t sel = a <= b ? 1 : 0;
      return static_cast<T>(sel);
    }
  }
}

template <int kOp>
__device__ __forceinline__ uint32_t apply_packed(uint32_t a, uint32_t b) {
  switch (kOp) {
    case kVadd4: return __vadd4(a, b);
    case kVaddus4: return __vaddus4(a, b);
    case kVminu4: return __vminu4(a, b);
    case kVsub4: return __vsub4(a, b);
    case kVcmpsel4: {
      const uint32_t le = __vcmpleu4(a, b);   // 0xff in each lane a <= b
      return (a & le) | (b & ~le);
    }
    case kVadd2: return __vadd2(a, b);
    default: return __vminu2(a, b);           // kVminu2
  }
}

template <typename T, int kOp>
__global__ void __launch_bounds__(kThreads)
elementwise_kernel(const T* __restrict__ x, const T* __restrict__ y,
                   T* __restrict__ o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = apply<T, kOp>(x[i], y[i]);
}

template <int kOp>
__global__ void __launch_bounds__(kThreads)
packed_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
              uint32_t* __restrict__ o, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) o[i] = apply_packed<kOp>(x[i], y[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
chain_kernel(const T* __restrict__ x, T* __restrict__ o, int n, int rounds,
             int c, int cap, int one) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const T tc = static_cast<T>(c), tcap = static_cast<T>(cap);
  const T tone = static_cast<T>(one);
  T v = x[i];
  for (int r = 0; r < rounds; ++r) {
    v = apply<T, kMin>(add_wrap(v, tc), tcap);
    v = apply<T, kMin>(v, add_wrap(v, tone));
    v = static_cast<T>(v ^ tc);
  }
  o[i] = v;
}

__global__ void __launch_bounds__(kThreads)
chain_u8x4_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ o,
                  int n, int rounds, uint32_t c4, uint32_t cap4,
                  uint32_t one4) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t v = x[i];
  for (int r = 0; r < rounds; ++r) {
    v = __vminu4(__vadd4(v, c4), cap4);
    v = __vminu4(v, __vadd4(v, one4));
    v ^= c4;
  }
  o[i] = v;
}

inline dim3 grid_for(int n) { return dim3((n + kThreads - 1) / kThreads); }

template <typename T>
cudaError_t launch_op(int op, const void* x, const void* y, void* o, int n,
                      cudaStream_t s) {
  const T* a = static_cast<const T*>(x);
  const T* b = static_cast<const T*>(y);
  T* c = static_cast<T*>(o);
#define VT_OP_CASE(k)                                                    \
  case k:                                                                \
    elementwise_kernel<T, k><<<grid_for(n), kThreads, 0, s>>>(a, b, c, n); \
    break;
  switch (op) {
    VT_OP_CASE(kAdd)
    VT_OP_CASE(kMin)
    VT_OP_CASE(kCmpSel)
    VT_OP_CASE(kShift)
    VT_OP_CASE(kXor)
    VT_OP_CASE(kSub)
    VT_OP_CASE(kCvtI32)
    VT_OP_CASE(kCmpI32)
    default:
      return cudaErrorInvalidValue;
  }
#undef VT_OP_CASE
  return cudaGetLastError();
}

cudaError_t launch_packed(int op, const void* x, const void* y, void* o,
                          int n, cudaStream_t s) {
  const uint32_t* a = static_cast<const uint32_t*>(x);
  const uint32_t* b = static_cast<const uint32_t*>(y);
  uint32_t* c = static_cast<uint32_t*>(o);
#define VT_PACKED_CASE(k)                                           \
  case k:                                                           \
    packed_kernel<k><<<grid_for(n), kThreads, 0, s>>>(a, b, c, n);  \
    break;
  switch (op) {
    VT_PACKED_CASE(kVadd4)
    VT_PACKED_CASE(kVaddus4)
    VT_PACKED_CASE(kVminu4)
    VT_PACKED_CASE(kVsub4)
    VT_PACKED_CASE(kVcmpsel4)
    VT_PACKED_CASE(kVadd2)
    VT_PACKED_CASE(kVminu2)
    default:
      return cudaErrorInvalidValue;
  }
#undef VT_PACKED_CASE
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_chain(const void* x, void* o, int n, int rounds, int c,
                         int cap, int one, cudaStream_t s) {
  chain_kernel<T><<<grid_for(n), kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(o), n, rounds, c, cap, one);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel F. dtype: 0 u8, 1 i8, 2 u16, 3 i16 (n elements, op an Op), or
// 4 packed (n 32-bit words, op a PackedOp). x, y, o: n elements each.
int kdtype_op_launch(int dtype, int op, const void* x, const void* y,
                     void* o, int n, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch_op<uint8_t>(op, x, y, o, n, s); break;
    case 1: err = launch_op<int8_t>(op, x, y, o, n, s); break;
    case 2: err = launch_op<uint16_t>(op, x, y, o, n, s); break;
    case 3: err = launch_op<int16_t>(op, x, y, o, n, s); break;
    case 4: err = launch_packed(op, x, y, o, n, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Kernel G. dtype: 0 i32, 1 i16, 2 u16, 3 u8 (n elements), or 4 u8x4
// (n 32-bit words of four lanes). x, o: n elements each.
int kdtype_chain_launch(int dtype, const void* x, void* o, int n, int rounds,
                        int c, int cap, int one, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: err = launch_chain<int32_t>(x, o, n, rounds, c, cap, one, s); break;
    case 1: err = launch_chain<int16_t>(x, o, n, rounds, c, cap, one, s); break;
    case 2: err = launch_chain<uint16_t>(x, o, n, rounds, c, cap, one, s); break;
    case 3: err = launch_chain<uint8_t>(x, o, n, rounds, c, cap, one, s); break;
    case 4:
      chain_u8x4_kernel<<<grid_for(n), kThreads, 0, s>>>(
          static_cast<const uint32_t*>(x), static_cast<uint32_t*>(o), n,
          rounds, 0x01010101u * static_cast<uint32_t>(c & 255),
          0x01010101u * static_cast<uint32_t>(cap & 255),
          0x01010101u * static_cast<uint32_t>(one & 255));
      err = cudaGetLastError();
      break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
