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
// G is bound by instruction rate and latency, not by bytes (it reads and
// writes each lane once for thousands of dependent operations): one lane
// (or one packed word) per thread. F moves 3 bytes per lane once, 48 KB at
// the probe's shape, so what bounds it is the launch itself: the host's
// path to the launch and the card's own time to start and drain a grid.
// Its design keeps both short. A thread handles 16 bytes: one 128-bit load
// an operand, the operation on four 32-bit words (narrow lanes unpacked
// and re-packed in registers, each result cast back to its type, so the
// wrap-around is the scalar code's), one 128-bit store; that is a
// sixteenth of the memory instructions of one byte a thread and four
// blocks instead of 64 at the probe's shape. Threads past the last whole
// 16 bytes take one element each, and where a pointer is not 16-byte
// aligned every element goes that way. Type and op are template
// parameters; the launcher looks the kernel up in a table by the two
// codes.

#include <cstdint>
#include <type_traits>
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

// One narrow type and op: an element, and a 32-bit word of 4 / sizeof(T)
// lanes, lane j at bits [j * 8 * sizeof(T), ...), as they lie in memory.
template <typename T, int kOp>
struct NarrowFn {
  using Elem = T;
  static __device__ __forceinline__ T one(T a, T b) {
    return apply<T, kOp>(a, b);
  }
  static __device__ __forceinline__ uint32_t word(uint32_t a, uint32_t b) {
    using U = typename std::make_unsigned<T>::type;
    constexpr int kBits = 8 * sizeof(T);
    uint32_t r = 0;
#pragma unroll
    for (int j = 0; j < 32 / kBits; ++j) {
      const T x = static_cast<T>(static_cast<U>(a >> (kBits * j)));
      const T y = static_cast<T>(static_cast<U>(b >> (kBits * j)));
      r |= static_cast<uint32_t>(static_cast<U>(one(x, y))) << (kBits * j);
    }
    return r;
  }
};

// One packed op: the element is the 32-bit word itself.
template <int kOp>
struct PackedFn {
  using Elem = uint32_t;
  static __device__ __forceinline__ uint32_t one(uint32_t a, uint32_t b) {
    return apply_packed<kOp>(a, b);
  }
  static __device__ __forceinline__ uint32_t word(uint32_t a, uint32_t b) {
    return apply_packed<kOp>(a, b);
  }
};

// Threads [0, nvec) take 16 bytes each, thread nvec + j takes element
// nvec * (16 / sizeof(Elem)) + j.
template <typename F>
__global__ void __launch_bounds__(kThreads)
op_kernel(const typename F::Elem* __restrict__ x,
          const typename F::Elem* __restrict__ y,
          typename F::Elem* __restrict__ o, int n, int nvec) {
  constexpr int kPer = 16 / sizeof(typename F::Elem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nvec) {
    const uint4 a = __ldg(reinterpret_cast<const uint4*>(x) + i);
    const uint4 b = __ldg(reinterpret_cast<const uint4*>(y) + i);
    uint4 c;
    c.x = F::word(a.x, b.x);
    c.y = F::word(a.y, b.y);
    c.z = F::word(a.z, b.z);
    c.w = F::word(a.w, b.w);
    reinterpret_cast<uint4*>(o)[i] = c;
  } else {
    const int e = nvec * kPer + (i - nvec);
    if (e < n) o[e] = F::one(x[e], y[e]);
  }
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

// Kernel F's instantiations by (type code, op code); null where a type
// has no such op.
template <typename F>
const void* op_entry() {
  return reinterpret_cast<const void*>(&op_kernel<F>);
}

#define VT_NARROW_ROW(T)                                                   \
  {op_entry<NarrowFn<T, kAdd>>(), op_entry<NarrowFn<T, kMin>>(),           \
   op_entry<NarrowFn<T, kCmpSel>>(), op_entry<NarrowFn<T, kShift>>(),      \
   op_entry<NarrowFn<T, kXor>>(), op_entry<NarrowFn<T, kSub>>(),           \
   op_entry<NarrowFn<T, kCvtI32>>(), op_entry<NarrowFn<T, kCmpI32>>()}
constexpr int kNumOpTypes = 5;
const void* const kOpTable[kNumOpTypes][kNumOps] = {
    VT_NARROW_ROW(uint8_t), VT_NARROW_ROW(int8_t), VT_NARROW_ROW(uint16_t),
    VT_NARROW_ROW(int16_t),
    {op_entry<PackedFn<kVadd4>>(), op_entry<PackedFn<kVaddus4>>(),
     op_entry<PackedFn<kVminu4>>(), op_entry<PackedFn<kVsub4>>(),
     op_entry<PackedFn<kVcmpsel4>>(), op_entry<PackedFn<kVadd2>>(),
     op_entry<PackedFn<kVminu2>>(), nullptr}};
#undef VT_NARROW_ROW
constexpr int kOpElemBytes[kNumOpTypes] = {1, 1, 2, 2, 4};
static_assert(static_cast<int>(kNumPackedOps) <= static_cast<int>(kNumOps),
              "the packed row fits the table");

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
// 4 packed (n 32-bit words, op a PackedOp). x, y, o: n elements each,
// aligned to their element.
int kdtype_op_launch(int dtype, int op, const void* x, const void* y,
                     void* o, int n, void* stream) {
  if (dtype < 0 || dtype >= kNumOpTypes || op < 0 || op >= kNumOps || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = kOpTable[dtype][op];
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int per = 16 / kOpElemBytes[dtype];
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
        reinterpret_cast<uintptr_t>(o)) & 15u) == 0;
  int nvec = aligned ? n / per : 0;
  const int threads = nvec + (n - nvec * per);
  void* args[] = {&x, &y, &o, &n, &nvec};
  cudaLaunchKernel(kernel, grid_for(threads), dim3(kThreads), args, 0,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// Kernel G. dtype: 0 i32, 1 i16, 2 u16, 3 u8 (n elements), or 4 u8x4
// (n 32-bit words of four lanes). x, o: n elements each.
int kdtype_chain_launch(int dtype, const void* x, void* o, int n, int rounds,
                        int c, int cap, int one, void* stream) {
  cudaError_t err;
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
