// Kernel I: the RS(120,110) decoder of RScheckSuperframe, one warp a
// codeword.
//
// Replaces viterbi_tpu/ops/rs.py:166, rs_decode_blocks: a jitted XLA
// function (the chip runs it as one compiled program), not a Pallas
// kernel.
//
// Contract (bit-identical to the plain version,
// viterbi_tpu_torch.ops.rs.rs_decode_blocks_plain, and to the scalar
// DECODE_RS of rschecksf.cpp:198-377, golden.rs_decode_codeword): per
// codeword of 120 bytes, the ten syndromes s_i = XOR_j data[j] *
// alpha^(i*(119-j)); where all are zero the count is 0 and the codeword
// unchanged. Otherwise Berlekamp-Massey over ten rounds gives lambda; a
// Chien search over the 255 field elements gives its roots in ascending
// order; the count is -1 (codeword unchanged) where their number is not
// deg lambda. Else omega = s * lambda mod x^10, and at each root whose
// position lies past the shortening pad (root >= 136) and whose
// numerator num1 is not zero, Forney's value
// alpha^(log num1 + log num2 + 255 - log den) is XOR-ed into byte
// root - 136; the count is the number of roots, those in the pad
// included. Where the reference reduces an exponent it uses Mod255's
// uint32 wrap, (x * 0x1010102) >> 24 on 32 bits; so does this kernel.
// The field goes through the reference's tables (constants.gf256_tables:
// the 768-entry pre-reduced antilog table and index_of), which the
// wrapper hands over and each block copies into shared memory.
//
// Input: int8-wide (uint8) or int32 elements, codeword n's byte j at
// (n / D) * s_g + (n % D) * s_d + j * s_j elements. A deinterleaved
// superframe (D = rs_dims) and the chain's batch of superframes are
// views with these strides, so no copy or conversion precedes the
// launch. The syndromes read each element's low byte; the output is the
// element XOR the correction, as the plain version computes it.
// Output: count int32[B], corrected int32[B, 120].
//
// What bounds it: on the mixes a receiver sees (most codewords clean)
// the syndromes' table operations: per byte a log lookup, then for each
// of the ten syndromes an exponent add, an antilog lookup and an XOR,
// 3720 operations a codeword, against 604 bytes moved (120 read as
// uint8, the count and 120 int32 written): at the card's int32 issue
// rate and memory rate the operations take the longer. A dirty codeword
// adds Berlekamp-Massey's 990 and a Chien search of 3 a term at each
// element visited: the reference stops at its deg-lambda-th root and
// evaluates lambda's nonzero terms (some 600 for one error), while this
// kernel evaluates every element and coefficient. Design: a warp a
// codeword, so the syndromes' 1320 lookups are spread over 32 lanes
// (four bytes a lane, loads and stores coalesced); a lane's ten partial
// syndromes are packed four to a 32-bit word and XOR-reduced by 15
// shuffles; the test for a clean codeword is warp-uniform, so a clean
// codeword costs one pass over its bytes. Berlekamp-Massey keeps
// lambda's and b's coefficients on lanes 0-10 (the discrepancy is a
// shuffle XOR over 16 lanes), the Chien search takes eight field elements
// a lane (a ballot per round gives the roots, a prefix popcount their
// order), Forney one root a lane.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kN = 120;        // bytes a shortened codeword
constexpr int kNRoots = 10;    // parity bytes, syndromes
constexpr int kNN = 255;       // field elements less zero; log of zero
constexpr int kPad = 135;      // shortening pad: RS(255,245) -> (120,110)
constexpr int kAto = 768;      // pre-reduced antilog table entries
constexpr int kWarps = 8;      // codewords a block at a time
constexpr int kBytesPerLane = (kN + 31) / 32;   // 4
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t mod255(uint32_t x) {
  return (x * 0x1010102u) >> 24;   // rschecksf.cpp:48-52, uint32 wrap
}

// Syndrome i from the three packed words (byte i % 4 of word i / 4).
__device__ __forceinline__ uint32_t syndrome(uint32_t s0, uint32_t s1,
                                             uint32_t s2, int i) {
  const uint32_t w = i < 4 ? s0 : (i < 8 ? s1 : s2);
  return (w >> (8 * (i & 3))) & 0xffu;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
rs_decode_kernel(const T* __restrict__ in, int B, int D, int64_t s_g,
                 int64_t s_d, int64_t s_j,
                 const uint8_t* __restrict__ tables,
                 int32_t* __restrict__ count_out,
                 int32_t* __restrict__ out) {
  __shared__ uint8_t ato[kAto];
  __shared__ uint8_t iof[256];
  __shared__ uint8_t corr[kWarps][kN];
  __shared__ uint8_t roots[kWarps][16];
  for (int i = threadIdx.x; i < kAto + 256; i += blockDim.x) {
    const uint8_t v = tables[i];
    if (i < kAto) ato[i] = v; else iof[i - kAto] = v;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t lanes_below = (1u << lane) - 1u;

  // the warp's codewords; n is the same on every lane of the warp
  for (int n = blockIdx.x * kWarps + warp; n < B; n += gridDim.x * kWarps) {
    const T* cw = in + static_cast<int64_t>(n / D) * s_g
                  + static_cast<int64_t>(n % D) * s_d;
    int32_t* dst = out + static_cast<int64_t>(n) * kN;
    int32_t d[kBytesPerLane];
#pragma unroll
    for (int k = 0; k < kBytesPerLane; ++k) {
      const int j = lane + 32 * k;
      d[k] = j < kN ? static_cast<int32_t>(cw[j * s_j]) : 0;
    }

    // ---- syndromes: a lane's bytes, ten roots each, packed 4 a word
    uint32_t s0 = 0, s1 = 0, s2 = 0;
#pragma unroll
    for (int k = 0; k < kBytesPerLane; ++k) {
      const int j = lane + 32 * k;
      const uint32_t v = static_cast<uint32_t>(d[k]) & 0xffu;
      if (j < kN && v) {
        const uint32_t lg = iof[v];
        const uint32_t step = kN - 1 - j;       // (119 - j) < 255
        uint32_t e = 0;                         // i * (119 - j) mod 255
#pragma unroll
        for (int i = 0; i < kNRoots; ++i) {
          const uint32_t term = static_cast<uint32_t>(ato[lg + e])
                                << (8 * (i & 3));
          if (i < 4) s0 ^= term; else if (i < 8) s1 ^= term; else s2 ^= term;
          e += step;
          if (e >= kNN) e -= kNN;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s0 ^= __shfl_xor_sync(kFull, s0, off);
      s1 ^= __shfl_xor_sync(kFull, s1, off);
      s2 ^= __shfl_xor_sync(kFull, s2, off);
    }
    if ((s0 | s1 | s2) == 0) {                  // warp-uniform
#pragma unroll
      for (int k = 0; k < kBytesPerLane; ++k) {
        const int j = lane + 32 * k;
        if (j < kN) dst[j] = d[k];
      }
      if (lane == 0) count_out[n] = 0;
      continue;
    }

    // ---- Berlekamp-Massey: coefficient `lane` of lambda and b
    auto mul = [&](uint32_t a, uint32_t b) -> uint32_t {
      return (a && b) ? ato[iof[a] + iof[b]] : 0u;
    };
    uint32_t lam = lane == 0 ? 1u : 0u;
    uint32_t bb = lam;
    int el = 0;
#pragma unroll 1
    for (int r = 1; r <= kNRoots; ++r) {
      // discrepancy: XOR over i < r of lambda[i] * s[r - 1 - i]
      uint32_t t = lane < r ? mul(lam, syndrome(s0, s1, s2, r - 1 - lane))
                            : 0u;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        t ^= __shfl_xor_sync(kFull, t, off);
      const uint32_t discr = __shfl_sync(kFull, t, 0);
      uint32_t shift_b = __shfl_up_sync(kFull, bb, 1);   // x * b(x)
      if (lane == 0 || lane > kNRoots) shift_b = 0;
      const bool swap = 2 * el <= r - 1 && discr != 0;
      // b <- lambda / discr where the registers swap, else x * b
      bb = swap ? mul(lam, ato[kNN - iof[discr]]) : shift_b;
      lam ^= mul(discr, shift_b);        // lambda - discr * x * b
      if (swap) el = r - el;
    }
    const int deg_lambda =
        31 - __clz(static_cast<int>(__ballot_sync(kFull, lam != 0)));
    // lambda in log form on every lane (kNN for a zero coefficient)
    const uint32_t lam_log_lane = lam ? iof[lam] : kNN;
    uint32_t lg[kNRoots + 1];
#pragma unroll
    for (int j = 0; j <= kNRoots; ++j)
      lg[j] = __shfl_sync(kFull, lam_log_lane, j);

    // ---- Chien: q(i) = XOR_j lambda[j] alpha^(i*j), i = 1..255; the
    // elements lane + 1 + 32 k of each lane, roots in ascending order
    int count = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t i = lane + 1 + 32 * k;
      const uint32_t step = i == kNN ? 0u : i;
      uint32_t q = 1, e = 0;                   // lambda[0] == 1
#pragma unroll
      for (int j = 1; j <= kNRoots; ++j) {
        e += step;
        if (e >= kNN) e -= kNN;               // i * j mod 255
        if (lg[j] != kNN) q ^= ato[lg[j] + e];
      }
      const bool root = i <= kNN && q == 0;
      const uint32_t ballot = __ballot_sync(kFull, root);
      const int slot = count + __popc(ballot & lanes_below);
      if (root && slot < kNRoots) roots[warp][slot] = static_cast<uint8_t>(i);
      count += __popc(ballot);
    }
    if (count != deg_lambda) {                  // uncorrectable
#pragma unroll
      for (int k = 0; k < kBytesPerLane; ++k) {
        const int j = lane + 32 * k;
        if (j < kN) dst[j] = d[k];
      }
      if (lane == 0) count_out[n] = -1;
      continue;
    }

    // ---- omega = s * lambda mod x^10: coefficient `lane` (< 10)
    uint32_t om = 0;
#pragma unroll
    for (int j = 0; j < kNRoots; ++j) {
      if (j <= lane && lane < kNRoots && lg[j] != kNN) {
        const uint32_t sv = syndrome(s0, s1, s2, lane - j);
        if (sv) om ^= ato[iof[sv] + lg[j]];
      }
    }
    const uint32_t om_log_lane = om ? iof[om] : kNN;
    uint32_t ol[kNRoots];
#pragma unroll
    for (int i = 0; i < kNRoots; ++i)
      ol[i] = __shfl_sync(kFull, om_log_lane, i);

#pragma unroll
    for (int k = 0; k < kBytesPerLane; ++k) {
      const int j = lane + 32 * k;
      if (j < kN) corr[warp][j] = 0;
    }
    __syncwarp();                               // roots and zeros visible

    // ---- Forney: root `lane` (< count)
    if (lane < count) {
      const uint32_t root = roots[warp][lane];
      if (root >= kPad + 1) {                   // else inside the pad
        // (unrolled with the bounds as conditions: ol and lg stay in
        // registers)
        uint32_t num1 = 0;
#pragma unroll
        for (int i = 0; i < kNRoots; ++i)       // i <= deg omega
          if (i < deg_lambda && ol[i] != kNN)
            num1 ^= ato[mod255(ol[i] + i * root)];
        if (num1) {
          const uint32_t num2 = ato[kNN - root];
          uint32_t den = 0;
          const int top = (deg_lambda < kNRoots - 1 ? deg_lambda
                                                    : kNRoots - 1) & ~1;
#pragma unroll
          for (int i = 0; i < kNRoots; i += 2)
            if (i <= top && lg[i + 1] != kNN)
              den ^= ato[mod255(lg[i + 1] + i * root)];
          corr[warp][root - 1 - kPad] =
              ato[iof[num1] + iof[num2] + (kNN - iof[den])];
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < kBytesPerLane; ++k) {
      const int j = lane + 32 * k;
      if (j < kN) dst[j] = d[k] ^ static_cast<int32_t>(corr[warp][j]);
    }
    if (lane == 0) count_out[n] = count;
    __syncwarp();                               // before corr is reused
  }
}

}  // namespace

extern "C" {

// in: codeword n's byte j at in + (n / D) * s_g + (n % D) * s_d + j * s_j
// elements of 1 byte (elem_bytes 1, unsigned) or 4 (int32); tables: the
// 768-entry antilog table, then index_of; count: int32[B]; out:
// int32[B, 120]. `blocks` caps the grid; each warp loops over codewords.
int rs_decode_launch(const void* in, int elem_bytes, int B, int D,
                     long long s_g, long long s_d, long long s_j,
                     const void* tables, void* count, void* out, int blocks,
                     void* stream) {
  const int needed = (B + kWarps - 1) / kWarps;
  const dim3 grid(needed < blocks ? needed : blocks);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* tab = static_cast<const uint8_t*>(tables);
  auto* cnt = static_cast<int32_t*>(count);
  auto* dst = static_cast<int32_t*>(out);
  if (elem_bytes == 1) {
    rs_decode_kernel<uint8_t><<<grid, kWarps * 32, 0, st>>>(
        static_cast<const uint8_t*>(in), B, D, s_g, s_d, s_j, tab, cnt, dst);
  } else if (elem_bytes == 4) {
    rs_decode_kernel<int32_t><<<grid, kWarps * 32, 0, st>>>(
        static_cast<const int32_t*>(in), B, D, s_g, s_d, s_j, tab, cnt, dst);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
