// Kernel K: the outer deinterleaver of an MPEG-2 transport stream in a DAB
// stream-mode subchannel, the I = 12, M = 17 convolutional (Forney) byte
// deinterleaver of ETSI EN 300 744 clause 4.3.2, over a batch of streams
// in one launch.
//
// Replaces no Pallas kernel: the JAX package has no T-DMB chain. It was
// added with the T-DMB chain (models/tdmb.py), whose decoded bytes go
// from kernel B straight to it and from it to kernel I's RS(204,188)
// entry, with no copy through the host.
//
// Contract (bit-identical to the plain version,
// viterbi_tpu_torch.ops.deinterleave.deinterleave_plain): stream s's L
// decoded bytes (L a multiple of 204) at in + s * s_in. Byte n takes
// branch j = n mod 12, which delays it by (11 - j) * 17 bytes of its own,
// d_j = (11 - j) * 204 bytes of the stream: out[s, n] = in[s, n - d_j],
// or, where n < d_j, the byte that the previous call left in branch j's
// FIFO. The FIFOs of a stream are 1122 bytes, branch j's (11 - j) * 17 at
// off_j = 17 (11 j - j (j - 1) / 2), oldest first: entry r of branch j is
// the byte at n - d_j for n = j + 12 r. carry_in is the previous call's
// (null: a fresh stream, zeros); carry_out gets this call's: entry r of
// branch j is in[s, L - d_j + j + 12 r], or where that lies before the
// call, carry_in's entry r + L / 12 of the branch.
//
// Layout: one thread writes four neighbouring output bytes (one 32-bit
// store, a warp's 128 bytes coalesced); its four loads come from four
// branches 205 bytes apart, and a warp's loads from twelve runs of
// neighbouring bytes, which the caches serve. The threads past the
// outputs write the FIFOs a byte each.
//
// What bounds it: memory, the call's bytes read once and written once
// (plus 1122 a stream each way), a few integer instructions a byte.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBranches = 12;
constexpr int kDepth = 17;
constexpr int kCarry = kDepth * kBranches * (kBranches - 1) / 2;   // 1122
constexpr int kPacket = kBranches * kDepth;                        // 204

__device__ __forceinline__ int branch_offset(int j) {
  return kDepth * (11 * j - j * (j - 1) / 2);
}

__global__ void deinterleave_kernel(const uint8_t* __restrict__ in,
                                    long long s_in, long long L, int S,
                                    const uint8_t* __restrict__ carry_in,
                                    uint8_t* __restrict__ out,
                                    uint8_t* __restrict__ carry_out) {
  const long long words = L / 4;
  const long long n_out = static_cast<long long>(S) * words;
  const long long total = n_out + static_cast<long long>(S) * kCarry;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (t < n_out) {
      const long long s = t / words;
      const long long n0 = 4 * (t - s * words);
      const uint8_t* row = in + s * s_in;
      uint32_t word = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const long long n = n0 + q;
        const int j = static_cast<int>(n % kBranches);
        const long long m = n - static_cast<long long>(11 - j) * kPacket;
        uint32_t v = 0;
        if (m >= 0)
          v = __ldg(row + m);
        else if (carry_in)
          v = __ldg(carry_in + s * kCarry + branch_offset(j)
                    + (n - j) / kBranches);
        word |= v << (8 * q);
      }
      reinterpret_cast<uint32_t*>(out + s * L)[n0 / 4] = word;
    } else {
      const long long u = t - n_out;
      const long long s = u / kCarry;
      const int e = static_cast<int>(u - s * kCarry);
      int j = 0;                               // the branch of entry e
      while (j < kBranches - 1 && e >= branch_offset(j + 1)) ++j;
      const int r = e - branch_offset(j);
      const long long m =
          L - static_cast<long long>(11 - j) * kPacket + j + kBranches * r;
      uint8_t v = 0;
      if (m >= 0)
        v = __ldg(in + s * s_in + m);
      else if (carry_in)
        v = __ldg(carry_in + s * kCarry + branch_offset(j) + r
                  + L / kBranches);
      carry_out[s * kCarry + e] = v;
    }
  }
}

}  // namespace

extern "C" {

// in: S streams of L bytes (L a multiple of 204), stream s at in + s *
// s_in; carry_in: uint8[S, 1122] or null (fresh); out: uint8[S, L];
// carry_out: uint8[S, 1122], not carry_in.
int deinterleave_launch(const void* in, long long s_in, long long L, int S,
                        const void* carry_in, void* out, void* carry_out,
                        int threads, void* stream) {
  if (S < 0 || L < 0 || L % kPacket)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(S) * (L / 4 + kCarry);
  if (total == 0) return 0;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > (1LL << 30)) blocks = 1LL << 30;
  deinterleave_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), s_in, L, S,
      static_cast<const uint8_t*>(carry_in), static_cast<uint8_t*>(out),
      static_cast<uint8_t*>(carry_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
