// Kernel J: depuncturing, the punctured soft symbols of a DAB subchannel
// put back into the rate-1/4 mother stream as the bytes kernel A reads.
//
// Replaces no Pallas kernel: the JAX package depunctures with an XLA
// scatter (depuncture_device of viterbi_tpu/models/dab.py) into a 4x
// larger int32 tensor, and the reference DLL leaves it to its caller.
// It was added so that a receiver's over-the-air symbols (only the kept
// ones, 64 a capacity unit) go to the card as bytes and become the
// packed words of kernel A there, with no int32 stream on either side.
//
// Contract (bit-identical to the plain version,
// viterbi_tpu_torch.ops.depuncture.depuncture_plain): frame r's kept
// symbols are in[r*row_bytes + k*elem], k < kept (elem 1: bytes; elem 4:
// int32 symbols, whose low byte counts, little-endian). Trellis step j of
// the frame has table[j] = (first << 4) | mask: its four mother symbols
// q = 0..3 are sent where bit q of mask is set, the i-th of them being
// kept symbol first + i. out[r*steps + j] is the step's packed word:
// byte q the sent symbol's low byte, or 127 where symbol q was punctured.
//
// Layout: a block's threads take neighbouring steps of a frame and walk
// kRows frames; a grid's y blocks stride over the rest. A warp reads the
// kept bytes of 32 neighbouring steps (one or a few sectors) and writes 32
// neighbouring words (128 bytes): both coalesced. Each thread loads its
// step's table word once for all its frames; the table (4 bytes a step)
// stays in L1 and L2.
//
// What bounds it: memory. A frame moves its kept bytes in and 4 bytes a
// step out, against a dozen integer instructions a step.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;            // frames a block walks per grid row
constexpr uint32_t kNeutral = 127;  // a punctured symbol's soft value
constexpr int kMaxGridY = 65535;

__global__ void depuncture_kernel(const uint8_t* __restrict__ in,
                                  int64_t row_bytes, int elem,
                                  const int32_t* __restrict__ table,
                                  int steps, int n,
                                  uint32_t* __restrict__ out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= steps) return;
  const uint32_t e = static_cast<uint32_t>(__ldg(table + j));
  const uint32_t mask = e & 15u;
  const int64_t first = static_cast<int64_t>(e >> 4) * elem;
  for (int64_t r0 = static_cast<int64_t>(blockIdx.y) * kRows; r0 < n;
       r0 += static_cast<int64_t>(gridDim.y) * kRows) {
    const int64_t r1 = r0 + kRows < n ? r0 + kRows : n;
    for (int64_t r = r0; r < r1; ++r) {
      const uint8_t* p = in + r * row_bytes + first;
      uint32_t word = 0;
      int k = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t v = kNeutral;
        if (mask & (1u << q)) {
          v = __ldg(p + k * elem);
          ++k;
        }
        word |= v << (8 * q);
      }
      out[r * steps + j] = word;
    }
  }
}

}  // namespace

extern "C" {

// in: N frames of kept symbols, frame r at in + r*row_bytes, symbol k at
// + k*elem bytes (elem 1 or 4); table: int32[steps]; out: uint32[N, steps].
int depuncture_launch(const void* in, long long row_bytes, int elem,
                      const void* table, int steps, int n, void* out,
                      int threads, void* stream) {
  if (elem != 1 && elem != 4) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (n + kRows - 1) / kRows;
  const dim3 grid((steps + threads - 1) / threads,
                  rows < kMaxGridY ? rows : kMaxGridY);
  depuncture_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), row_bytes, elem,
      static_cast<const int32_t*>(table), steps, n,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
