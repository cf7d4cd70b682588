// Kernel D: the decision-word walk, the traceback over the decision
// words of kernel C.
//
// Replaces _tb_words_kernel of viterbi_tpu/ops/traceback.py (:374),
// launched there by chainback_words_pallas (:423-472).
//
// Contract (bit-identical to the plain version,
// viterbi_tpu_torch.ops.traceback.tb_words_plain): per frame, start at
// state 0 at the end of the terminated trellis and walk the data rows
// dec[6 .. 6+framebits-1] newest first. At data row t read
// bit = (w[t][state >= 32] >> (state & 31)) & 1, emit it as data bit t,
// and move to state (state >> 1) | (bit << 5). The bits are OR-ed into
// 24-bit windows rs[t / 24, b], the lowest t at the most significant bit
// (bit 23 - t % 24). framebits is a multiple of 24.
//
// Layout: one frame per thread; a warp reads one step's 8-byte word pairs
// of 32 neighbouring frames as one 256-byte run, and its stores to
// rs[k, :] are coalesced.
//
// What bounds it: memory. The address of a step's word pair depends only
// on the step and the frame; only the choice of the word and the bit
// depends on the walk. So a window's 24 word pairs are loaded before its
// serial walk starts, and the latency of the loads overlaps instead of
// adding up step after step. The kernel reads framebits * 8 bytes per
// frame (403 MB at B = 16384, framebits 3072) and writes an eighth of a
// byte per bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTail = 6;     // trellis steps that predate the frame
constexpr int kWindow = 24;  // decoded bits per window

__global__ void tb_words_kernel(const int2* __restrict__ dec, int B,
                                int framebits, int32_t* __restrict__ rs) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  uint32_t state = 0;
  for (int k = framebits / kWindow - 1; k >= 0; --k) {
    const int2* row = dec + static_cast<int64_t>(kTail + k * kWindow) * B + b;
    int2 w[kWindow];
#pragma unroll
    for (int i = 0; i < kWindow; ++i)
      w[i] = __ldg(row + static_cast<int64_t>(i) * B);
    uint32_t acc = 0;
#pragma unroll
    for (int i = kWindow - 1; i >= 0; --i) {
      const uint32_t word = static_cast<uint32_t>(state >= 32 ? w[i].y
                                                              : w[i].x);
      const uint32_t bit = (word >> (state & 31u)) & 1u;
      acc |= bit << (kWindow - 1 - i);
      state = (state >> 1) | (bit << 5);
    }
    rs[static_cast<int64_t>(k) * B + b] = static_cast<int32_t>(acc);
  }
}

}  // namespace

extern "C" {

// dec: [T, B, 2] decision words with T >= framebits + 6; rs:
// [framebits / 24, B].
int tb_words_launch(const void* dec, int B, int framebits, void* rs,
                    int threads, void* stream) {
  const dim3 grid((B + threads - 1) / threads);
  tb_words_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int2*>(dec), B, framebits,
      static_cast<int32_t*>(rs));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
