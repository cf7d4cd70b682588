// Kernel B: checkpoint-walk traceback over survivor-register checkpoints.
//
// Replaces _tb_kernel of viterbi_tpu/ops/traceback.py (:206), launched
// there by _run_tb_kernel (:266).
//
// Contract (bit-identical to the plain version,
// viterbi_tpu_torch.ops.traceback.tb_walk_plain): per frame, start at
// state anchor[b] (0 when anchor is null: the terminated trellis) and walk
// the checkpoints from K-1 down to 0. At checkpoint anchor_k[b] (K-1 when
// null) the state is set to anchor[b] again. At each checkpoint read the
// current state's register r = regs[k, state, b], emit it as rs[k, b],
// and move to state (r >> shift) & 63, where shift is gap at K-1 and ckpt
// elsewhere.
//
// Layout: one frame per thread; a warp's stores to rs[k, :] are
// coalesced.
//
// What bounds it: memory latency. Each step is one dependent gather
// (the state picks the row), so a frame's walk is K serial loads of 4
// bytes from 32-byte sectors; the design keeps all frames' walks in
// flight at once so the card overlaps their latencies.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStates = 64;

__global__ void tb_walk_kernel(const int32_t* __restrict__ regs,
                               const int32_t* __restrict__ anchor,
                               const int32_t* __restrict__ anchor_k, int B,
                               int K, int ckpt, int gap,
                               int32_t* __restrict__ rs) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int a = anchor ? anchor[b] : 0;
  const int ak = anchor_k ? anchor_k[b] : K - 1;
  int state = a;
  for (int k = K - 1; k >= 0; --k) {
    if (k == ak) state = a;
    const int32_t r =
        __ldg(regs + (static_cast<int64_t>(k) * kStates + state) * B + b);
    rs[static_cast<int64_t>(k) * B + b] = r;
    const int shift = (k == K - 1) ? gap : ckpt;
    state = static_cast<int>((static_cast<uint32_t>(r) >> shift) & 63u);
  }
}

}  // namespace

extern "C" {

// regs: [K, 64, B]; anchor, anchor_k: [B] or null; rs: [K, B].
int tb_walk_launch(const void* regs, const void* anchor,
                   const void* anchor_k, int B, int K, int ckpt, int gap,
                   void* rs, int threads, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + threads - 1) / threads);
  tb_walk_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(regs), static_cast<const int32_t*>(anchor),
      static_cast<const int32_t*>(anchor_k), B, K, ckpt, gap,
      static_cast<int32_t*>(rs));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
