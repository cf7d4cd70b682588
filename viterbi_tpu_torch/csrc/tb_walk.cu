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
// elsewhere. With out != null the kernel also assembles the decoded bytes
// (traceback._regs_bytes on rs): byte i of frame b is
// (rs[k_i, b] >> p_i) & 255 with (k_i, p_i) from the shape alone.
//
// What bounds it: memory latency, then the 32-byte sectors. A step is one
// load whose address needs the load before it, about 0.75 us from device
// memory, and a frame has K of them; neighbouring frames sit in different
// states, so each load brings a sector of which 4 bytes are used. The card
// needs some 2.5 MB of sectors in flight to run its memory at full rate,
// and one walk a thread keeps 32 bytes a frame in flight.
//
// Design: S lanes a frame (S warps of a block, 32 neighbouring frames a
// warp, so a warp's loads of one checkpoint and its stores to rs[k, :] are
// as coalesced as the states allow). Lane s walks the checkpoints of
// segment s, L = ceil(K / S) of them, newest segment first. It cannot know
// the state in which the walk enters its segment, so every lane but the
// first enters from state 0. Then the lanes put their exit states in
// shared memory; a lane whose entry state differs from its neighbour's exit
// walks its segment again from the true state, and the block repeats that
// until every entry agrees. Survivor paths merge within a few constraint
// lengths, so such a walk soon leaves a checkpoint for the state the walk
// it replaces left for, usually after a step or two; there it ends, and
// the lane's exit state stands. Lane 0 enters at the anchor, which is
// true, so round r settles lane r: the loop ends after at most S - 1
// rounds, as the serial walk would, and the result is exact for any
// registers. The anchor_k reset is part of a checkpoint's step, so it
// needs no case of its own. S = 1 is the serial walk. The dependent chain
// is L loads and a short second walk instead of K, and S times the sectors
// are in flight.
//
// The bytes follow in the same launch: after the walks the block's rs
// values are in L2 (or near it), and a warp assembles the rows of eight
// neighbouring frames at a time, a lane four bytes (one where the rows are
// not word-aligned): a sector of rs serves eight lanes, a frame's four
// lanes store 16 bytes side by side, and the three PyTorch launches of
// _regs_bytes are saved.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStates = 64;
constexpr int kFrames = 32;      // frames a block: one warp wide
constexpr int kMaxSegments = 32;

constexpr int kMerged = -1;      // a re-walk met the walk it replaces

struct Walk {
  const int32_t* regs;
  int32_t* rs;
  int64_t B;
  int K, ckpt, gap;
  int b, a, ak;

  // Checkpoints hi down to lo from `state`, written to rs; returns the
  // state below lo. kAgain is a re-walk over checkpoints this thread has
  // stored before: where a step leaves for the state the stored walk left
  // for, the rest of the segment is already right, and so is its exit
  // state: kMerged.
  template <bool kAgain>
  __device__ __forceinline__ int run(int hi, int lo, int state) const {
    for (int k = hi; k >= lo; --k) {
      if (k == ak) state = a;
      const int64_t at = static_cast<int64_t>(k) * B + b;
      const int32_t r = __ldg(regs + (static_cast<int64_t>(k) * kStates +
                                      state) * B + b);
      const int shift = (k == K - 1) ? gap : ckpt;
      state = static_cast<int>((static_cast<uint32_t>(r) >> shift) & 63u);
      if (kAgain) {
        const uint32_t before = static_cast<uint32_t>(rs[at]);
        rs[at] = r;
        if (static_cast<int>((before >> shift) & 63u) == state)
          return kMerged;
      } else {
        rs[at] = r;
      }
    }
    return state;
  }
};

__global__ void __launch_bounds__(kFrames * kMaxSegments)
tb_walk_kernel(const int32_t* __restrict__ regs,
               const int32_t* __restrict__ anchor,
               const int32_t* __restrict__ anchor_k, int B, int K, int ckpt,
               int gap, int32_t* rs, uint8_t* __restrict__ out, int nbytes,
               int offset, int nsteps, int L) {
  __shared__ int exits[kMaxSegments][kFrames];
  const int ln = threadIdx.x, seg = threadIdx.y, S = blockDim.y;
  const int b = blockIdx.x * kFrames + ln;
  const bool valid = b < B;
  const int hi = K - 1 - seg * L;          // the launcher keeps hi >= 0
  const int lo = max(hi - L + 1, 0);
  Walk w{regs, rs, B, K, ckpt, gap, b, 0, K - 1};
  int entry = 0, exit_state = 0;
  if (valid) {
    w.a = anchor ? (anchor[b] & 63) : 0;
    w.ak = anchor_k ? anchor_k[b] : K - 1;
    if (seg == 0) entry = w.a;       // the one entry state that is known
    exit_state = w.run<false>(hi, lo, entry);
  }
  if (S > 1) {
    exits[seg][ln] = exit_state;
    for (;;) {
      __syncthreads();
      const int prev = seg ? exits[seg - 1][ln] : entry;
      const bool wrong = valid && prev != entry;
      if (!__syncthreads_or(wrong)) break;
      if (wrong) {
        entry = prev;
        const int left = w.run<true>(hi, lo, entry);
        if (left != kMerged) exits[seg][ln] = left;
      }
    }
  }
  if (out == nullptr) return;
  // the bytes: this block's rs values, written above, are visible to the
  // whole block after the barrier
  __syncthreads();
  // A warp takes eight neighbouring frames at a time: lane = 4 * frame +
  // j, and in one pass the lanes of a frame write 16 bytes next to each
  // other while the eight lanes of one j read the same checkpoint of
  // eight neighbouring frames, one sector of rs.
  // The loads of kBatch words go out before the first is used: nothing
  // else hides their latency here.
  constexpr int kBatch = 8;
  const int frame = ln >> 2, j = ln & 3;
  const int nquads = (nbytes % 4 == 0) ? nbytes / 4 : 0;   // rows aligned
  for (int g = seg; g < kFrames / 8; g += S) {
    const int bb = blockIdx.x * kFrames + 8 * g + frame;
    if (bb >= B) continue;
    auto byte_at = [&](int i) -> uint32_t {
      const int tend = offset + 8 * i + 7;   // step of the byte's last bit
      const int k = min(tend / ckpt, K - 1);
      const int wend = (k < K - 1) ? (k + 1) * ckpt - 1 : nsteps - 1;
      const uint32_t r =
          static_cast<uint32_t>(rs[static_cast<int64_t>(k) * B + bb]);
      return (r >> (wend - tend)) & 255u;
    };
    uint8_t* row = out + static_cast<int64_t>(bb) * nbytes;
    auto quad_at = [&](int q) -> uint32_t {
      return byte_at(4 * q) | (byte_at(4 * q + 1) << 8) |
             (byte_at(4 * q + 2) << 16) | (byte_at(4 * q + 3) << 24);
    };
    int q = j;
    for (; q + 4 * (kBatch - 1) < nquads; q += 4 * kBatch) {
      uint32_t word[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) word[u] = quad_at(q + 4 * u);
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        reinterpret_cast<uint32_t*>(row)[q + 4 * u] = word[u];
    }
    for (; q < nquads; q += 4)
      reinterpret_cast<uint32_t*>(row)[q] = quad_at(q);
    for (int i = 4 * nquads + j; i < nbytes; i += 4)
      row[i] = static_cast<uint8_t>(byte_at(i));
  }
}

}  // namespace

extern "C" {

// regs: [K, 64, B]; anchor, anchor_k: [B] or null; rs: [K, B]; out:
// uint8 [B, nbytes] or null (then nbytes, offset and nsteps are unused).
// segments: lanes a frame, 1 to 32, with (segments - 1) * ceil(K /
// segments) < K so that no segment is empty.
int tb_walk_launch(const void* regs, const void* anchor,
                   const void* anchor_k, int B, int K, int ckpt, int gap,
                   void* rs, void* out, int nbytes, int offset, int nsteps,
                   int segments, void* stream) {
  if (segments < 1 || segments > kMaxSegments || K < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int L = (K + segments - 1) / segments;
  if ((segments - 1) * L >= K) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((B + kFrames - 1) / kFrames), block(kFrames, segments);
  tb_walk_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(regs), static_cast<const int32_t*>(anchor),
      static_cast<const int32_t*>(anchor_k), B, K, ckpt, gap,
      static_cast<int32_t*>(rs), static_cast<uint8_t*>(out), nbytes, offset,
      nsteps, L);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
