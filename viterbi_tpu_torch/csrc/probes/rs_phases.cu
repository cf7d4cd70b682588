// Probe: where kernel I's time goes. Its superframes entry
// (csrc/rs_decode.cuh, the tensor-core syndromes), the same steps in the
// same order as rs_superframes_kernel, with thread 0 of each block taking
// the card's clock (%globaltimer, ns) after each step: start, the tables
// and the staging, the syndromes, the dirty codewords, the sums, the
// audio; and the number of dirty codewords the block corrected. Each
// block takes one group of superframes (the batch must fit one wave).
// probes.rsphases reads it. Not on any decode path.
//
// Replaces nothing of the JAX package: it times kernel I, whose function
// is viterbi_tpu/ops/rs.py:300 (rs_check_superframe) over a batch.

#include "../rs_decode.cuh"

namespace {

constexpr int kStamps = 8;   // a block's: six times, its dirty codewords

__device__ __forceinline__ long long clock_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int kCap>
__global__ void __launch_bounds__(rsk::kThreads, rsk::kMinBlocks)
rs_phases_kernel(const uint8_t* __restrict__ sf, long long s_g, int G, int D,
                 int S, const uint8_t* __restrict__ tables,
                 const uint4* __restrict__ consts,
                 int32_t* __restrict__ errors, uint8_t* __restrict__ out,
                 int32_t* __restrict__ n_ok, long long* __restrict__ stamps) {
  using rsk::kK;
  using rsk::kN;
  const rsk::Smem<rsk::SyndMma::kSmem, kCap> s{rsk::dyn_smem()};
  long long* st = stamps + blockIdx.x * kStamps;
  const bool clock = threadIdx.x == 0;
  if (clock) st[0] = clock_ns();
  rsk::fill<rsk::SyndMma>(s, tables, consts);
  const int L = D * kN, Lo = D * kK;
  const long long g0 = static_cast<long long>(blockIdx.x) * S;
  if (g0 >= G) return;
  const int ns = G - g0 < S ? static_cast<int>(G - g0) : S;
  const rsk::Geo<true> geo{D};
  rsk::stage_superframes(s, sf + g0 * s_g, s_g, L, ns,
                         rsk::in_width(sf, s_g, D));
  __syncthreads();
  if (clock) st[1] = clock_ns();
  rsk::syndromes<rsk::SyndMma>(s, geo, ns * D);
  __syncthreads();
  if (clock) st[2] = clock_ns();
  const int dirty = rsk::correct_dirty(s, geo, ns * D);
  __syncthreads();
  if (clock) st[3] = clock_ns();
  rsk::superframe_sums(s, D, ns, errors + g0, n_ok + g0);
  __syncthreads();
  if (clock) st[4] = clock_ns();
  rsk::write_audio(s, out + g0 * Lo, L, Lo, D, ns, false,
                   rsk::out_width(out, D));
  __syncthreads();
  if (clock) {
    st[5] = clock_ns();
    st[7] = dirty;
  }
}

}  // namespace

extern "C" {

// As rs_superframes_launch (no zero fill, at most 128 codewords a
// superframe), and stamps: int64[grid * 8]; shape: two host ints, the
// grid and the superframes a block, written before the launch. Fails
// unless the batch fits one wave of blocks.
int rs_phases_launch(const void* sf, long long s_g, int G, int D,
                     const void* tables, const void* consts, void* errors,
                     void* out, void* n_ok, void* stamps, void* shape,
                     int sms, void* stream) {
  constexpr int kCap = rsk::kMinCap;
  if (G <= 0 || D <= 0 || D > kCap)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = rsk::Smem<rsk::SyndMma::kSmem, kCap>::kBytes;
  const auto kernel = rs_phases_kernel<kCap>;
  int S = 0, grid = 0;
  const int err = rsk::plan_superframes<kCap>(kernel, smem, G, D, sms, &S,
                                              &grid);
  if (err) return err;
  if (static_cast<long long>(grid) * S < G)
    return static_cast<int>(cudaErrorInvalidValue);
  static_cast<int*>(shape)[0] = grid;
  static_cast<int*>(shape)[1] = S;
  kernel<<<grid, rsk::kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sf), s_g, G, D, S,
      static_cast<const uint8_t*>(tables), static_cast<const uint4*>(consts),
      static_cast<int32_t*>(errors), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(n_ok), static_cast<long long*>(stamps));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
