// Probe: kernel I (csrc/rs_decode.cuh) with the other syndrome form, the
// table form, for probes.rsform's comparison of the two. Not on any
// decode path.
//
// Replaces nothing of the JAX package: it is kernel I's own alternative
// (viterbi_tpu/ops/rs.py:166 computes its syndromes as a GF(2) product).
//
// Syndromes through the reference's tables: a warp a codeword, four bytes
// a lane (j = lane + 32 k), per byte a log lookup, then for each of the
// ten syndromes an exponent add, an antilog lookup and an XOR into ten
// partial syndromes packed four to a word, XOR-reduced by 15 shuffles.
// The lookups' addresses depend on the data, so the tables are laid out
// against bank conflicts: every lane has its own copy, entry e of lane l's
// copy in byte e % 4 of word (e / 4) * 32 + l, so a lane only ever reads
// bank l (1024 entries x 32 copies = 32 KB a block).
//
// Entry points: as rs_superframes_launch and rs_decode_launch of
// csrc/rs_decode.cu (consts is not read).

#include "../rs_decode.cuh"

namespace {

using rsk::Geo;
using rsk::kFull;
using rsk::kN;
using rsk::kNN;
using rsk::kNRoots;
using rsk::kTables;
using rsk::kTile;

struct SyndTable {
  static constexpr int kSmem = kTables * 32;

  static __device__ void fill(uint8_t* form, const uint8_t* tables,
                              const uint4*) {
    uint32_t* rep = reinterpret_cast<uint32_t*>(form);
    for (int i = threadIdx.x; i < kTables / 4 * 32; i += rsk::kThreads) {
      const int e = 4 * (i >> 5);
      rep[i] = static_cast<uint32_t>(tables[e])
               | static_cast<uint32_t>(tables[e + 1]) << 8
               | static_cast<uint32_t>(tables[e + 2]) << 16
               | static_cast<uint32_t>(tables[e + 3]) << 24;
    }
  }

  // entry e of the tables (the antilog table, then index_of at 768)
  static __device__ __forceinline__ uint32_t look(const uint32_t* rep,
                                                  uint32_t e, int lane) {
    return (rep[(e >> 2) * 32 + lane] >> (8 * (e & 3))) & 0xffu;
  }

  template <class S, bool kInter>
  static __device__ void tile(const S& s, Geo<kInter> geo, int t, int nc,
                              int lane) {
    const uint32_t* rep = reinterpret_cast<const uint32_t*>(s.form());
    uint32_t m = 0;
    for (int r = 0; r < kTile; ++r) {
      const int c = kTile * t + r;
      if (c >= nc) break;                 // warp-uniform
      const uint8_t* cw = s.raw() + geo.off(c);
      uint32_t w[3] = {0, 0, 0};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = lane + 32 * k;
        const uint32_t v = j < kN ? cw[j * geo.sj()] : 0u;
        if (v) {
          const uint32_t lg = look(rep, rsk::kAto + v, lane);
          const uint32_t step = kN - 1 - j;     // (119 - j) < 255
          uint32_t e = 0;                       // i * (119 - j) mod 255
#pragma unroll
          for (int i = 0; i < kNRoots; ++i) {
            w[i >> 2] ^= look(rep, lg + e, lane) << (8 * (i & 3));
            e += step;
            if (e >= kNN) e -= kNN;
          }
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int q = 0; q < 3; ++q) w[q] ^= __shfl_xor_sync(kFull, w[q], off);
      }
      if (lane == 0) {
        s.synd()[3 * c] = w[0];
        s.synd()[3 * c + 1] = w[1];
        s.synd()[3 * c + 2] = w[2];
        s.cnt()[c] = 0;
      }
      m |= static_cast<uint32_t>((w[0] | w[1] | w[2]) != 0) << r;
    }
    if (lane == 0) s.tmask()[t] = m;
  }
};

}  // namespace

extern "C" {

int rs_table_superframes_launch(const void* sf, long long s_g, int G, int D,
                                int zero_after_fail, const void* tables,
                                const void* consts, void* errors, void* out,
                                void* n_ok, int sms, void* stream) {
  return rsk::superframes_launch<SyndTable>(sf, s_g, G, D, zero_after_fail,
                                            tables, consts, errors, out,
                                            n_ok, sms, stream);
}

int rs_table_decode_launch(const void* in, int elem_bytes, int B, int D,
                           long long s_g, long long s_d, long long s_j,
                           const void* tables, const void* consts,
                           void* count, void* out, int sms, void* stream) {
  return rsk::codewords_launch<SyndTable>(in, elem_bytes, B, D, s_g, s_d,
                                          s_j, tables, consts, count, out,
                                          sms, stream);
}

}  // extern "C"
