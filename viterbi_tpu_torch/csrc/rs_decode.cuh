// Kernel I's device code: a Reed-Solomon decoder over GF(256), a template
// over the code (`Rs120`, RS(120,110) of RScheckSuperframe with the DLL's
// decoder; `Rs204`, RS(204,188) of EN 300 744 with the textbook bounded-
// distance rule), with three epilogues: whole superframes, codewords, and
// rows of packets. csrc/rs_decode.cu holds the contract and the C entry
// points; the
// syndrome form that ships (SyndMma, the tensor cores' binary product) is
// here; csrc/probes/rs_synd.cu builds the same code with the other form,
// for probes.rsform's comparison.
//
// A block of eight warps runs over a persistent grid. It fills its tables
// once, then takes a group of codewords at a time into shared memory:
//   1. staging: whole superframes as they arrive (byte-interleaved, 16-,
//      8- or 4-byte loads as the addresses allow), or codewords gathered
//      through any strides;
//   2. syndromes: a warp a tile of 16 codewords (the syndrome form, a
//      policy class: `tile` writes each codeword's ten syndromes packed
//      four to a word, a zero count, and the tile's mask of dirty ones);
//   3. the dirty codewords only, a warp each: Berlekamp-Massey, the Chien
//      search up to its deg-lambda-th root, Forney, the corrections XOR-ed
//      into the staged bytes in place;
//   4. the epilogue: for superframes the error sum (or -1) and the first
//      failed codeword reduced in shared memory, then the corrected data
//      bytes, which are the first rs_dims*110 bytes of the interleaved
//      superframe, written as they lie (zero-filled from the first failure
//      where asked); for codewords the counts and int32 codewords.

#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace rsk {

constexpr int kNN = 255;         // field elements less zero; log of zero
constexpr int kAto = 768;        // pre-reduced antilog table entries
constexpr int kTables = 1024;    // the antilog table, then index_of
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16;        // codewords a syndrome tile (an m16 tile)
constexpr int kMinCap = 128;     // codewords a block stages, at least
constexpr unsigned kFull = 0xffffffffu;

// The codes, each shortened from a code of length 255 over the field of
// x^8 + x^4 + x^3 + x^2 + 1, first root alpha^0, by kPad leading zero
// bytes. kTextbook picks the decoder's rule where it is uncorrectable:
//   false (the DLL's DECODE_RS): the Chien search over all 255 elements,
//     -1 unless its roots number deg lambda; a root inside the pad is
//     counted but changes no byte; omega's terms below deg lambda only; a
//     root whose numerator is 0 is skipped;
//   true (bounded distance): -1 where deg lambda > kNRoots / 2; the Chien
//     search over the kN sent positions only, -1 unless its roots number
//     deg lambda; every term of omega; -1 where any error value is 0.
struct Rs120 {                   // RS(120,110) of a DAB+ superframe
  static constexpr int kN = 120, kK = 110, kNRoots = 10, kPad = 135;
  static constexpr bool kTextbook = false;
  static constexpr int kMinBlocks = 4;   // 64 registers a thread
};

struct Rs204 {                   // RS(204,188) of EN 300 744 4.3.2
  static constexpr int kN = 204, kK = 188, kNRoots = 16, kPad = 51;
  static constexpr bool kTextbook = true;
  static constexpr int kMinBlocks = 2;   // 128 registers a thread
};

// What follows from a code: its syndromes packed four to a word, the
// k-steps of 256 bits that cover a codeword, a warp's scratch slots.
template <class C>
struct Shape {
  static constexpr int kSyndWords = (C::kNRoots + 3) / 4;
  static constexpr int kSteps = (8 * C::kN + 255) / 256;
  static constexpr int kSlot = C::kNRoots + 1 <= 16 ? 16 : 32;
  static constexpr int kScratch = 4 * kSlot;
};

// RS(120,110)'s constants by their old names (the probes read them)
constexpr int kN = Rs120::kN;
constexpr int kK = Rs120::kK;
constexpr int kNRoots = Rs120::kNRoots;
constexpr int kPad = Rs120::kPad;
constexpr int kMinBlocks = Rs120::kMinBlocks;
constexpr int kScratch = Shape<Rs120>::kScratch;

__device__ __forceinline__ uint32_t mod255(uint32_t x) {
  return (x * 0x1010102u) >> 24;   // rschecksf.cpp:48-52, uint32 wrap
}

// Where the staged codewords lie: codeword c's byte j at off(c) + j * sj().
// Interleaved (superframes as they arrive): superframe c / D, codeword
// c % D, byte j at j * D; rows: codeword c's kLen bytes at c * kLen.
template <bool kInter, int kLen = kN>
struct Geo {
  static constexpr bool kInterleaved = kInter;
  int D;
  __device__ __forceinline__ int off(int c) const {
    return kInter ? (c / D) * (D * kLen) + c % D : c * kLen;
  }
  __device__ __forceinline__ int sj() const { return kInter ? D : 1; }
};

// A block's shared memory, kCap codewords (a multiple of 16) of code C
// staged, at offsets fixed at compile time from the one base (so no
// pointer takes a register).
template <int kFormBytes, int kCap, class C = Rs120>
struct Smem {
  using Code = C;
  static constexpr int kWords = Shape<C>::kSyndWords;
  static constexpr int kRaw = kTables + kFormBytes;
  static constexpr int kBase = kRaw + kCap * C::kN;  // 16-byte aligned
  static constexpr int kSynd = kBase + kCap * 8;
  static constexpr int kCnt = kSynd + kCap * 4 * kWords;
  static constexpr int kAux = kCnt + kCap * 4;
  static constexpr int kMask = kAux + kCap * 4;
  static constexpr int kScr = kMask + kCap / kTile * 4;
  static constexpr int kBytes = kScr + kWarps * Shape<C>::kScratch;
  static constexpr int kCapacity = kCap;

  uint8_t* p;
  __device__ uint8_t* ato() const { return p; }            // 768 entries
  __device__ uint8_t* iof() const { return p + kAto; }     // 256 entries
  __device__ uint8_t* form() const { return p + kTables; } // the form's
  __device__ uint8_t* raw() const { return p + kRaw; }     // staged bytes
  // a codeword's first element (codewords entry)
  __device__ long long* base() const {
    return reinterpret_cast<long long*>(p + kBase);
  }
  // the syndromes packed four to a word, kWords words a codeword
  __device__ uint32_t* synd() const {
    return reinterpret_cast<uint32_t*>(p + kSynd);
  }
  __device__ int32_t* cnt() const {                        // the counts
    return reinterpret_cast<int32_t*>(p + kCnt);
  }
  // n_ok of each staged superframe (superframes entry)
  __device__ int32_t* aux() const {
    return reinterpret_cast<int32_t*>(p + kAux);
  }
  __device__ uint32_t* tmask() const {        // a tile's dirty codewords
    return reinterpret_cast<uint32_t*>(p + kMask);
  }
  __device__ uint8_t* scratch(int warp) const {
    return p + kScr + warp * Shape<C>::kScratch;
  }
  // syndrome i of staged codeword c (byte i % 4 of its word i / 4)
  __device__ uint32_t syndrome(int c, int i) const {
    return (synd()[kWords * c + (i >> 2)] >> (8 * (i & 3))) & 0xffu;
  }
};

// The tables (1024 bytes, 16-byte aligned) and the form's constants,
// once a block.
template <class Synd, class S>
__device__ void fill(const S& s, const uint8_t* tables,
                     const uint4* consts) {
  const uint4* t4 = reinterpret_cast<const uint4*>(tables);
  uint4* d4 = reinterpret_cast<uint4*>(s.ato());
  for (int i = threadIdx.x; i < kTables / 16; i += kThreads) d4[i] = t4[i];
  Synd::fill(s.form(), tables, consts);
}

// ---- the dirty path: one warp, one codeword whose syndromes are not zero
template <class S, class G>
__device__ void correct(const S& s, G geo, int c, int warp, int lane) {
  using C = typename S::Code;
  constexpr int kR = C::kNRoots;
  constexpr int kSlot = Shape<C>::kSlot;
  const uint8_t* ato = s.ato();
  const uint8_t* iof = s.iof();
  uint8_t* lgs = s.scratch(warp);               // lambda's logs, kR + 1
  uint8_t* ols = lgs + kSlot;                   // omega's logs, kR
  uint8_t* rts = lgs + 2 * kSlot;               // the roots, ascending
  uint8_t* sls = lgs + 3 * kSlot;               // the syndromes' logs, kR
  // field elements in log form (kNN for zero): a product is one lookup,
  // alpha^(log a + log b), as the reference's tables give it
  if (lane < kR) {
    const uint32_t sv = s.syndrome(c, lane);
    sls[lane] = static_cast<uint8_t>(sv ? iof[sv] : kNN);
  }
  __syncwarp();

  // Berlekamp-Massey: coefficient `lane` of lambda (as a value and a log)
  // and of b (a log)
  uint32_t lam = lane == 0 ? 1u : 0u;
  uint32_t lam_log = lane == 0 ? 0u : kNN;
  uint32_t b_log = lam_log;
  int el = 0;
#pragma unroll 1
  for (int r = 1; r <= kR; ++r) {
    // discrepancy: XOR over i < r of lambda[i] * s[r - 1 - i]
    const uint32_t sl = lane < r ? sls[r - 1 - lane] : kNN;
    const uint32_t discr = __reduce_xor_sync(
        kFull, lam_log != kNN && sl != kNN ? ato[lam_log + sl] : 0u);
    uint32_t shift_b = __shfl_up_sync(kFull, b_log, 1);   // x * b(x)
    if (lane == 0 || lane > kR) shift_b = kNN;
    if (discr) {                        // the same on every lane
      const uint32_t d_log = iof[discr];
      const bool swap = 2 * el <= r - 1;
      // b <- lambda / discr where the registers swap, else x * b
      uint32_t inv = lam_log + kNN - d_log;
      if (inv >= kNN) inv -= kNN;
      b_log = swap ? (lam_log == kNN ? kNN : inv) : shift_b;
      if (shift_b != kNN) lam ^= ato[d_log + shift_b];   // - discr x b
      lam_log = lam ? iof[lam] : kNN;
      if (swap) el = r - el;
    } else {
      b_log = shift_b;
    }
  }
  const int deg =
      31 - __clz(static_cast<int>(__ballot_sync(kFull, lam != 0)));
  if (C::kTextbook && deg > kR / 2) {        // beyond the code's reach
    if (lane == 0) s.cnt()[c] = -1;
    __syncwarp();
    return;
  }
  if (lane <= kR) lgs[lane] = static_cast<uint8_t>(lam_log);
  __syncwarp();
  uint32_t lg[kR + 1];                 // kNN for a zero coefficient
#pragma unroll
  for (int j = 0; j <= kR; ++j) lg[j] = lgs[j];

  // Chien: q(i) = XOR_j lambda[j] alpha^(i*j) at the elements first + lane
  // + 32 k, 32 a round (from alpha^1, or in the textbook rule from the
  // first sent position's), until deg roots are found (a polynomial of
  // degree deg has no more); a ballot and a prefix popcount order them
  constexpr int kFirst = C::kTextbook ? C::kPad + 1 : 1;
  constexpr int kRounds = (kNN - kFirst + 32) / 32;
  const uint32_t below = (1u << lane) - 1u;
  int count = 0;
#pragma unroll 1
  for (int k = 0; k < kRounds && count < deg; ++k) {
    const uint32_t i = kFirst + lane + 32 * k;
    uint32_t q = 1;                          // lambda[0] == 1
#pragma unroll
    for (int j = 1; j <= kR; ++j)            // i * j mod 255, exact here
      if (lg[j] != kNN) q ^= ato[lg[j] + mod255(i * j)];
    const bool root = i <= kNN && q == 0;
    const uint32_t ballot = __ballot_sync(kFull, root);
    const int slot = count + __popc(ballot & below);
    if (root && slot < kR) rts[slot] = static_cast<uint8_t>(i);
    count += __popc(ballot);
  }
  if (count != deg) {                        // uncorrectable: unchanged
    if (lane == 0) s.cnt()[c] = -1;
    __syncwarp();
    return;
  }

  // omega = s * lambda mod x^kR: coefficient `lane` (< kR)
  uint32_t om = 0;
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    if (j <= lane && lane < kR && lg[j] != kNN) {
      const uint32_t sl = sls[lane - j];
      if (sl != kNN) om ^= ato[sl + lg[j]];
    }
  }
  if (lane < kR) ols[lane] = static_cast<uint8_t>(om ? iof[om] : kNN);
  __syncwarp();                              // the roots and omega's logs

  // Forney: root `lane` (< count); its value alpha^(log num1 + log num2 +
  // 255 - log den) XOR-ed into the staged byte root - 1 - kPad
  uint32_t value = 0, at = 0;
  bool none = false;                         // a root whose num1 is 0
  if (lane < count) {
    const uint32_t root = rts[lane];
    if (root >= C::kPad + 1) {               // else inside the pad
      uint32_t num1 = 0;
#pragma unroll
      for (int i = 0; i < kR; ++i) {        // i <= deg omega
        const uint32_t o = ols[i];
        if ((C::kTextbook || i < deg) && o != kNN)
          num1 ^= ato[mod255(o + i * root)];
      }
      if (num1) {
        const uint32_t num2 = ato[kNN - root];
        uint32_t den = 0;
        const int top = (deg < kR - 1 ? deg : kR - 1) & ~1;
#pragma unroll
        for (int i = 0; i < kR; i += 2)
          if (i <= top && lg[i + 1] != kNN)
            den ^= ato[mod255(lg[i + 1] + i * root)];
        value = ato[iof[num1] + iof[num2] + (kNN - iof[den])];
        at = root - 1 - C::kPad;
      } else {
        none = true;
      }
    }
  }
  if (C::kTextbook && __ballot_sync(kFull, none)) {   // a zero value
    if (lane == 0) s.cnt()[c] = -1;
    __syncwarp();
    return;
  }
  if (value) s.raw()[geo.off(c) + at * geo.sj()] ^= value;
  if (lane == 0) s.cnt()[c] = count;
  __syncwarp();                              // before the scratch is reused
}

// ---- the syndrome form that ships: the tensor cores' binary product
// The A fragment's word: bytes j4 .. j4 + 3 of staged codeword c, byte
// j4 + q in bits 8 q .. 8 q + 7 (bit a of byte j is k = 8 j + a).
template <class S, class G>
__device__ __forceinline__ uint32_t row_word(const S& s, G geo, int c,
                                             int j4, int nc) {
  if (c >= nc || j4 >= S::Code::kN) return 0;
  const uint8_t* p = s.raw() + geo.off(c) + j4 * geo.sj();
  if (!G::kInterleaved) return *reinterpret_cast<const uint32_t*>(p);
  const int d = geo.D;
  return static_cast<uint32_t>(p[0]) | static_cast<uint32_t>(p[d]) << 8
         | static_cast<uint32_t>(p[2 * d]) << 16
         | static_cast<uint32_t>(p[3 * d]) << 24;
}

__device__ __forceinline__ void mma_and_popc(int (&acc)[4],
                                             const uint32_t (&a)[4],
                                             uint2 b) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

template <class C>
struct SyndMmaT {
  static constexpr int kR = C::kNRoots;
  static constexpr int kSteps = Shape<C>::kSteps;
  static constexpr int kWords = Shape<C>::kSyndWords;
  static constexpr int kSmem = kR * kSteps * 32 * 8;   // B's fragments

  static __device__ void fill(uint8_t* form, const uint8_t*,
                              const uint4* consts) {
    uint4* d = reinterpret_cast<uint4*>(form);
    for (int i = threadIdx.x; i < kSmem / 16; i += kThreads)
      d[i] = consts[i];
  }

  // Tile t: codewords 16 t + g and 16 t + g + 8 on lane group g = lane / 4
  // (the m16n8k256 layout: a0 / a2 rows g, a1 / a3 rows g + 8; a0, a1 k
  // = 32 tig .. +31 of the step, a2, a3 k + 128; the sum's c0, c1 row g,
  // columns 2 tig and 2 tig + 1, c2, c3 row g + 8).
  template <class S, class G>
  static __device__ void tile(const S& s, G geo, int t, int nc, int lane) {
    const int g = lane >> 2, tig = lane & 3;
    const int c0 = kTile * t + g, c1 = c0 + 8;
    uint32_t a[kSteps][4];
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int j = 32 * st + 4 * tig;
      a[st][0] = row_word(s, geo, c0, j, nc);
      a[st][1] = row_word(s, geo, c1, j, nc);
      a[st][2] = row_word(s, geo, c0, j + 16, nc);
      a[st][3] = row_word(s, geo, c1, j + 16, nc);
    }
    const uint2* frag = reinterpret_cast<const uint2*>(s.form());
    uint32_t w0[kWords], w1[kWords];                 // rows g, g + 8
#pragma unroll
    for (int k = 0; k < kWords; ++k) w0[k] = w1[k] = 0;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int st = 0; st < kSteps; ++st)
        mma_and_popc(acc, a[st], frag[(kSteps * i + st) * 32 + lane]);
      // syndrome i's bits 2 tig and 2 tig + 1, packed four syndromes a word
      const int sh = 8 * (i & 3) + 2 * tig;
      w0[i >> 2] |= ((acc[0] & 1u) | (acc[1] & 1u) << 1) << sh;
      w1[i >> 2] |= ((acc[2] & 1u) | (acc[3] & 1u) << 1) << sh;
    }
    uint32_t any0 = 0, any1 = 0;
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) {
        w0[k] |= __shfl_xor_sync(kFull, w0[k], off);
        w1[k] |= __shfl_xor_sync(kFull, w1[k], off);
      }
    }
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      any0 |= w0[k];
      any1 |= w1[k];
    }
    const bool dirty0 = c0 < nc && any0 != 0;
    const bool dirty1 = c1 < nc && any1 != 0;
    if (tig == 0 && c0 < nc) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) s.synd()[kWords * c0 + k] = w0[k];
      s.cnt()[c0] = 0;
    }
    if (tig == 1 && c1 < nc) {
#pragma unroll
      for (int k = 0; k < kWords; ++k) s.synd()[kWords * c1 + k] = w1[k];
      s.cnt()[c1] = 0;
    }
    const uint32_t ballot = __ballot_sync(
        kFull, (tig == 0 && dirty0) || (tig == 1 && dirty1));
    if (lane == 0) {
      uint32_t m = 0;                      // bit r: codeword 16 t + r
#pragma unroll
      for (int r = 0; r < 8; ++r)
        m |= ((ballot >> (4 * r)) & 1u) << r
             | ((ballot >> (4 * r + 1)) & 1u) << (r + 8);
      s.tmask()[t] = m;
    }
  }
};

using SyndMma = SyndMmaT<Rs120>;

// Step 2 on the nc staged codewords: the syndromes, a warp a tile.
template <class Synd, class S, class G>
__device__ void syndromes(const S& s, G geo, int nc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (nc + kTile - 1) / kTile;
  for (int t = warp; t < tiles; t += kWarps) Synd::tile(s, geo, t, nc, lane);
}

// Step 3: the dirty codewords in order, the r-th to warp r % kWarps;
// returns their number.
template <class S, class G>
__device__ int correct_dirty(const S& s, G geo, int nc) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tiles = (nc + kTile - 1) / kTile;
  int rank = 0;
  for (int t = 0; t < tiles; ++t) {
    uint32_t m = s.tmask()[t];
    while (m) {
      const int r = __ffs(m) - 1;
      m &= m - 1;
      if (rank++ % kWarps == warp) correct(s, geo, kTile * t + r, warp, lane);
    }
  }
  return rank;
}

template <class Synd, class S, class G>
__device__ void decode_staged(const S& s, G geo, int nc) {
  syndromes<Synd>(s, geo, nc);
  __syncthreads();
  correct_dirty(s, geo, nc);
  __syncthreads();
}

template <typename V, class S>
__device__ void stage_as(const S& s, const uint8_t* src, long long s_g,
                         int L, int ns) {
  const int per = L / static_cast<int>(sizeof(V));
  for (int idx = threadIdx.x; idx < ns * per; idx += kThreads) {
    const int f = idx / per, v = idx - f * per;
    reinterpret_cast<V*>(s.raw() + f * L)[v] =
        reinterpret_cast<const V*>(src + f * s_g)[v];
  }
}

// Step 1: ns superframes of L bytes, s_g apart from src, w bytes a load.
template <class S>
__device__ void stage_superframes(const S& s, const uint8_t* src,
                                  long long s_g, int L, int ns, int w) {
  if (w == 16) stage_as<uint4>(s, src, s_g, L, ns);
  else if (w == 8) stage_as<uint2>(s, src, s_g, L, ns);
  else if (w == 4) stage_as<uint32_t>(s, src, s_g, L, ns);
  else stage_as<uint8_t>(s, src, s_g, L, ns);
}

// Step 4a: a warp a superframe, the sum of its counts and its first
// failure (n_ok, also kept in aux for the audio).
template <class S>
__device__ void superframe_sums(const S& s, int D, int ns,
                                int32_t* errors, int32_t* n_ok) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int f = warp; f < ns; f += kWarps) {
    int sum = 0, first = D;
    for (int d0 = 0; d0 < D; d0 += 32) {
      const int d = d0 + lane;
      const int v = d < D ? s.cnt()[f * D + d] : 0;
      const uint32_t bad = __ballot_sync(kFull, v < 0);
      if (bad && first == D) first = d0 + __ffs(bad) - 1;
      sum += __reduce_add_sync(kFull, v);
    }
    if (lane == 0) {
      errors[f] = first < D ? -1 : sum;
      n_ok[f] = first;
      s.aux()[f] = first;
    }
  }
}

template <typename V, class S>
__device__ void audio_as(const S& s, uint8_t* dst, int L, int Lo, int D,
                         int ns, bool zero_after_fail) {
  constexpr int w = static_cast<int>(sizeof(V));
  const int per = Lo / w;
  for (int idx = threadIdx.x; idx < ns * per; idx += kThreads) {
    const int f = idx / per, v = idx - f * per;
    V val = reinterpret_cast<const V*>(s.raw() + f * L)[v];
    const int n_ok = s.aux()[f];
    if (zero_after_fail && n_ok < D) {
      uint8_t* b = reinterpret_cast<uint8_t*>(&val);
#pragma unroll
      for (int q = 0; q < w; ++q)
        if ((v * w + q) % D >= n_ok) b[q] = 0;   // codeword (byte % D)
    }
    reinterpret_cast<V*>(dst + static_cast<long long>(f) * Lo)[v] = val;
  }
}

// Step 4b: the audio of ns superframes, the first Lo of each one's L
// staged bytes as they lie, w bytes a store.
template <class S>
__device__ void write_audio(const S& s, uint8_t* dst, int L, int Lo, int D,
                            int ns, bool zero_after_fail, int w) {
  if (w == 16) audio_as<uint4>(s, dst, L, Lo, D, ns, zero_after_fail);
  else if (w == 8) audio_as<uint2>(s, dst, L, Lo, D, ns, zero_after_fail);
  else if (w == 4) audio_as<uint32_t>(s, dst, L, Lo, D, ns, zero_after_fail);
  else audio_as<uint8_t>(s, dst, L, Lo, D, ns, zero_after_fail);
}

__host__ __device__ inline int vec_width(unsigned long long x) {
  return (x & 15) == 0 ? 16 : (x & 7) == 0 ? 8 : (x & 3) == 0 ? 4 : 1;
}

// The widest load that every superframe's row and its staged place allow,
// and the widest store of the audio.
__device__ inline int in_width(const uint8_t* sf, long long s_g, int D) {
  return vec_width(reinterpret_cast<unsigned long long>(sf)
                   | static_cast<unsigned long long>(s_g)
                   | static_cast<unsigned long long>(D * kN));
}

__device__ inline int out_width(const uint8_t* out, int D) {
  return vec_width(reinterpret_cast<unsigned long long>(out)
                   | static_cast<unsigned long long>(D * kK)
                   | static_cast<unsigned long long>(D * kN));
}

__device__ inline uint8_t* dyn_smem() {
  extern __shared__ __align__(16) uint8_t smem[];
  return smem;
}

// Superframes: sf's row f (s_g bytes apart, D * 120 bytes each) ->
// errors[f], out[f] (D * 110 bytes), n_ok[f]; S superframes (S * D <=
// kCap codewords) a block at a time.
template <class Synd, int kCap>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rs_superframes_kernel(const uint8_t* __restrict__ sf, long long s_g, int G,
                      int D, int S, int zero_after_fail,
                      const uint8_t* __restrict__ tables,
                      const uint4* __restrict__ consts,
                      int32_t* __restrict__ errors,
                      uint8_t* __restrict__ out,
                      int32_t* __restrict__ n_ok) {
  const Smem<Synd::kSmem, kCap> s{dyn_smem()};
  fill<Synd>(s, tables, consts);
  const int L = D * kN, Lo = D * kK;
  const int w_in = in_width(sf, s_g, D), w_out = out_width(out, D);
  // (the tables are read after the staging's barrier)
  for (long long g0 = static_cast<long long>(blockIdx.x) * S; g0 < G;
       g0 += static_cast<long long>(gridDim.x) * S) {
    const int ns = G - g0 < S ? static_cast<int>(G - g0) : S;
    stage_superframes(s, sf + g0 * s_g, s_g, L, ns, w_in);
    __syncthreads();
    decode_staged<Synd>(s, Geo<true>{D}, ns * D);
    superframe_sums(s, D, ns, errors + g0, n_ok + g0);
    __syncthreads();
    write_audio(s, out + g0 * Lo, L, Lo, D, ns, zero_after_fail != 0,
                w_out);
    __syncthreads();                       // before the next staging
  }
}

// Codewords: codeword n's byte j at in + (n / Din) * s_g + (n % Din) * s_d
// + j * s_j elements -> count[n], out[n, j] (the element with its low byte
// corrected); TC codewords a block at a time.
template <class Synd, typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rs_codewords_kernel(const T* __restrict__ in, int B, int Din, long long s_g,
                    long long s_d, long long s_j, int TC,
                    const uint8_t* __restrict__ tables,
                    const uint4* __restrict__ consts,
                    int32_t* __restrict__ count, int32_t* __restrict__ out) {
  const Smem<Synd::kSmem, kMinCap> s{dyn_smem()};
  fill<Synd>(s, tables, consts);
  const Geo<false> geo{1};
  // (the tables are read after the staging's barriers)
  for (long long n0 = static_cast<long long>(blockIdx.x) * TC; n0 < B;
       n0 += static_cast<long long>(gridDim.x) * TC) {
    const int nc = B - n0 < TC ? static_cast<int>(B - n0) : TC;
    for (int c = threadIdx.x; c < nc; c += kThreads) {
      const long long n = n0 + c;
      s.base()[c] = (n / Din) * s_g + (n % Din) * s_d;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nc * kN; idx += kThreads) {
      const int c = idx / kN, j = idx - c * kN;
      s.raw()[idx] = static_cast<uint8_t>(in[s.base()[c] + j * s_j]);
    }
    __syncthreads();
    decode_staged<Synd>(s, geo, nc);
    for (int c = threadIdx.x; c < nc; c += kThreads)
      count[n0 + c] = s.cnt()[c];
    const uint32_t* raw4 = reinterpret_cast<const uint32_t*>(s.raw());
    int4* dst = reinterpret_cast<int4*>(out + n0 * kN);
    for (int idx = threadIdx.x; idx < nc * (kN / 4); idx += kThreads) {
      const uint32_t wd = raw4[idx];
      int4 v = make_int4(wd & 0xff, (wd >> 8) & 0xff, (wd >> 16) & 0xff,
                         wd >> 24);
      if constexpr (sizeof(T) == 4) {       // keep the bits above the byte
        const int c = idx / (kN / 4), j = 4 * (idx - c * (kN / 4));
        const T* e = in + s.base()[c] + j * s_j;
        v.x |= e[0] & ~0xff;
        v.y |= e[s_j] & ~0xff;
        v.z |= e[2 * s_j] & ~0xff;
        v.w |= e[3 * s_j] & ~0xff;
      }
      dst[idx] = v;
    }
    __syncthreads();                       // before the next staging
  }
}

// Blocks an SM for a kernel at `smem` bytes, cached (the last size asked).
template <typename K>
int occupancy(K kernel, size_t smem) {
  static std::atomic<long long> cached{-1};
  const long long c = cached.load(std::memory_order_relaxed);
  if (c >= 0 && (c >> 8) == static_cast<long long>(smem))
    return static_cast<int>(c & 0xff);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return -static_cast<int>(e);
  }
  int occ = 0;
  const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, kernel, kThreads, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cached.store((static_cast<long long>(smem) << 8) | (occ & 0xff),
               std::memory_order_relaxed);
  return occ;
}

// A superframes launch's shape for a kernel of kCap codewords: S
// superframes a block at a time, as many as spread the batch over the
// resident blocks in one wave and as many as its shared memory holds at
// most; the grid, at most the resident blocks. 0 or a CUDA error.
template <int kCap, typename K>
int plan_superframes(K kernel, size_t smem, int G, int D, int sms, int* S,
                     int* grid) {
  const int occ = occupancy(kernel, smem);
  if (occ < 0) return -occ;
  if (occ == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long resident = static_cast<long long>(sms) * occ;
  long long s = (G + resident - 1) / resident;
  if (s > kCap / D) s = kCap / D;
  const long long iters = (G + s - 1) / s;
  *S = static_cast<int>(s);
  *grid = static_cast<int>(iters < resident ? iters : resident);
  return 0;
}

template <class Synd, int kCap>
int superframes_launch_cap(const void* sf, long long s_g, int G, int D,
                           int zero_after_fail, const void* tables,
                           const void* consts, void* errors, void* out,
                           void* n_ok, int sms, void* stream) {
  constexpr size_t smem = Smem<Synd::kSmem, kCap>::kBytes;
  const auto kernel = rs_superframes_kernel<Synd, kCap>;
  int S = 0, grid = 0;
  const int err = plan_superframes<kCap>(kernel, smem, G, D, sms, &S, &grid);
  if (err) return err;
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sf), s_g, G, D, S,
      zero_after_fail, static_cast<const uint8_t*>(tables),
      static_cast<const uint4*>(consts), static_cast<int32_t*>(errors),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(n_ok));
  return static_cast<int>(cudaGetLastError());
}

// A superframe of up to kMinCap codewords fits the blocks that four share
// an SM; up to kMaxCap (a superframe of 120 KB) one block an SM.
constexpr int kMaxCap = 1024;

template <class Synd>
int superframes_launch(const void* sf, long long s_g, int G, int D,
                       int zero_after_fail, const void* tables,
                       const void* consts, void* errors, void* out,
                       void* n_ok, int sms, void* stream) {
  if (D <= 0 || D > kMaxCap || G < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (G == 0) return 0;
  return D <= kMinCap
      ? superframes_launch_cap<Synd, kMinCap>(sf, s_g, G, D, zero_after_fail,
                                              tables, consts, errors, out,
                                              n_ok, sms, stream)
      : superframes_launch_cap<Synd, kMaxCap>(sf, s_g, G, D, zero_after_fail,
                                              tables, consts, errors, out,
                                              n_ok, sms, stream);
}

template <class Synd>
int codewords_launch(const void* in, int elem_bytes, int B, int Din,
                     long long s_g, long long s_d, long long s_j,
                     const void* tables, const void* consts, void* count,
                     void* out, int sms, void* stream) {
  if (B < 0 || Din <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  constexpr int cap = kMinCap;
  constexpr size_t smem = Smem<Synd::kSmem, cap>::kBytes;
  const auto st = static_cast<cudaStream_t>(stream);
  const auto tab = static_cast<const uint8_t*>(tables);
  const auto con = static_cast<const uint4*>(consts);
  auto launch = [&](auto kernel, const auto* src) {
    const int occ = occupancy(kernel, smem);
    if (occ < 0) return -occ;
    if (occ == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    // codewords a block at a time: a multiple of 16 that spreads the batch
    // over the resident blocks, within the staged capacity
    const long long resident = static_cast<long long>(sms) * occ;
    long long TC = (B + resident - 1) / resident;
    TC = (TC + kTile - 1) / kTile * kTile;
    if (TC > cap) TC = cap;
    const long long iters = (B + TC - 1) / TC;
    const int grid = static_cast<int>(iters < resident ? iters : resident);
    kernel<<<grid, kThreads, smem, st>>>(
        src, B, Din, s_g, s_d, s_j, static_cast<int>(TC), tab, con,
        static_cast<int32_t*>(count), static_cast<int32_t*>(out));
    return static_cast<int>(cudaGetLastError());
  };
  if (elem_bytes == 1)
    return launch(rs_codewords_kernel<Synd, uint8_t>,
                  static_cast<const uint8_t*>(in));
  if (elem_bytes == 4)
    return launch(rs_codewords_kernel<Synd, int32_t>,
                  static_cast<const int32_t*>(in));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Packets: codeword r of code C at in + r * s_g (kN bytes, contiguous) ->
// count[r], out[r] (its kK data bytes as decoded, as received where the
// count is -1); TC codewords a block at a time.
template <class Synd, class C, int kCap>
__global__ void __launch_bounds__(kThreads, C::kMinBlocks)
rs_packets_kernel(const uint8_t* __restrict__ in, long long s_g, int B,
                  int TC, const uint8_t* __restrict__ tables,
                  const uint4* __restrict__ consts,
                  int32_t* __restrict__ count, uint8_t* __restrict__ out) {
  const Smem<Synd::kSmem, kCap, C> s{dyn_smem()};
  fill<Synd>(s, tables, consts);
  const Geo<false, C::kN> geo{1};
  const int w_in = vec_width(reinterpret_cast<unsigned long long>(in)
                             | static_cast<unsigned long long>(s_g)
                             | static_cast<unsigned long long>(C::kN));
  const int w_out = vec_width(reinterpret_cast<unsigned long long>(out)
                              | static_cast<unsigned long long>(C::kK)
                              | static_cast<unsigned long long>(C::kN));
  // (the tables are read after the staging's barrier)
  for (long long n0 = static_cast<long long>(blockIdx.x) * TC; n0 < B;
       n0 += static_cast<long long>(gridDim.x) * TC) {
    const int nc = B - n0 < TC ? static_cast<int>(B - n0) : TC;
    stage_superframes(s, in + n0 * s_g, s_g, C::kN, nc, w_in);
    __syncthreads();
    decode_staged<Synd>(s, geo, nc);
    for (int c = threadIdx.x; c < nc; c += kThreads)
      count[n0 + c] = s.cnt()[c];
    write_audio(s, out + n0 * C::kK, C::kN, C::kK, 1, nc, false, w_out);
    __syncthreads();                       // before the next staging
  }
}

template <class Synd, class C>
int packets_launch(const void* in, long long s_g, int B, const void* tables,
                   const void* consts, void* count, void* out, int sms,
                   void* stream) {
  if (B < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return 0;
  constexpr int cap = kMinCap;
  constexpr size_t smem = Smem<Synd::kSmem, cap, C>::kBytes;
  const auto kernel = rs_packets_kernel<Synd, C, cap>;
  const int occ = occupancy(kernel, smem);
  if (occ < 0) return -occ;
  if (occ == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  // codewords a block at a time: a multiple of 16 that spreads the batch
  // over the resident blocks, within the staged capacity
  const long long resident = static_cast<long long>(sms) * occ;
  long long TC = (B + resident - 1) / resident;
  TC = (TC + kTile - 1) / kTile * kTile;
  if (TC > cap) TC = cap;
  const long long iters = (B + TC - 1) / TC;
  const int grid = static_cast<int>(iters < resident ? iters : resident);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), s_g, B, static_cast<int>(TC),
      static_cast<const uint8_t*>(tables), static_cast<const uint4*>(consts),
      static_cast<int32_t*>(count), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rsk
