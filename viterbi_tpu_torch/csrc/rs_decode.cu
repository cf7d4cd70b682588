// Kernel I: the RS(120,110) decoder of RScheckSuperframe, one launch for
// a batch of superframes (the DAB+ chain's RS stage, the export) or of
// codewords; and the same device code instantiated for RS(204,188), the
// outer code of an MPEG-2 transport stream in a DAB stream-mode
// subchannel (the T-DMB chain's RS stage), one launch for a batch of
// 204-byte packets.
//
// Replaces viterbi_tpu/ops/rs.py:166 (rs_decode_blocks) and :300
// (rs_check_superframe), jitted XLA functions (the chip runs each as one
// compiled program), not Pallas kernels.
//
// Contract (bit-identical to the plain versions in
// viterbi_tpu_torch.ops.rs, rs_decode_blocks_plain and
// rs_check_superframes_plain, and to the scalar DECODE_RS of
// rschecksf.cpp:198-377, golden.rs_decode_codeword): per codeword of 120
// bytes, the ten syndromes s_i = XOR_j data[j] * alpha^(i*(119-j)); where
// all are zero the count is 0 and the codeword unchanged. Otherwise
// Berlekamp-Massey over ten rounds gives lambda; the Chien search over
// the field elements in ascending order gives its roots; the count is -1
// (codeword unchanged) where their number is not deg lambda. Else omega =
// s * lambda mod x^10, and at each root whose position lies past the
// shortening pad (root >= 136) and whose numerator num1 is not zero,
// Forney's value alpha^(log num1 + log num2 + 255 - log den) is XOR-ed into
// byte root - 136; the count is the number of roots, those in the pad
// included. Where the reference reduces an exponent it uses Mod255's
// uint32 wrap, (x * 0x1010102) >> 24 on 32 bits; so does this kernel. The
// field goes through the reference's tables (constants.gf256_tables: the
// 768-entry pre-reduced antilog table and index_of), which the wrapper
// hands over and each block copies into shared memory once.
//
// RS(204,188) (rs_packets_launch; ETSI EN 300 744 4.3.2, shortened from
// RS(255,239) by 51 leading zero bytes, the same field, sixteen roots from
// alpha^0) follows the textbook bounded-distance rule, not the DLL's: the
// sixteen syndromes, where all are zero the count is 0; Berlekamp-Massey
// gives lambda of degree nu, -1 where nu > 8; the Chien search over the
// 204 sent positions only (roots alpha^52 .. alpha^255), -1 unless they
// number nu; omega = s * lambda mod x^16 in full; Forney's value at every
// root, -1 where any is zero; else the values XOR-ed in and the count nu.
// A -1 codeword comes back as received. The syndromes are the same
// tensor-core product, 1632 x 128 a codeword in seven k-steps of 256.
//
// Three entries, one device code (rs_decode.cuh):
//   rs_superframes_launch: uint8 superframes [G, D * 120], byte-
//     interleaved as they arrive, rows s_g bytes apart -> errors int32[G]
//     (the sum of the counts, -1 if any codeword fails), out uint8[G, D *
//     110] (the corrected data bytes, interleaved; with zero_after_fail
//     zero from the first failed codeword on, as the export returns them),
//     n_ok int32[G] (the first failed codeword, else D);
//   rs_decode_launch: uint8 or int32 elements, codeword n's byte j at
//     (n / D) * s_g + (n % D) * s_d + j * s_j elements -> count int32[B],
//     corrected int32[B, 120] (the element XOR the correction; the
//     syndromes read each element's low byte);
//   rs_packets_launch: RS(204,188) codewords, uint8 rows of 204 bytes s_g
//     bytes apart -> count int32[B], out uint8[B, 188] (each codeword's
//     data as decoded, as received where the count is -1).
//
// What bounds it: on the mixes a receiver sees (most codewords clean) the
// bytes, 230 a codeword with uint8 in and out (120 read, 110 written), and
// the syndromes' 960 x 80 GF(2) product; a dirty codeword adds
// Berlekamp-Massey's 990 operations and a Chien search of 3 a term at
// each element visited up to the deg-lambda-th root. Design: a block
// stages whole superframes with vector loads (no copy or widening before
// the launch), takes the syndromes of 16 codewords a warp as a binary
// tensor-core product (below), gives each dirty codeword a warp of its own
// (so the dirty path's registers do not set the clean path's occupancy:
// at most 64 a thread, four blocks of 256 an SM), and writes the audio
// from shared memory as it lies, the counts reduced there.
//
// Syndromes (SyndMma in rs_decode.cuh):
// mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc. A codeword's
// 120 bytes are one row of 960 bits (bit a of byte j at k = 8 j + a),
// padded to 1024; the parity matrix ops.rs._SYND_M [960, 80] is B, column
// (i, b) = syndrome i's bit b. A warp takes 16 codewords (the m tile) in
// four k-steps of 256 bits and ten n-tiles of 8 columns, one a syndrome;
// bit 0 of each AND-popcount sum is one syndrome bit. B's fragments are
// laid out on the host (ops.rs._SYND_FRAGMENTS_NP, [10 n-tiles][4
// k-steps][32 lanes] pairs of words), copied to shared memory once a
// block. The table form (a log lookup a byte, then ten antilog lookups,
// from tables with a copy a lane) is the probe csrc/probes/rs_synd.cu,
// timed beside this one by probes.rsform.

#include "rs_decode.cuh"

extern "C" {

// sf: uint8 superframes, row f at sf + f * s_g bytes, D * 120 bytes each;
// tables: the 768-entry antilog table, then index_of (16-byte aligned);
// consts: B's fragments; errors, n_ok: int32[G]; out: uint8[G, D * 110].
// sms: the card's SMs (the grid is those times the resident blocks).
int rs_superframes_launch(const void* sf, long long s_g, int G, int D,
                          int zero_after_fail, const void* tables,
                          const void* consts, void* errors, void* out,
                          void* n_ok, int sms, void* stream) {
  return rsk::superframes_launch<rsk::SyndMma>(
      sf, s_g, G, D, zero_after_fail, tables, consts, errors, out, n_ok, sms,
      stream);
}

// in: codeword n's byte j at in + (n / D) * s_g + (n % D) * s_d + j * s_j
// elements of 1 byte (elem_bytes 1, unsigned) or 4 (int32); count:
// int32[B]; out: int32[B, 120].
int rs_decode_launch(const void* in, int elem_bytes, int B, int D,
                     long long s_g, long long s_d, long long s_j,
                     const void* tables, const void* consts, void* count,
                     void* out, int sms, void* stream) {
  return rsk::codewords_launch<rsk::SyndMma>(
      in, elem_bytes, B, D, s_g, s_d, s_j, tables, consts, count, out, sms,
      stream);
}

// in: RS(204,188) codeword r at in + r * s_g bytes (204 contiguous bytes);
// tables: as above; consts: B's fragments of the 1632 x 128 product;
// count: int32[B]; out: uint8[B, 188].
int rs_packets_launch(const void* in, long long s_g, int B,
                      const void* tables, const void* consts, void* count,
                      void* out, int sms, void* stream) {
  return rsk::packets_launch<rsk::SyndMmaT<rsk::Rs204>, rsk::Rs204>(
      in, s_g, B, tables, consts, count, out, sms, stream);
}

}  // extern "C"
