// The 19-bit flag layout and the fixed-36-byte-block checks, shared by the
// stage-0 prefilter (prefilter.cu) and the full pass (full_flags.cu).
//
// Each check is as in the reference: the implied record size wraps like a
// JVM int32 (computed in uint32, then cast), seq_len + 1 divides with
// truncation toward zero, the contig bound is a strict '>', and the contig
// length is a clamped indexed load (made only where it decides a bit).

#pragma once

#include <cstdint>

namespace sbt {

// Bit layout of spark_bam_tpu_torch/check/flags.py.
constexpr int32_t kTooFewFixedBlockBytes = 1 << 0;
constexpr int32_t kNegativeReadIdx = 1 << 1;
constexpr int32_t kTooLargeReadIdx = 1 << 2;
constexpr int32_t kNegativeReadPos = 1 << 3;
constexpr int32_t kTooLargeReadPos = 1 << 4;
constexpr int32_t kNegativeNextReadIdx = 1 << 5;
constexpr int32_t kTooLargeNextReadIdx = 1 << 6;
constexpr int32_t kNegativeNextReadPos = 1 << 7;
constexpr int32_t kTooLargeNextReadPos = 1 << 8;
constexpr int32_t kTooFewBytesForReadName = 1 << 9;
constexpr int32_t kNonNullTerminatedReadName = 1 << 10;
constexpr int32_t kNonASCIIReadName = 1 << 11;
constexpr int32_t kNoReadName = 1 << 12;
constexpr int32_t kEmptyReadName = 1 << 13;
constexpr int32_t kTooFewBytesForCigarOps = 1 << 14;
constexpr int32_t kInvalidCigarOp = 1 << 15;
constexpr int32_t kEmptyMappedCigar = 1 << 16;
constexpr int32_t kEmptyMappedSeq = 1 << 17;
constexpr int32_t kTooFewRemainingBytesImplied = 1 << 18;

// The fields of the 36-byte fixed block of the record at one offset.
struct FixedBlock {
  int32_t remaining, ref_idx, ref_pos, seq_len, next_ref_idx, next_ref_pos;
  uint32_t name_len, n_cigar, flag;
};

// ``v`` holds the nine aligned 32-bit words that cover the block's bytes,
// starting at the word that holds its first byte; ``s`` is 8 times the
// byte offset of the block inside that word. Each little-endian field is
// one funnel shift of two neighbouring words.
__device__ __forceinline__ FixedBlock fixed_block(const uint32_t v[9],
                                                  uint32_t s) {
#define SBT_FIELD(k) __funnelshift_r(v[k], v[(k) + 1], s)
  FixedBlock b;
  b.remaining = (int32_t)SBT_FIELD(0);
  b.ref_idx = (int32_t)SBT_FIELD(1);
  b.ref_pos = (int32_t)SBT_FIELD(2);
  b.name_len = SBT_FIELD(3) & 0xFFu;
  uint32_t fnc = SBT_FIELD(4);
  b.n_cigar = fnc & 0xFFFFu;
  b.flag = fnc >> 16;
  b.seq_len = (int32_t)SBT_FIELD(5);
  b.next_ref_idx = (int32_t)SBT_FIELD(6);
  b.next_ref_pos = (int32_t)SBT_FIELD(7);
#undef SBT_FIELD
  return b;
}

// The contig bits of one (index, position) pair, for ``c`` >= 0 contigs:
// then an index >= c is never also < -1, and one in [0, c) is neither, so
// the reference's chain of exclusions reduces to these compares.
// ``len_at`` is read only where it counts: ``len_of(idx)`` runs for an
// index in [0, c) alone, so most offsets (random bytes) load nothing.
template <class LenOf>
__device__ __forceinline__ int32_t ref_bits(int32_t idx, int32_t pos, int c,
                                            LenOf len_of, int32_t b_neg_idx,
                                            int32_t b_large_idx,
                                            int32_t b_neg_pos,
                                            int32_t b_large_pos) {
  const bool in_table = (uint32_t)idx < (uint32_t)c;
  const bool large_pos = in_table && pos >= -1 && pos > len_of(idx);
  return (idx < -1 ? b_neg_idx : 0) | (idx >= c ? b_large_idx : 0) |
         (pos < -1 ? b_neg_pos : 0) | (large_pos ? b_large_pos : 0);
}

// The bits the fixed block alone decides, before the tooFewFixedBlockBytes
// overwrite (which the caller applies: it replaces every other bit).
// ``num_contigs`` >= 0 (the wrappers check); an index past the table
// (num_contigs > cmax) reads its last entry, as the reference's clamped
// take does.
__device__ __forceinline__ int32_t fixed_bits(const FixedBlock& b,
                                              const int32_t* __restrict__ lengths,
                                              int cmax, int num_contigs) {
  const auto len_of = [&](int32_t idx) {
    return __ldg(lengths + min(idx, cmax - 1));
  };
  int32_t f = ref_bits(b.ref_idx, b.ref_pos, num_contigs, len_of,
                       kNegativeReadIdx, kTooLargeReadIdx, kNegativeReadPos,
                       kTooLargeReadPos);
  f |= ref_bits(b.next_ref_idx, b.next_ref_pos, num_contigs, len_of,
                kNegativeNextReadIdx, kTooLargeNextReadIdx,
                kNegativeNextReadPos, kTooLargeNextReadPos);
  int32_t t = (int32_t)((uint32_t)b.seq_len + 1u);
  int32_t half = t / 2;  // C++ division truncates toward zero
  int32_t rhs = (int32_t)(32u + b.name_len + 4u * b.n_cigar + (uint32_t)half +
                          (uint32_t)b.seq_len);
  if (b.remaining < rhs) f |= kTooFewRemainingBytesImplied;
  if (b.name_len == 0) f |= kNoReadName;
  if (b.name_len == 1) f |= kEmptyReadName;
  return f;
}

}  // namespace sbt
