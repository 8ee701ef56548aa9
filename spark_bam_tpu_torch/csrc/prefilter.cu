// Stage-0 funnel: the fixed-36-byte-block subset of the 19 flag bits at
// every byte offset of a window.
//
// Replaces the Pallas kernel spark_bam_tpu/tpu/pallas_kernels.py::
// prefilter_check_flags (_prefilter_flags_kernel). The plain version is
// spark_bam_tpu_torch/tpu/kernels.py::_prefilter_flags.
//
// What bounds it on the H100: bytes. It reads each window byte once (plus
// the 36-byte tail) and writes one int32 per offset, so at the main path's
// W = 2^25 it moves ~33.6 MB in and 134 MB out: ~50 us at 3.35 TB/s. The
// arithmetic is a few dozen integer operations per offset.
// Design: one thread per offset, reading its 36 fixed bytes straight from
// global memory as the nine aligned 32-bit words that cover them; each
// little-endian field is one funnel shift of two neighbouring words. A
// warp's 32 offsets share most of their words, so the loads hit L1 and
// each window byte comes from device memory once. The contig lengths are
// read with a direct indexed load (the gather Mosaic could not lower, which
// forced the TPU kernel's scalar loop over the table). Writes are coalesced.
//
// Trouble spots, each as in the reference: the implied record size wraps
// like a JVM int32 (computed in uint32, then cast), seq_len + 1 divides
// with truncation toward zero, the contig bound is a strict '>', and
// tooFewFixedBlockBytes overwrites (does not OR) the other bits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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
constexpr int32_t kNoReadName = 1 << 12;
constexpr int32_t kEmptyReadName = 1 << 13;
constexpr int32_t kTooFewRemainingBytesImplied = 1 << 18;

__device__ __forceinline__ int32_t ref_bits(int32_t idx, int32_t pos, int c,
                                            int32_t len_at, int32_t b_neg_idx,
                                            int32_t b_large_idx,
                                            int32_t b_neg_pos,
                                            int32_t b_large_pos) {
  bool neg_idx = idx < -1;
  bool large_idx = !neg_idx && idx >= c;
  bool neg_pos = pos < -1;
  bool large_pos = !neg_idx && !large_idx && !neg_pos && idx >= 0 &&
                   pos > len_at;
  return (neg_idx ? b_neg_idx : 0) | (large_idx ? b_large_idx : 0) |
         (neg_pos ? b_neg_pos : 0) | (large_pos ? b_large_pos : 0);
}

// ``words`` is the 4-byte-aligned window; every offset below ``w`` has its
// 36 bytes (and the word that ends them) inside the padded buffer.
__global__ void prefilter_kernel(const uint32_t* __restrict__ words, int w,
                                 const int32_t* __restrict__ lengths,
                                 int cmax, int num_contigs, int n,
                                 int32_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= w) return;
  const uint32_t* q = words + (i >> 2);
  const uint32_t s = 8u * (uint32_t)(i & 3);
  uint32_t v[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) v[k] = __ldg(q + k);
  // The little-endian u32 at byte 4k of the record: bytes i+4k .. i+4k+3.
#define FIELD(k) __funnelshift_r(v[k], v[(k) + 1], s)
  int32_t remaining = (int32_t)FIELD(0);
  int32_t ref_idx = (int32_t)FIELD(1);
  int32_t ref_pos = (int32_t)FIELD(2);
  uint32_t name_len = FIELD(3) & 0xFFu;
  uint32_t n_cigar = FIELD(4) & 0xFFFFu;
  int32_t seq_len = (int32_t)FIELD(5);
  int32_t next_ref_idx = (int32_t)FIELD(6);
  int32_t next_ref_pos = (int32_t)FIELD(7);
#undef FIELD

  int32_t len_r = lengths[min(max(ref_idx, 0), cmax - 1)];
  int32_t len_n = lengths[min(max(next_ref_idx, 0), cmax - 1)];
  int32_t f = ref_bits(ref_idx, ref_pos, num_contigs, len_r,
                       kNegativeReadIdx, kTooLargeReadIdx, kNegativeReadPos,
                       kTooLargeReadPos);
  f |= ref_bits(next_ref_idx, next_ref_pos, num_contigs, len_n,
                kNegativeNextReadIdx, kTooLargeNextReadIdx,
                kNegativeNextReadPos, kTooLargeNextReadPos);
  int32_t t = (int32_t)((uint32_t)seq_len + 1u);
  int32_t half = t / 2;  // C++ division truncates toward zero
  int32_t rhs = (int32_t)(32u + name_len + 4u * n_cigar + (uint32_t)half +
                          (uint32_t)seq_len);
  if (remaining < rhs) f |= kTooFewRemainingBytesImplied;
  if (name_len == 0) f |= kNoReadName;
  if (name_len == 1) f |= kEmptyReadName;
  if (i > n - 36) f = kTooFewFixedBlockBytes;
  out[i] = f;
}

}  // namespace

extern "C" int sbt_prefilter(const uint8_t* padded, int w,
                             const int32_t* lengths, int cmax,
                             int num_contigs, int n, int32_t* out,
                             cudaStream_t stream) {
  if (w > 0) {
    prefilter_kernel<<<(w + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
        reinterpret_cast<const uint32_t*>(padded), w, lengths, cmax,
        num_contigs, n, out);
  }
  return (int)cudaGetLastError();
}
