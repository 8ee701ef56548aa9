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
// Trouble spots, each as in the reference (the fixed-block checks live in
// flag_bits.cuh, shared with the full pass): the implied record size wraps
// like a JVM int32 (computed in uint32, then cast), seq_len + 1 divides
// with truncation toward zero, the contig bound is a strict '>', and
// tooFewFixedBlockBytes overwrites (does not OR) the other bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "flag_bits.cuh"

namespace {

constexpr int kThreads = 256;

// ``words`` is the 4-byte-aligned window; every offset below ``w`` has its
// 36 bytes (and the word that ends them) inside the padded buffer.
__global__ void prefilter_kernel(const uint32_t* __restrict__ words, int w,
                                 const int32_t* __restrict__ lengths,
                                 int cmax, int num_contigs, int n,
                                 int32_t* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= w) return;
  const uint32_t* q = words + (i >> 2);
  uint32_t v[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) v[k] = __ldg(q + k);
  const sbt::FixedBlock b = sbt::fixed_block(v, 8u * (uint32_t)(i & 3));
  int32_t f = sbt::fixed_bits(b, lengths, cmax, num_contigs);
  if (i > n - 36) f = sbt::kTooFewFixedBlockBytes;
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
