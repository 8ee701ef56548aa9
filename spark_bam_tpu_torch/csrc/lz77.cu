// LZ77 copy phase: resolve every output byte of a 64 KiB token row to the
// literal at the root of its back-reference chain.
//
// Replaces the Pallas kernel spark_bam_tpu/tpu/pallas_kernels.py::
// lz77_resolve_pallas (_lz77_kernel), which is the same function as the
// traced spark_bam_tpu/tpu/inflate.py::_resolve_body. The plain version is
// spark_bam_tpu_torch/tpu/kernels.py::_resolve_body.
//
// What bounds it on the H100: bytes, ~4 B of device traffic per output
// byte (lit 1 + dist 2 in, 1 out); the pointer jumping itself stays on
// chip. Design: one CTA of 1024 threads per row. Parents fit in uint16
// (0..65535), so a row's parent array is 128 KiB of dynamic shared memory
// (the TPU's int32 row, 256 KiB, would not fit in the 227 KB a block may
// use). Pointer jumping runs in place in shared memory with
// __syncthreads_or as the convergence test, then each thread gathers the
// literal at its positions' roots.
//
// In-place jumping reads pointers that are at least as far along their
// chains as the reference's synchronous doubling would hold, so it reaches
// the same roots (the bytes are identical) in at most as many rounds:
// rounds <= the plain version's rounds <= 16. ``rounds`` is telemetry.
//
// The output may alias ``lit``: a position's output is the literal at its
// root, only roots are read, and a root (dist 0) writes back its own byte.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStride = 65536;
constexpr int kThreads = 1024;
constexpr int kMaxRounds = 16;  // log2(64 Ki): any chain in a row collapses

__global__ void __launch_bounds__(kThreads)
lz77_kernel(const uint8_t* lit, const uint16_t* __restrict__ dist,
            uint8_t* out, int32_t* __restrict__ rounds_out) {
  extern __shared__ uint16_t parent[];
  const size_t row = (size_t)blockIdx.x * kStride;
  for (int i = threadIdx.x; i < kStride; i += kThreads)
    parent[i] = (uint16_t)(i - dist[row + i]);
  __syncthreads();
  int rounds = 0;
  while (rounds < kMaxRounds) {
    int changed = 0;
    for (int i = threadIdx.x; i < kStride; i += kThreads) {
      uint16_t p = parent[i];
      uint16_t pp = parent[p];
      if (pp != p) {
        parent[i] = pp;
        changed = 1;
      }
    }
    ++rounds;
    if (!__syncthreads_or(changed)) break;
  }
  for (int i = threadIdx.x; i < kStride; i += kThreads)
    out[row + i] = lit[row + parent[i]];
  if (threadIdx.x == 0) atomicMax(rounds_out, rounds);
}

}  // namespace

extern "C" int sbt_lz77_resolve(const uint8_t* lit, const uint16_t* dist,
                                int b, uint8_t* out, int32_t* rounds,
                                cudaStream_t stream) {
  const int smem = kStride * (int)sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      lz77_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  if (b > 0) lz77_kernel<<<b, kThreads, smem, stream>>>(lit, dist, out, rounds);
  return (int)cudaGetLastError();
}
