// LZ77 copy phase: resolve every output byte of a 64 KiB token row to the
// literal at the root of its back-reference chain.
//
// Replaces the Pallas kernel spark_bam_tpu/tpu/pallas_kernels.py::
// lz77_resolve_pallas (_lz77_kernel), which is the same function as the
// traced spark_bam_tpu/tpu/inflate.py::_resolve_body. The plain version is
// spark_bam_tpu_torch/tpu/kernels.py::_resolve_body.
//
// What bounds it on the H100: bytes, 4 B of device traffic per output byte
// (lit 1 + dist 2 in, 1 out); the pointer jumping itself stays on chip.
//
// Design: one CTA of 1024 threads per row, the whole row in shared memory.
// 1. One thread starts two bulk async copies (TMA, cp.async.bulk on an
//    mbarrier) of the row's 128 KiB of distances and 64 KiB of literals,
//    so the SM has the whole row in flight at once.
// 2. Distances become uint16 parents in place (parent = i - dist; the
//    TPU's int32 row, 256 KiB, would not fit in the 227 KB a block may
//    use).
// 3. Pointer jumping in place, chunk by chunk in increasing position
//    order, 4,096 positions (four a thread) at a time. Every position
//    before a chunk already points at a root, so a parent there settles
//    in one jump; the chunk runs more rounds only while some position's
//    new parent is not yet a root (a chain inside the chunk), a
//    __syncthreads_or. On real windows a chunk still takes 4-5 rounds
//    (matches of recent matches chain inside it): about four sweeps of
//    the row in all, against one sweep per doubling round (six there)
//    when the whole row jumps at once. (An active-position bitmap skipped
//    little: ~40 % of a real row's positions are matches, spread over
//    nearly every word; PERF.md.)
// 4. Each warp gathers its 2,048 output bytes from the literals in shared
//    memory, 4 consecutive bytes a lane (a literal run then reads 32
//    different banks), stages them in its own slice of the parent array
//    (which no other warp reads any more), and stores 16 B a lane.
//
// Every position ends at the root of its chain, so the bytes are the
// plain version's. A chunk's rounds jump chains no deeper than the row's,
// in place (each pointer read is at least as far along as synchronous
// doubling would hold), and stop as soon as no new parent is a non-root,
// where the plain version also counts the round that finds nothing to
// change: so the most rounds any chunk took <= the plain version's rounds
// <= 16. ``rounds`` is telemetry: the largest such count of the batch.
//
// The output may alias ``lit``: the whole literal row is in shared memory
// before anything is stored.

#include <cstdint>
#include <cuda_runtime.h>

#include "per_device.cuh"

namespace {

constexpr int kStride = 65536;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRounds = 16;  // log2(64 Ki): any chain in a row collapses
constexpr int kDistBytes = kStride * 2;
constexpr int kSmem = kDistBytes + kStride;
constexpr int kChunk = kStride / kWarps;    // output bytes per warp
constexpr int kIlp = 4;                     // positions a thread jumps at once
constexpr int kSweep = kThreads * kIlp;     // positions settled per chunk

static_assert(kChunk == 2048, "a warp's gather covers 16 words a lane");
static_assert(kStride % kSweep == 0, "whole chunks");
static_assert(kSmem + 8 <= 232448, "a block's shared memory");

// profile phases: load, parents, jumping, gather/store
#ifdef SBT_PROFILE
// Profiling build only (benchmarks/profile_resolve_flags.py): per-row
// clock64 marks at the phases' edges, and rounds.
__device__ long long g_lz77_marks[5 * 4096];
__device__ int g_lz77_rounds[4096];
#define SBT_MARK(k)                                                   \
  do {                                                                \
    __syncthreads();                                                  \
    if (threadIdx.x == 0 && blockIdx.x < 4096)                        \
      g_lz77_marks[5 * blockIdx.x + (k)] = clock64();                 \
  } while (0)
#else
#define SBT_MARK(k)
#endif

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A bulk async copy global → shared that completes ``bytes`` on ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Two parents (positions i, i + 1) from two distances in one word.
__device__ __forceinline__ uint32_t parent_pair(uint32_t i, uint32_t d) {
  return ((i - (d & 0xFFFFu)) & 0xFFFFu) | (i + 1 - (d >> 16)) << 16;
}

__global__ void __launch_bounds__(kThreads)
lz77_kernel(const uint8_t* lit, const uint16_t* dist, uint8_t* out,
            int32_t* __restrict__ rounds_out) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t bar_s;
  uint16_t* parent = reinterpret_cast<uint16_t*>(smem);
  uint8_t* lit_s = smem + kDistBytes;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t row = (size_t)blockIdx.x * kStride;
  const uint32_t bar = smem_addr(&bar_s);
  SBT_MARK(0);

  // 1. Stage the row.
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(kDistBytes + kStride)
        : "memory");
    bulk_load(parent, dist + row, kDistBytes, bar);
    bulk_load(lit_s, lit + row, kStride, bar);
  }
  __syncthreads();  // the barrier is initialised before anyone waits on it
  mbar_wait(bar, 0);
  SBT_MARK(1);

  // 2. Parents in place, eight positions a thread at a time.
  for (int v = t; v < kStride / 8; v += kThreads) {
    uint4 d = reinterpret_cast<const uint4*>(parent)[v];
    const uint32_t i = 8 * v;
    d.x = parent_pair(i, d.x);
    d.y = parent_pair(i + 2, d.y);
    d.z = parent_pair(i + 4, d.z);
    d.w = parent_pair(i + 6, d.w);
    reinterpret_cast<uint4*>(parent)[v] = d;
  }
  __syncthreads();
  SBT_MARK(2);

  // 3. Jump chunk by chunk in increasing position order: every position
  // before the chunk already points at a root, so one jump settles a
  // parent there, and rounds continue only while some position's new
  // parent is not a root (a chain inside the chunk).
  int rounds = 0;
  for (int lo = 0; lo < kStride; lo += kSweep) {
    int r = 0;
    bool more;
    do {
      uint16_t p[kIlp], pp[kIlp];
#pragma unroll
      for (int j = 0; j < kIlp; ++j) p[j] = parent[lo + t + kThreads * j];
#pragma unroll
      for (int j = 0; j < kIlp; ++j) pp[j] = parent[p[j]];
      bool need = false;
#pragma unroll
      for (int j = 0; j < kIlp; ++j) {
        if (pp[j] != p[j]) {
          parent[lo + t + kThreads * j] = pp[j];
          need |= parent[pp[j]] != pp[j];
        }
      }
      ++r;
      more = __syncthreads_or(need);
    } while (more && r < kMaxRounds);
    rounds = max(rounds, r);
  }
  SBT_MARK(3);

  // 4. Gather, stage in this warp's own parent slice, store 16 B a lane.
  const int c0 = warp * kChunk;
  uint32_t word[kChunk / 128];
#pragma unroll
  for (int m = 0; m < kChunk / 128; ++m) {
    const int q = c0 + 4 * (lane + 32 * m);
    const uint2 pq = *reinterpret_cast<const uint2*>(parent + q);
    word[m] = (uint32_t)lit_s[pq.x & 0xFFFFu] |
              (uint32_t)lit_s[pq.x >> 16] << 8 |
              (uint32_t)lit_s[pq.y & 0xFFFFu] << 16 |
              (uint32_t)lit_s[pq.y >> 16] << 24;
  }
  __syncwarp();
  uint32_t* stage = reinterpret_cast<uint32_t*>(parent + c0);
#pragma unroll
  for (int m = 0; m < kChunk / 128; ++m) stage[lane + 32 * m] = word[m];
  __syncwarp();
  const uint4* s4 = reinterpret_cast<const uint4*>(stage);
  uint4* o4 = reinterpret_cast<uint4*>(out + row + c0);
#pragma unroll
  for (int m = 0; m < kChunk / 512; ++m) o4[lane + 32 * m] = s4[lane + 32 * m];
  if (t == 0) atomicMax(rounds_out, rounds);
  SBT_MARK(4);
#ifdef SBT_PROFILE
  if (t == 0 && blockIdx.x < 4096) g_lz77_rounds[blockIdx.x] = rounds;
#endif
}

}  // namespace

// ``lit``, ``dist`` and ``out`` start on 16-byte boundaries (the wrapper
// checks); ``out`` may be ``lit``.
extern "C" int sbt_lz77_resolve(const uint8_t* lit, const uint16_t* dist,
                                int b, uint8_t* out, int32_t* rounds,
                                cudaStream_t stream) {
  static std::once_flag once[sbt::kMaxDevices];
  static cudaError_t set[sbt::kMaxDevices];
  const cudaError_t attr = sbt::once_per_device(once, set, [] {
    return cudaFuncSetAttribute(
        lz77_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  });
  if (attr != cudaSuccess) return (int)attr;
  if (b > 0) lz77_kernel<<<b, kThreads, kSmem, stream>>>(lit, dist, out, rounds);
  return (int)cudaGetLastError();
}

#ifdef SBT_PROFILE
extern "C" int sbt_lz77_profile(long long* marks, int* rounds, int rows) {
  cudaError_t err = cudaMemcpyFromSymbol(marks, g_lz77_marks,
                                         5 * rows * sizeof(long long));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(rounds, g_lz77_rounds, rows * sizeof(int));
}
#endif
