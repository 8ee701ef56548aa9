// Stage-0 funnel and survivor compaction, one launch: the fixed-36-byte-
// block subset of the 19 flag bits at every byte offset of a window, and
// the offsets where it is 0 (the survivors), in increasing order.
//
// Replaces the Pallas kernel spark_bam_tpu/tpu/pallas_kernels.py::
// prefilter_check_flags (_prefilter_flags_kernel) and the XLA compaction
// behind it, spark_bam_tpu/tpu/checker.py::_compact_mask. The plain
// version is spark_bam_tpu_torch/tpu/kernels.py::_prefilter_compact.
//
// What bounds it on the H100: issue slots. It must read the W + 35 window
// bytes and the contig table and write one int32 flag word per offset,
// the capacity-long survivor list and the count: at the main path's
// W = 2^25, capacity 2^20, that is ~172 MB, ~0.051 ms at 3.35 TB/s. The
// checks compile to ~69 instructions an offset (eight funnel shifts, the
// contig compares and their predicated length loads, the wrapped implied
// size, the selects that place each bit), ~0.069 ms of issue across the
// card at W = 2^25 if every slot were used.
//
// Design. One wave of persistent CTAs, in two phases; in each, a CTA takes
// tiles of 16 KiB offsets by an atomic ticket, in increasing order, until
// the tickets pass the last tile.
// Phase 1, with no wait but for a tile's own bytes:
// 1. One bulk async copy on an mbarrier brings a tile's bytes and the
//    36-byte tail of its last offset (16,432 bytes) into shared memory;
//    the next tile's copy is issued as soon as the flags have read them.
// 2. Each thread takes 4 consecutive offsets at a time: their fixed blocks
//    lie in the same nine shared-memory words (not 36 global loads), each
//    little-endian field is one funnel shift (flag_bits.cuh, shared with
//    the full pass), and one 16-byte store writes their flags. A contig
//    length is loaded (__ldg) only for an index inside the table. The
//    warp's four ballots of "F == 0" are the bitmap of its 128 offsets;
//    the tile's bitmap (2 KiB) goes to a scratch buffer in device memory
//    and the tile publishes its survivor count.
// Phase 2, by a second ticket, in tile order:
// 3. A block scan of the bitmap's popcounts ranks each thread's 64
//    offsets inside the tile, and a decoupled look-back gives the tile its
//    global base: one warp reads 128 predecessors' records at once and
//    sums their counts back to the nearest inclusive prefix, then the
//    tile publishes its own. Phase 1 never waits on another tile, so every
//    count comes out, and a tile's look-back waits only for counts still
//    in flight (asleep between reads). Resolving each tile inside its own
//    step instead, the first design, spent ~44 % of a tile's time waiting
//    there (PERF.md). Each record word holds the launch's epoch beside its
//    value, so the records, kept per stream between launches
//    (kernels.TileStatus), need no clearing.
// 4. Each thread expands its survivors into cand[base + rank] for
//    rank < capacity (the wrapper fills cand with -1 first); the CTA that
//    ranks the last tile writes the exact survivor count, which may exceed
//    the capacity. So cand and n_set are checker._compact_mask's on the
//    mask F == 0 && i < n (F == 0 already implies i <= n - 36).
//
// Trouble spots, each as in the reference (the checks live in
// flag_bits.cuh): the implied record size wraps like a JVM int32 (computed
// in uint32, then cast), seq_len + 1 divides with truncation toward zero,
// the contig bound is a strict '>', and tooFewFixedBlockBytes overwrites
// (does not OR) the other bits.

#include <cstdint>
#include <cuda_runtime.h>

#include "flag_bits.cuh"

namespace {

constexpr int kTile = 16384;                 // offsets per CTA
constexpr int kRegion = kTile + 48;          // bytes held: the tile's blocks
constexpr int kRegionWords = kRegion / 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = kTile / 4 / kThreads;  // 4-offset groups a thread
constexpr int kBitWords = kTile / 32;        // survivor bitmap words
constexpr int kRecord = 4;                   // int32 per tile status record
constexpr int kLook = 4;                     // records a lane reads at once
constexpr unsigned kSleepNs = 200;           // between reads of a record
constexpr unsigned kAll = 0xFFFFFFFFu;

static_assert(kRegion % 16 == 0 && kRegion >= kTile + 39, "bulk copy size");
static_assert(kBitWords == 2 * kThreads, "a thread ranks 64 offsets");

// profile launches: prefilter
// profile phases: load, flags; look-back, expansion
#ifdef SBT_PROFILE
// Profiling build only (benchmarks/profile_prefilter.py): CUDA events
// around the launch, and per-tile clock64 marks at the edges of its steps
// in the two phases (each on one SM: marks 0-2 in phase 1, 3-5 in 2).
__device__ long long g_pf_marks[6 * 8192];
cudaEvent_t g_pf_events[2];
#define SBT_MARK(k)                                                    \
  do {                                                                 \
    __syncthreads();                                                   \
    if (t == 0 && tile < 8192) g_pf_marks[6 * tile + (k)] = clock64(); \
  } while (0)
#define SBT_EVENT(k, stream)                                           \
  do {                                                                 \
    if (!g_pf_events[k]) cudaEventCreate(&g_pf_events[k]);             \
    cudaEventRecord(g_pf_events[k], stream);                           \
  } while (0)
#else
#define SBT_MARK(k)
#define SBT_EVENT(k, stream)
#endif

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v)
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

// The prefilter bits at offset ``i``, whose fixed block starts R bytes
// into the word ``v[0]``.
template <int R>
__device__ __forceinline__ int32_t flags_at(
    const uint32_t v[9], int i, const int32_t* __restrict__ lengths,
    int cmax, int num_contigs, int n) {
  const sbt::FixedBlock b = sbt::fixed_block(v, 8u * R);
  const int32_t f = sbt::fixed_bits(b, lengths, cmax, num_contigs);
  return i > n - 36 ? sbt::kTooFewFixedBlockBytes : f;
}

// A status record word: the launch's epoch above a 32-bit value.
__device__ __forceinline__ unsigned long long tagged(uint32_t epoch,
                                                     uint32_t value) {
  return ((unsigned long long)epoch << 32) | value;
}

// A tile's status record: its survivor count (aggregate) and then its
// inclusive prefix, each in one 64-bit word beside the launch's epoch.
__device__ __forceinline__ unsigned long long* record(int32_t* status,
                                                      int tile) {
  return reinterpret_cast<unsigned long long*>(status + kRecord * (1 + tile));
}

// Survivors in the tiles before ``tile`` (warp 0, all lanes): each lane
// reads the records of kLook consecutive predecessors at a time, nearest
// first (their prefix words in one batch, then the counts of those that
// have none), and the warp sums back to the nearest inclusive prefix: 128
// predecessors a round. Tiles before the first count as an inclusive
// prefix of 0.
__device__ uint32_t look_back(int32_t* status, int tile, uint32_t epoch,
                              int lane) {
  uint32_t excl = 0;
  for (int j = tile - 1;; j -= 32 * kLook) {
    const int k0 = j - kLook * lane;
    unsigned long long x[kLook];
#pragma unroll
    for (int r = 0; r < kLook; ++r)
      x[r] = k0 - r < 0 ? tagged(epoch, 0)
                        : load_relaxed(record(status, k0 - r) + 1);
    uint32_t prefix = 0;
#pragma unroll
    for (int r = 0; r < kLook; ++r)
      if ((uint32_t)(x[r] >> 32) == epoch) prefix |= 1u << r;
#pragma unroll
    for (int r = 0; r < kLook; ++r)
      if (!(prefix >> r & 1u)) x[r] = load_relaxed(record(status, k0 - r));
#pragma unroll
    for (int r = 0; r < kLook; ++r) {
      // Not out yet (its tile is still in phase 1): wait for either word,
      // asleep between reads so the SM's other CTAs keep its issue slots.
      while (!(prefix >> r & 1u) && (uint32_t)(x[r] >> 32) != epoch) {
        __nanosleep(kSleepNs);
        x[r] = load_relaxed(record(status, k0 - r) + 1);
        if ((uint32_t)(x[r] >> 32) == epoch) {
          prefix |= 1u << r;
        } else {
          x[r] = load_relaxed(record(status, k0 - r));
        }
      }
    }
    // This lane's part: its records up to and including its first prefix.
    uint32_t part = 0;
    bool has_prefix = false;
#pragma unroll
    for (int r = 0; r < kLook; ++r) {
      if (!has_prefix) {
        part += (uint32_t)x[r];
        has_prefix = prefix >> r & 1u;
      }
    }
    const uint32_t pmask = __ballot_sync(kAll, has_prefix);
    const int stop = pmask ? __ffs(pmask) - 1 : 31;
    excl += __reduce_add_sync(kAll, lane <= stop ? part : 0u);
    if (pmask) return excl;
  }
}

// Thread 0: the next flags ticket, and the bulk copy of its tile's bytes
// and tail (inside the buffer, which holds PAD bytes past the w offsets).
__device__ __forceinline__ int next_tile(int32_t* status, uint32_t ticket_base,
                                         int tiles, const uint8_t* padded,
                                         uint32_t* region, uint32_t bar) {
  const uint32_t ticket = atomicAdd(reinterpret_cast<uint32_t*>(status), 1u);
  const int tile = (int)(ticket - ticket_base);
  if (tile < tiles) {
    // The CTA's reads of the last tile (generic proxy) come before the
    // copy's writes (async proxy).
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(kRegion)
        : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(region)),
        "l"(padded + (size_t)tile * kTile), "r"(kRegion), "r"(bar)
        : "memory");
  }
  return tile;
}

// A tile's bitmap holds, per 128 offsets, the four ballots of one warp
// step: bit L of ballot r is offset 4L + r. Thread t owns lanes
// 16(t & 1) .. 16(t & 1) + 15 of group t / 2: offsets 64t .. 64t + 63.
__device__ __forceinline__ int owned_count(uint4 g, int t) {
  const uint32_t m = 0xFFFFu << (16 * (t & 1));
  return __popc(g.x & m) + __popc(g.y & m) + __popc(g.z & m) +
         __popc(g.w & m);
}

// The survivors before each thread's offsets in its tile, and the tile's
// count (all threads; one barrier inside).
__device__ __forceinline__ int2 tile_ranks(int mine, int* warp_sum, int lane,
                                           int warp) {
  int incl = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(kAll, incl, d);
    if (lane >= d) incl += o;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  int before = 0, count = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    before += k < warp ? warp_sum[k] : 0;
    count += warp_sum[k];
  }
  return make_int2(before + incl - mine, count);
}

__global__ void __launch_bounds__(kThreads)
prefilter_kernel(const uint8_t* __restrict__ padded, int w,
                 const int32_t* __restrict__ lengths, int cmax,
                 int num_contigs, int n_val,
                 const int32_t* __restrict__ n_ptr, int32_t* status,
                 uint32_t ticket_base, uint32_t epoch, int tiles,
                 int32_t* __restrict__ out, uint4* __restrict__ bitmaps,
                 int32_t* __restrict__ cand, int capacity,
                 int32_t* __restrict__ n_set) {
  __shared__ __align__(128) uint32_t region[kRegionWords];
  __shared__ __align__(16) uint32_t bits[kBitWords];
  __shared__ int warp_sum[kWarps];
  __shared__ int tile_s;
  __shared__ uint32_t base_s;
  __shared__ __align__(8) uint64_t bar_s;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n = n_ptr ? __ldg(n_ptr) : n_val;
  const uint32_t bar = smem_addr(&bar_s);
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    tile_s = next_tile(status, ticket_base, tiles, padded, region, bar);
  }
  __syncthreads();

  // Phase 1: flags, bitmaps and counts, tile after tile, with no wait
  // but for the tile's own bytes.
  int tile = tile_s;
  uint32_t parity = 0;
  while (tile < tiles) {
    const int base = tile * kTile;
    SBT_MARK(0);
    mbar_wait(bar, parity);
    parity ^= 1u;
    SBT_MARK(1);

    // Four consecutive offsets a thread a step, one 16-byte store; the
    // warp's four ballots are the bitmap of its 128 offsets.
#pragma unroll 2
    for (int s = 0; s < kSteps; ++s) {
      const int g = s * kThreads + t;
      const int i = base + 4 * g;
      uint32_t v[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) v[k] = region[g + k];
      const int32_t f0 = flags_at<0>(v, i, lengths, cmax, num_contigs, n);
      const int32_t f1 = flags_at<1>(v, i + 1, lengths, cmax, num_contigs, n);
      const int32_t f2 = flags_at<2>(v, i + 2, lengths, cmax, num_contigs, n);
      const int32_t f3 = flags_at<3>(v, i + 3, lengths, cmax, num_contigs, n);
      if (i + 3 < w) {
        *reinterpret_cast<int4*>(out + i) = make_int4(f0, f1, f2, f3);
      } else {
        if (i < w) out[i] = f0;
        if (i + 1 < w) out[i + 1] = f1;
        if (i + 2 < w) out[i + 2] = f2;
      }
      const uint32_t b0 = __ballot_sync(kAll, f0 == 0 && i < w);
      const uint32_t b1 = __ballot_sync(kAll, f1 == 0 && i + 1 < w);
      const uint32_t b2 = __ballot_sync(kAll, f2 == 0 && i + 2 < w);
      const uint32_t b3 = __ballot_sync(kAll, f3 == 0 && i + 3 < w);
      if (lane == 0)
        reinterpret_cast<uint4*>(bits)[s * kWarps + warp] =
            make_uint4(b0, b1, b2, b3);
    }
    __syncthreads();
    // The region is free: the next tile's bytes come in from here on.
    if (t == 0) tile_s = next_tile(status, ticket_base, tiles, padded,
                                   region, bar);
    const uint4 group = reinterpret_cast<const uint4*>(bits)[t >> 1];
    if (t < kThreads / 2)
      bitmaps[(size_t)tile * (kThreads / 2) + t] =
          reinterpret_cast<const uint4*>(bits)[t];
    const int count = tile_ranks(owned_count(group, t), warp_sum, lane,
                                 warp).y;
    // The count, after the bitmap (the barrier in tile_ranks orders the
    // CTA's stores before this release). Tile 0's count is its inclusive
    // prefix.
    if (t == 0) store_release(record(status, tile) + (tile == 0),
                              tagged(epoch, (uint32_t)count));
    const int next = tile_s;
    SBT_MARK(2);
    tile = next;
    __syncthreads();   // bits, warp_sum and tile_s are reused next
  }

  // Phase 2: bases and expansion, tile after tile in increasing order
  // by a second ticket; each waits only for counts still in flight.
  for (;;) {
    if (t == 0) {
      const uint32_t ticket =
          atomicAdd(reinterpret_cast<uint32_t*>(status) + 1, 1u);
      tile_s = (int)(ticket - ticket_base);
    }
    __syncthreads();
    tile = tile_s;
    if (tile >= tiles) break;
    SBT_MARK(3);
    // The tile's own count is out once its bitmap is (it may still be in
    // phase 1 on another SM).
    if (t == 0) {
      const unsigned long long* own = record(status, tile) + (tile == 0);
      while ((uint32_t)(load_acquire(own) >> 32) != epoch)
        __nanosleep(kSleepNs);
    }
    __syncthreads();
    const uint4 group =
        __ldcg(bitmaps + (size_t)tile * (kThreads / 2) + (t >> 1));
    const int2 rc = tile_ranks(owned_count(group, t), warp_sum, lane, warp);
    if (warp == 0) {
      const uint32_t excl = look_back(status, tile, epoch, lane);
      if (lane == 0) {
        store_relaxed(record(status, tile) + 1,
                      tagged(epoch, excl + (uint32_t)rc.y));
        base_s = excl;
        if (tile == tiles - 1) *n_set = (int32_t)(excl + (uint32_t)rc.y);
      }
    }
    __syncthreads();
    SBT_MARK(4);
    // Position order (lane, then ballot), up to the capacity.
    long long rank = (long long)base_s + rc.x;
    const int sh = 16 * (t & 1);
    uint32_t lanes = ((group.x | group.y | group.z | group.w) >> sh) & 0xFFFFu;
    const int at0 = tile * kTile + 64 * t;
    while (lanes && rank < capacity) {
      const int l = __ffs(lanes) - 1;
      lanes &= lanes - 1;
      const uint32_t b = (group.x >> (sh + l) & 1u) |
                         (group.y >> (sh + l) & 1u) << 1 |
                         (group.z >> (sh + l) & 1u) << 2 |
                         (group.w >> (sh + l) & 1u) << 3;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if ((b >> r & 1u) && rank < capacity) cand[rank++] = at0 + 4 * l + r;
    }
    SBT_MARK(5);
  }
}

}  // namespace

// ``padded`` holds ``w`` offsets then the PAD (263,168) bytes past them,
// starting on a 16-byte boundary, fewer than 2^31 bytes in all; ``out``
// holds ``w`` int32 and starts on a 16-byte boundary; ``bitmaps`` holds
// 512 uint32 per tile (scratch; 16-byte aligned); ``cand`` holds
// ``capacity`` int32, all -1; ``n_set`` one int32. The valid byte count
// is ``n`` or, when ``n_ptr`` is not null, the int32 it points to in
// device memory (a launch captured in a CUDA graph then reads each
// replay's value). ``status`` holds
// 4 * (1 + ceil(w / 16384)) int32: the two ticket counters, then one
// record per tile. It belongs to one stream; this launch's tickets (of
// both counters) start at ``ticket_base`` and its records carry ``epoch``
// (non-zero), larger than any epoch already there. ``grid`` CTAs run (at
// most sbt_prefilter_ctas()); in each phase each takes tiles until its
// ticket passes the last, so the launch takes ceil(w / 16384) + grid
// tickets of each counter.
extern "C" int sbt_prefilter(const uint8_t* padded, int w,
                             const int32_t* lengths, int cmax,
                             int num_contigs, int n, const int32_t* n_ptr,
                             int32_t* status,
                             unsigned ticket_base, unsigned epoch,
                             int32_t* out, uint32_t* bitmaps, int32_t* cand,
                             int capacity, int32_t* n_set, int grid,
                             cudaStream_t stream) {
  if (w <= 0 || grid <= 0) return (int)cudaGetLastError();
  const int tiles = (w + kTile - 1) / kTile;
  SBT_EVENT(0, stream);
  prefilter_kernel<<<grid, kThreads, 0, stream>>>(
      padded, w, lengths, cmax, num_contigs, n, n_ptr, status, ticket_base,
      epoch, tiles, out, reinterpret_cast<uint4*>(bitmaps), cand, capacity,
      n_set);
  SBT_EVENT(1, stream);
  return (int)cudaGetLastError();
}

// The CTAs that run at once on the current device: one wave of the
// persistent grid.
extern "C" int sbt_prefilter_ctas() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, prefilter_kernel,
                                                kThreads, 0);
  return sms * per_sm;
}

#ifdef SBT_PROFILE
// Milliseconds of the last call's launch, and the tiles' marks.
extern "C" int sbt_prefilter_profile(float* ms, long long* marks, int tiles) {
  cudaError_t err = cudaEventSynchronize(g_pf_events[1]);
  if (err == cudaSuccess)
    err = cudaEventElapsedTime(&ms[0], g_pf_events[0], g_pf_events[1]);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(marks, g_pf_marks,
                                   6 * tiles * sizeof(long long));
}
#endif
